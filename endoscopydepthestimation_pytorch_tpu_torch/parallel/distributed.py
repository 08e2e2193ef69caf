"""Data parallelism across processes: one process per card, on any number
of hosts, with one global batch (the multi-process part of the JAX
package's ``parallel/mesh.py``: ``make_mesh_for_batch`` :38-57,
``multihost_barrier`` :116-141, ``replicate_state`` :144-155,
``make_shardmap_train_step`` :180-256, ``make_parallel_eval_step``
:259-269).

Each rank holds a full copy of the model and the optimizer state and
takes its contiguous ``batch_size / world`` rows of every global batch
(``data.dataset.BatchLoader``'s ``process_index``/``process_count``). The
collectives sit between the kernel launches, in PyTorch, where the JAX
package puts its ``pmean``/``psum`` between ``pallas_call``s. The
convention they follow:

1. Seed and averaging. Each rank differentiates its own loss (the mean
   over its local rows) with seed 1. After the backward, the parameter
   gradients are averaged once over the ranks, in one flat all-reduce
   (``average_gradients``: SUM, then / world). The result is the gradient
   of the mean of the ranks' losses, which is the global batch's loss
   (JAX's pmean'd loss, mesh.py:218-229).
2. Statistics. Every train-mode BatchNorm statistic (mean and mean of
   squares) comes from the block engine (``ops.block_engine``), which
   averages it over the ranks in the forward, so BN normalizes with the
   global batch's statistics and the running statistics advance
   identically on every rank. In the backward, a statistic's cotangent is
   summed over the ranks and divided by the global pixel count.
3. Parameter gradients inside the engine stay each rank's own
   contribution: dgamma and dbeta come from the local sums
   (sum dpre*x, sum dpre), dW from the local K6, the bias from the local
   K5. The all-reduced copies of those sums feed only the (C1, C2)
   BN-through-statistics updates. (JAX psums the parameter cotangents
   inside ``_engine_bwd``, :1263-1301, because its outer pmean is an
   identity there; here the average after the backward does that job,
   and a sum inside as well would make every BN gradient world times too
   large.)
4. Agreement on the update. The loss and the four scalars are averaged
   before ``training.apply_gradients`` (JAX mesh.py:237), so every rank
   takes the same ``isfinite`` branch: no rank updates while another's
   loss is NaN.
5. World size 1. ``group()`` is None, every function here returns
   without a collective, and the step launches exactly what it launches
   without a process group.

Why not ``DistributedDataParallel``: the train step takes its gradients
with ``torch.autograd.grad`` and applies them with a functional optimizer
(``training.apply_gradients``), as JAX's ``value_and_grad`` and optax do.
DDP's reducer fires only from ``.backward()`` into ``.grad``, broadcasts
buffers, and would interleave its bucket all-reduces with the in-model
statistic all-reduces on one communicator. One explicit flat all-reduce
after ``autograd.grad`` is JAX's ``pmean(grads)``.

The backend follows the device: NCCL on a CUDA device, gloo on the CPU.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

# JAX's multihost_barrier waits up to 600 s: a rank's first step (kernel
# builds, the precompute) can lag another's by minutes
TIMEOUT = datetime.timedelta(seconds=600)

# the run's process group at world size > 1, read by the model and the
# engine; None without a process group and at world size 1
_GROUP: Optional[dist.ProcessGroup] = None


def group() -> Optional[dist.ProcessGroup]:
    """The process group the collectives run on, or None (no collective)."""
    return _GROUP


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device, backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the run's process group as rank ``process_id`` of
    ``num_processes``, rendezvousing at ``tcp://<coordinator_address>``
    (host:port of rank 0). ``device`` is this rank's device; on a CUDA
    device it becomes the current one. The backend is NCCL on a CUDA
    device and gloo on the CPU; ``backend`` overrides that (gloo runs two
    ranks on one card, which NCCL refuses). A backend this torch lacks
    raises: there is no fallback."""
    global _GROUP
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available or not available[backend]():
        raise RuntimeError(f"the {backend} backend is not available in this "
                           f"torch build")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device  # binds the communicator to this card
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **kwargs)
    _GROUP = dist.group.WORLD if num_processes > 1 else None


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    global _GROUP
    _GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> int:
    """The number of ranks of the run's group; 1 without one."""
    return dist.get_world_size(_GROUP) if _GROUP is not None else 1


def rank() -> int:
    """This process's rank in the run's group; 0 without one."""
    return dist.get_rank(_GROUP) if _GROUP is not None else 0


def is_main() -> bool:
    """Rank 0: the one that prints, logs and writes checkpoints."""
    return rank() == 0


def check_batch_divides(batch_size: int, world_size: int) -> None:
    """Raise at start-up when the global batch does not split into equal
    rows per rank (JAX mesh.py:44-57, its multi-host branch)."""
    if batch_size % world_size:
        raise ValueError(f"the global batch_size {batch_size} must be divisible "
                         f"by the number of processes {world_size}")


def all_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if _GROUP is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_GROUP)
    return t


def all_mean_(t: torch.Tensor) -> torch.Tensor:
    """Average ``t`` over the ranks, in place; returns it."""
    if _GROUP is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_GROUP)
        t.div_(world())
    return t


def average_gradients(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients averaged over the ranks, by one all-reduce of them
    flattened into one tensor (convention 1)."""
    if _GROUP is None:
        return list(grads)
    flat = all_mean_(torch.cat([g.reshape(-1) for g in grads]))
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


@torch.no_grad()
def broadcast_state(state):
    """Rank 0's model (parameters and buffers), momentum, ``count`` and
    ``step`` onto every rank, one broadcast per dtype; run once after
    init or resume (JAX ``replicate_state``). Returns ``state``."""
    if _GROUP is None:
        return state
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *state.momentum, state.count, state.step]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=_GROUP)
        for t, f in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(f.view_as(t))
    return state


def barrier(name: str) -> None:
    """Wait until every rank reaches the barrier ``name``, up to the
    group's timeout (JAX ``multihost_barrier``)."""
    if _GROUP is None:
        return
    try:
        dist.barrier(group=_GROUP)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {rank()}: {e}") from e
