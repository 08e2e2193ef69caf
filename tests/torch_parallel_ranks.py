"""The rank side of the port's data-parallel tests
(tests/test_torch_parallel.py): ``run_ranks`` runs a function on every
rank of a gloo process group on the CPU, each rank in a process of its
own (``spawn``), and the functions below are what the ranks run. This
module imports torch and the port only, so each rank starts quickly.
"""
import datetime
import multiprocessing
import os
import socket
import time
from pathlib import Path

import torch

from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet
from endoscopydepthestimation_pytorch_tpu_torch.ops import block_engine
from endoscopydepthestimation_pytorch_tpu_torch.parallel import distributed

GROUP_TIMEOUT = datetime.timedelta(seconds=60)  # a lost rank fails its peers by then
DCL = 0.1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank: int, world: int, port: int, out: Path, args) -> None:
    """One rank: stderr into ``out/rank<r>.err``, join the group, run
    ``fn(rank, world, *args)`` and save its result to ``out/rank<r>.pt``.
    An exception leaves the group and ends the process with exit code 1
    and the traceback in the .err file."""
    with open(out / f"rank{rank}.err", "w") as err:
        os.dup2(err.fileno(), 2)
    torch.set_num_threads(1)
    distributed.init_distributed(f"127.0.0.1:{port}", world, rank, "cpu",
                                 timeout=GROUP_TIMEOUT)
    try:
        torch.save(fn(rank, world, *args), out / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, out: Path, *args, timeout: float = 120.0):
    """Run ``fn`` on ``world`` spawned ranks on a free port; wait for all of
    them up to ``timeout`` seconds in all. Returns (exit codes, stderr
    texts, results; None where a rank saved none). A rank still running
    at the timeout is killed, with every other, and raises TimeoutError."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errs = [(out / f"rank{r}.err").read_text() if (out / f"rank{r}.err").exists()
            else "" for r in range(world)]
    if hung:
        raise TimeoutError(f"ranks {hung} still ran after {timeout} s:\n" + "\n".join(errs))
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               if (out / f"rank{r}.pt").exists() else None for r in range(world)]
    return [p.exitcode for p in procs], errs, results


def rows(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's contiguous rows of a global batch."""
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def local_batch(batch: dict, rank: int, world: int) -> dict:
    return {k: rows(v, rank, world) for k, v in batch.items()}


# -- the objectives: each rank's, summing over the ranks to the global one ----


def engine_objective(buf, mu, m2, w_buf, w_mu, w_m2):
    """The objective of the JAX package's engine test under shard_map
    (tests/test_block_engine.py::test_engine_grad_parity_under_shardmap)
    over this process's rows."""
    return (buf * w_buf).sum() + (buf * (mu * w_mu + m2 * w_m2)).sum()


def _engine(rank, world, x, params, weights):
    leaves = [rows(x, rank, world).clone().requires_grad_()] + [
        p.clone().requires_grad_() for group in params for p in group]
    n_layers = len(params[0])
    groups = [leaves[1 + i * n_layers:1 + (i + 1) * n_layers] for i in range(4)]
    buf, mu, m2 = block_engine.block_engine_apply(leaves[0], *groups)
    w_buf, w_mu, w_m2 = weights
    loss = engine_objective(buf, mu, m2, rows(w_buf, rank, world), w_mu, w_m2)
    grads = torch.autograd.grad(loss, leaves)
    return {"buf": buf.detach(), "mu": mu.detach(), "m2": m2.detach(),
            "gx": grads[0], "gparams": list(grads[1:])}


def _step(model, batch, config=training.TrainConfig(), **kwargs):
    state = distributed.broadcast_state(training.create_train_state(model))
    state, metrics = training.train_step(state, batch, torch.tensor(DCL), config,
                                         **kwargs)
    return state, {k: v.detach() for k, v in metrics.items()}


def _state(state) -> dict:
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "momentum": [b.clone() for b in state.momentum],
            "count": int(state.count), "step": int(state.step)}


def session(rank, world, inputs):
    """Every check of the data-parallel test file that runs on ranks, in
    one process group: ``block_engine_apply``, a
    validation step with the batch statistics, one train step, the same
    step with ``remat`` and with ``act8`` (whose backward replays the
    blocks' forwards, and their collectives), ``grad_accum=2``, and a step
    after which one rank's batch is made non-finite."""
    out = {"engine": _engine(rank, world, *inputs["engine"])}

    arch, state_dict, batch = inputs["step"]
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    state = training.create_train_state(model)
    out["eval"] = training.eval_step(state, local_batch(batch, rank, world),
                                     torch.tensor(DCL), training.TrainConfig(),
                                     use_batch_stats=True)
    state, metrics = _step(model, local_batch(batch, rank, world))
    out["step"] = {"metrics": metrics, **_state(state)}
    for store in ("remat", "act8"):
        model = FCDenseNet(**arch, **{store: True})
        model.load_state_dict(state_dict)
        state, metrics = _step(model, local_batch(batch, rank, world))
        out[store] = {"metrics": metrics, **_state(state)}

    arch, state_dict, batch = inputs["grad_accum"]
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    state, metrics = _step(model, local_batch(batch, rank, world), grad_accum=2)
    out["grad_accum"] = {"metrics": metrics, **_state(state)}

    # one finite step (momentum non-zero), then rank 1's depth mask emptied
    bad = local_batch(batch, rank, world)
    if rank == 1:
        bad = dict(bad, depth_mask_1=torch.zeros_like(bad["depth_mask_1"]),
                   sparse_depth_1=torch.zeros_like(bad["sparse_depth_1"]))
    before = _state(state)
    state, metrics = training.train_step(state, bad, torch.tensor(DCL),
                                         training.TrainConfig())
    out["non_finite"] = {"before": before, "after": _state(state),
                         "metrics": {k: v.detach() for k, v in metrics.items()}}
    return out


def fail_mid_step(rank, world, arch, state_dict, batch):
    """A train step in which rank 1 raises between its forward and its
    backward, while rank 0 goes on into the backward's collectives."""
    model = FCDenseNet(**arch)
    model.load_state_dict(state_dict)
    if rank == 1:
        real = training.compute_losses

        def raising(*args, **kwargs):
            real(*args, **kwargs)
            raise RuntimeError("fault injected on rank 1 between the forward "
                               "and the backward")

        training.compute_losses = raising
    _step(model, local_batch(batch, rank, world))
    return {}
