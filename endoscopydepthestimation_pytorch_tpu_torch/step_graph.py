"""The train step captured once as a CUDA graph, then replayed.

``training.train_step`` hands every step here. A step whose signature
(below) was seen once before is captured as one CUDA graph, forward,
losses, ``autograd.grad`` and the optimizer's C call alike, and replayed
from then on: a FC-DenseNet-103 step's ~5,900 launches from Python become
one copy of the batch into the graph's inputs, one graph launch and one
clone of the metrics. The kernels are the eager step's, on the same
inputs, in the same order.

**When.** What the step can see decides, nothing else: a step runs
eagerly, as ever, on a device the capture backend does not take (the
CPU), with ``with_images``, with ``grad_accum`` > 1, or in a process
group, and so does a signature whose eager step's metrics are not all
float32 scalars (a float64 ``dcl_weight`` makes the loss float64). Every
other step is graphable.

**Signature.** The batch's keys, shapes, dtypes, strides and devices,
``dcl_weight``'s shape and dtype, the model's identity and compute dtype,
the ``TrainConfig`` (its values are baked into the graph) and the data
pointers of the parameters, the momentum buffers, the model's buffers,
``count`` and ``step``. ``dcl_weight``'s value is an input, copied in at
every replay. The first step of a signature runs eagerly (a real step,
and the warm-up); the second captures, then replays; every later one
replays. The graphs live on the ``TrainState`` (``TrainState.graphs``)
and go with it; a step whose state's data pointers moved drops them. What
the step's Python reads besides (a process-wide switch such as
``ops.act8.BWD_MODE``, the backends' TF32 flags) is baked in at the
capture: change it only with a new ``TrainState``.

**Streams and memory.** Eager steps and replays run on the caller's
stream. The capture runs on a stream of the device's own, which waits for
the caller's stream before it and which the caller's stream waits for
after it. cuBLAS keeps a workspace for each handle and stream: the
capture clears those before and after it (as torch's own graph trees
do), so the graph's workspaces are made inside its private pool during
the capture and stay with it, and none persists beside the caller's. So a
graph holds no allocated bytes but its static inputs and packed metrics;
where the card's free memory is less than the eager pool's cached blocks,
those are released before a capture. At most two replays are in flight:
after a replay the host waits for the one two before it, so it never
queues more than the next step.

**Counters.** The capture runs the step's Python, which moves the kernel
wrappers' ``LAUNCHES`` counters by one step's launches; they are put back,
and every replay adds those launches, so a counter reads what the device
runs. ``GRAPHED`` counts the steps run eagerly, the captures and the
replays (a capture's step is a replay too).

**Spans.** A graphed step is one phase span, ``replay`` (the input copy,
the graph launch and the clone), under the root ``train_step``; a capture
adds ``capture`` before it. A replay has no phase or kernel span inside.

``BACKEND`` is the capture seam: ``CudaGraphs`` on a card; a test puts a
stand-in there to replay the captured Python on the CPU.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .parallel import distributed
from .utils import profiling

GRAPHED = {"eager": 0, "captures": 0, "replays": 0}  # train steps in this process
IN_FLIGHT = 2  # replays enqueued and not yet done, at most


def _counter_refs() -> List[tuple]:
    """(owner, key) of every launch counter a train step moves: a counter
    dict and its key, or a module and its attribute."""
    from .models import depth_anything, depth_pro, vggt
    from .ops import block_engine, dense_conv, sgd_update, warp_sample
    refs = [(dense_conv, "LAUNCHES"), (sgd_update, "RESTRIDED")]
    for counts in (block_engine.LAUNCHES, warp_sample.LAUNCHES, sgd_update.LAUNCHES,
                   depth_anything.LAUNCHES, depth_pro.LAUNCHES, vggt.LAUNCHES):
        refs += [(counts, k) for k in counts]
    return refs


def counter_values() -> List[int]:
    return [o[k] if isinstance(o, dict) else getattr(o, k) for o, k in _counter_refs()]


def set_counters(values: List[int]) -> None:
    for (o, k), v in zip(_counter_refs(), values):
        if isinstance(o, dict):
            o[k] = v
        else:
            setattr(o, k, v)


class CudaGraphs:
    """The capture backend on a card: ``torch.cuda.CUDAGraph`` on the
    device's step stream."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._done: Dict[torch.device, collections.deque] = {}

    def engages(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def capture(self, fn: Callable[[], None], device: torch.device):
        """A graph of what ``fn`` enqueues on the current stream, captured
        on the device's capture stream. The capture runs ``fn``'s Python;
        its kernels run only at a replay."""
        free, _ = torch.cuda.mem_get_info(device)
        if free < torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device):
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        caller = torch.cuda.current_stream(device)
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        stream.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.stream(stream):
                # thread_local: a loader thread may allocate and copy meanwhile
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error above
                    raise
                graph.capture_end()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
            caller.wait_stream(stream)
        return graph

    def launched(self, device: torch.device) -> None:
        """After a replay: wait for the replay ``IN_FLIGHT`` before it."""
        done = self._done.setdefault(device, collections.deque())
        event = torch.cuda.Event()
        event.record()
        done.append(event)
        if len(done) > IN_FLIGHT:
            done.popleft().synchronize()


BACKEND = CudaGraphs()


class _Graph:
    """One captured step: its static inputs (the batch's, ``dcl_weight``),
    its packed metrics, the graph, and the launches its capture counted."""

    def __init__(self, batch: Dict[str, torch.Tensor], dcl_weight: torch.Tensor,
                 keys: Tuple[str, ...], device: torch.device):
        self.inputs = {k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                              device=v.device) for k, v in batch.items()}
        self.dcl = torch.empty_like(dcl_weight)
        self.keys = keys
        self.metrics = torch.empty(len(keys), dtype=torch.float32, device=device)
        self.graph = None
        self.deltas: List[int] = []
        self.fill(batch, dcl_weight)

    def fill(self, batch: Dict[str, torch.Tensor], dcl_weight: torch.Tensor) -> None:
        torch._foreach_copy_([*self.inputs.values(), self.dcl], [*batch.values(), dcl_weight])

    def replay(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        set_counters([v + d for v, d in zip(counter_values(), self.deltas)])
        GRAPHED["replays"] += 1
        return dict(zip(self.keys, self.metrics.clone().unbind()))


class StepGraphs:
    """A ``TrainState``'s graphs: the signatures run once eagerly (with
    their metrics' names) and a graph for each signature seen twice, all
    for one set of the state's data pointers."""

    def __init__(self, pointers: Optional[tuple] = None):
        self.pointers = pointers
        self.seen: Dict[tuple, Tuple[str, ...]] = {}
        self.graphs: Dict[tuple, _Graph] = {}

    def __deepcopy__(self, memo):
        return StepGraphs()  # a copied state's tensors lie elsewhere: start over


def _pointers(state) -> tuple:
    return (tuple(map(torch.Tensor.data_ptr, state.params)),
            tuple(map(torch.Tensor.data_ptr, state.momentum)),
            tuple(map(torch.Tensor.data_ptr, state.model.buffers())),
            state.count.data_ptr(), state.step.data_ptr())


def _signature(state, batch, dcl_weight, config) -> tuple:
    return (id(state.model), state.model.dtype, config,
            tuple((k, v.shape, v.dtype, v.stride(), v.device) for k, v in batch.items()),
            (dcl_weight.shape, dcl_weight.dtype, dcl_weight.device))


def _capture(state, batch, dcl_weight, config, keys, step_fn, backend) -> _Graph:
    device = state.count.device
    entry = _Graph(batch, dcl_weight, keys, device)

    def step():
        _, metrics = step_fn(state, entry.inputs, entry.dcl, config, False, 1)
        torch.stack([metrics[k] for k in keys], out=entry.metrics)

    before = counter_values()
    try:
        entry.graph = backend.capture(step, device)
        entry.deltas = [a - b for a, b in zip(counter_values(), before)]
    finally:
        set_counters(before)
    GRAPHED["captures"] += 1
    return entry


def run(state, batch: Dict[str, torch.Tensor], dcl_weight: torch.Tensor, config,
        with_images: bool, grad_accum: int, step_fn):
    """``step_fn(state, batch, dcl_weight, config, with_images,
    grad_accum)``, the eager train step, eagerly or as a replay of its
    graph; returns (state, metrics)."""
    backend = BACKEND
    device = state.count.device
    if (with_images or grad_accum != 1 or distributed.group() is not None
            or not backend.engages(device)):
        GRAPHED["eager"] += 1
        return step_fn(state, batch, dcl_weight, config, with_images, grad_accum)
    pointers = _pointers(state)
    if pointers != state.graphs.pointers:
        state.graphs = StepGraphs(pointers)
    graphs = state.graphs
    signature = _signature(state, batch, dcl_weight, config)
    entry = graphs.graphs.get(signature)
    if entry is None:
        keys = graphs.seen.get(signature)
        if keys == ():
            GRAPHED["eager"] += 1
            return step_fn(state, batch, dcl_weight, config, False, 1)
        if keys is None:
            GRAPHED["eager"] += 1
            state, metrics = step_fn(state, batch, dcl_weight, config, False, 1)
            # the graph packs the metrics into one float32 vector
            graphs.seen[signature] = (tuple(metrics) if all(
                v.dtype == torch.float32 and v.dim() == 0 for v in metrics.values())
                else ())
            return state, metrics
        with profiling.span("capture"):
            entry = graphs.graphs[signature] = _capture(
                state, batch, dcl_weight, config, keys, step_fn, backend)
    with profiling.span("replay"):
        entry.fill(batch, dcl_weight)
        metrics = entry.replay()
    backend.launched(device)
    return state, metrics
