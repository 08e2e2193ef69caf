"""The train step's CUDA graph (``step_graph``) on the CPU, through a
stand-in capture backend.

``FakeGraphs`` takes ``step_graph.BACKEND``'s place: a capture runs the
step's Python once and puts back every tensor it wrote, as a capture on a
card runs no kernel; a replay runs the captured Python again on the static
buffers with the spans off, and puts the host's launch counters back, as
a replay on a card runs no Python. So the mechanism around it
(signatures, static inputs and outputs, counters, spans, when a step
stays eager) runs as on the card.
``tests/test_torch_cuda.py`` holds real ``torch.cuda.CUDAGraph`` steps
against eager ones on the card. No JAX."""
import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from endoscopydepthestimation_pytorch_tpu_torch import step_graph, training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                          sgd_update, warp_sample)
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

H, W = 32, 32
CONFIG = training.TrainConfig(lr_step_size=4)


def _written(state):
    """What a train step writes: parameters, momentum, the running
    statistics, ``count`` and ``step``."""
    return [*state.params, *state.momentum, *state.model.buffers(), state.count,
            state.step]


class _FakeGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        """The captured Python again, with no span and no count of its own."""
        counters, spans = step_graph.counter_values(), profiling._on
        profiling._on = False
        try:
            self.fn()
        finally:
            profiling._on = spans
            step_graph.set_counters(counters)


class FakeGraphs:
    """A capture backend for the CPU (see the module's docstring)."""

    def __init__(self):
        self.states = []  # the states whose tensors a capture puts back

    def engages(self, device):
        return True

    def capture(self, fn, device):
        written = [t for s in self.states for t in _written(s)]
        saved = [t.detach().clone() for t in written]
        fn()
        with torch.no_grad():
            for t, v in zip(written, saved):
                t.copy_(v)
        return _FakeGraph(fn)

    def launched(self, device):
        pass


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    monkeypatch.setattr(step_graph, "BACKEND", backend)
    return backend


@pytest.fixture(scope="module")
def start():
    torch.manual_seed(0)
    model = chip_smoke.conditioned(FCDenseNet57(n_classes=1))
    batches = [chip_smoke.synthetic_batch(2, H, W, seed=s, device="cpu") for s in (3, 4, 5)]
    return model, batches


def _state(start, backend=None):
    state = training.create_train_state(copy.deepcopy(start[0]))
    if backend is not None:
        backend.states.append(state)
    return state


def _steps(state, batches, dcls, **kw):
    """One train step a batch; returns each step's metrics, read at once."""
    out = []
    for batch, dcl in zip(batches, dcls):
        _, metrics = training.train_step(state, batch, torch.tensor(dcl), CONFIG, **kw)
        out.append({k: v.clone() for k, v in metrics.items()})
    return out


def _graphed_since(before):
    return {k: step_graph.GRAPHED[k] - before[k] for k in before}


def _assert_same(a_state, b_state, a_metrics, b_metrics):
    for a, b in zip(_written(a_state), _written(b_state)):
        assert torch.equal(a, b)
    assert len(a_metrics) == len(b_metrics)
    for a, b in zip(a_metrics, b_metrics):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_fake_graphed_steps_equal_eager_steps_bit_for_bit(start, fake):
    eager, graphed = _state(start), _state(start, fake)
    before = dict(step_graph.GRAPHED)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(step_graph, "BACKEND", step_graph.CudaGraphs())  # the CPU: eager
        want = _steps(eager, start[1], [0.1] * 3)
    assert _graphed_since(before) == {"eager": 3, "captures": 0, "replays": 0}
    before = dict(step_graph.GRAPHED)
    got = _steps(graphed, start[1], [0.1] * 3)
    assert _graphed_since(before) == {"eager": 1, "captures": 1, "replays": 2}
    assert int(graphed.step) == 3 and int(graphed.count) == 3
    _assert_same(graphed, eager, got, want)


def test_dcl_weight_changed_between_steps_reaches_the_graph(start, fake):
    eager, graphed = _state(start), _state(start, fake)
    dcls = [0.1, 0.1, 5.0]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(step_graph, "BACKEND", step_graph.CudaGraphs())
        want = _steps(eager, start[1], dcls)
    before = dict(step_graph.GRAPHED)
    got = _steps(graphed, start[1], dcls)
    assert _graphed_since(before)["replays"] == 2
    _assert_same(graphed, eager, got, want)
    # the third step's DCL is 50 times the second's weight on its own term
    assert not torch.equal(got[2]["depth_consistency_loss"], got[1]["depth_consistency_loss"])


def test_outputs_of_successive_steps_do_not_alias(start, fake):
    state = _state(start, fake)
    kept, read = [], []
    for batch in start[1]:
        _, metrics = training.train_step(state, batch, torch.tensor(0.1), CONFIG)
        kept.append(metrics)
        read.append({k: float(v) for k, v in metrics.items()})
    assert [{k: float(v) for k, v in m.items()} for m in kept] == read
    assert read[0]["loss"] != read[2]["loss"]
    storages = {m["loss"].untyped_storage().data_ptr() for m in kept}
    assert len(storages) == 3


def _bump():
    """What a step's kernel wrappers would count on a card, in every kind
    of counter: a module's int, a dict's key."""
    dense_conv.LAUNCHES += 2
    block_engine.LAUNCHES["block_engine_fwd"] += 3
    warp_sample.LAUNCHES["warp_sample_bwd"] += 1
    sgd_update.LAUNCHES["sgd_update"] += 1
    sgd_update.RESTRIDED += 5
    depth_anything.LAUNCHES["attention"] += 7


BUMP = [2, 3, 1, 1, 5, 7]


def _read_bumped():
    return [dense_conv.LAUNCHES, block_engine.LAUNCHES["block_engine_fwd"],
            warp_sample.LAUNCHES["warp_sample_bwd"], sgd_update.LAUNCHES["sgd_update"],
            sgd_update.RESTRIDED, depth_anything.LAUNCHES["attention"]]


def test_launch_counters_advance_per_replay_as_per_eager_step(start, fake, monkeypatch):
    losses = training.compute_losses

    def counting(*args):
        _bump()
        return losses(*args)

    monkeypatch.setattr(training, "compute_losses", counting)
    state = _state(start, fake)
    seen = []
    for i in range(4):
        before, graphed = _read_bumped(), dict(step_graph.GRAPHED)
        training.train_step(state, start[1][i % 3], torch.tensor(0.1), CONFIG)
        seen.append(_graphed_since(graphed))
        # eager, capture and replay, replay, replay: one step's launches each
        assert [a - b for a, b in zip(_read_bumped(), before)] == BUMP, i
    assert seen == [{"eager": 1, "captures": 0, "replays": 0},
                    {"eager": 0, "captures": 1, "replays": 1},
                    {"eager": 0, "captures": 0, "replays": 1},
                    {"eager": 0, "captures": 0, "replays": 1}]


def _bf16_flow_mask(batch):
    return {**batch, "flow_mask_1": batch["flow_mask_1"].to(torch.bfloat16)}


def _strided_color(batch):
    color = batch["color_1"]
    wide = torch.zeros(*color.shape[:-1], 4)
    wide[..., :3] = color
    return {**batch, "color_1": wide[..., :3]}


@pytest.mark.parametrize("change", ["shape", "batch_dtype", "dcl_dtype", "stride",
                                    "momentum", "parameter", "config"])
def test_a_new_signature_starts_over_at_eager_then_capture(start, fake, change):
    state = _state(start, fake)
    batch, dcl, config = start[1][0], torch.tensor(0.1), CONFIG
    for _ in range(3):
        training.train_step(state, batch, dcl, config)
    if change == "shape":
        batch = chip_smoke.synthetic_batch(4, H, W, seed=3, device="cpu")
    elif change == "batch_dtype":
        batch = _bf16_flow_mask(batch)
    elif change == "dcl_dtype":
        dcl = dcl.to(torch.bfloat16)
    elif change == "stride":
        batch = _strided_color(batch)
    elif change == "momentum":
        state.momentum = [b.clone() for b in state.momentum]
    elif change == "parameter":
        with torch.no_grad():
            weight = state.model.finalConv.weight
            state.model.finalConv.weight = torch.nn.Parameter(weight.clone())
        state._params = list(state.model.parameters())
    else:
        config = training.TrainConfig(lr_step_size=8)
    before = dict(step_graph.GRAPHED)
    training.train_step(state, batch, dcl, config)
    assert _graphed_since(before) == {"eager": 1, "captures": 0, "replays": 0}
    training.train_step(state, batch, dcl, config)
    assert _graphed_since(before) == {"eager": 1, "captures": 1, "replays": 1}


def test_a_dtype_changed_step_equals_its_eager_step(start, fake):
    """The signature's dtype case computes what eager does: the bf16 flow
    mask holds 0 and 1 exactly, and ``torch.cat`` promotes it."""
    eager, graphed = _state(start), _state(start, fake)
    batches = [_bf16_flow_mask(b) for b in start[1]]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(step_graph, "BACKEND", step_graph.CudaGraphs())
        want = _steps(eager, batches, [0.1] * 3)
    _assert_same(graphed, eager, _steps(graphed, batches, [0.1] * 3), want)


def test_a_copied_state_starts_over(start, fake):
    state = _state(start, fake)
    for _ in range(2):
        training.train_step(state, start[1][0], torch.tensor(0.1), CONFIG)
    assert len(state.graphs.graphs) == 1
    copied = copy.deepcopy(state)
    assert copied.graphs.graphs == {} and copied.graphs.seen == {}
    fake.states.append(copied)
    before = dict(step_graph.GRAPHED)
    for _ in range(2):
        training.train_step(copied, start[1][0], torch.tensor(0.1), CONFIG)
    assert _graphed_since(before) == {"eager": 1, "captures": 1, "replays": 1}


def test_float64_metrics_stay_eager(start, fake):
    state = _state(start, fake)
    before = dict(step_graph.GRAPHED)
    for _ in range(3):
        _, metrics = training.train_step(state, start[1][0],
                                         torch.tensor(0.1, dtype=torch.float64), CONFIG)
    assert metrics["loss"].dtype == torch.float64
    assert _graphed_since(before) == {"eager": 3, "captures": 0, "replays": 0}


@pytest.mark.parametrize("kw", [{"with_images": True}, {"grad_accum": 2}, {"real_cpu": True}],
                         ids=["with_images", "grad_accum_2", "real_cpu_backend"])
def test_eager_only_steps_never_capture(start, fake, monkeypatch, kw):
    kw = dict(kw)
    if kw.pop("real_cpu", False):
        monkeypatch.setattr(step_graph, "BACKEND", step_graph.CudaGraphs())
    state = _state(start, fake)
    before = dict(step_graph.GRAPHED)
    for _ in range(3):
        _, metrics = training.train_step(state, start[1][0], torch.tensor(0.1), CONFIG, **kw)
    assert _graphed_since(before) == {"eager": 3, "captures": 0, "replays": 0}
    assert state.graphs.graphs == {}
    if kw.get("with_images"):
        assert metrics["scaled_depth_1"].shape == (2, H, W, 1)


def _rank_steps(rank, world):
    """A rank of a gloo group: three steps of a tiny FCDenseNet-57 under the
    stand-in backend; returns the graph counts they moved."""
    backend = FakeGraphs()
    step_graph.BACKEND = backend
    torch.manual_seed(0)
    model = chip_smoke.conditioned(FCDenseNet57(n_classes=1))
    state = training.create_train_state(model)
    backend.states.append(state)
    batch = chip_smoke.synthetic_batch(2, H, W, seed=3 + rank, device="cpu")
    before = dict(step_graph.GRAPHED)
    for _ in range(3):
        training.train_step(state, batch, torch.tensor(0.1), CONFIG)
    return _graphed_since(before)


def test_a_process_group_never_captures(tmp_path):
    from torch_parallel_ranks import run_ranks
    codes, errors, results = run_ranks(_rank_steps, 2, tmp_path)
    assert codes == [0, 0], errors
    assert results == [{"eager": 3, "captures": 0, "replays": 0}] * 2


def test_a_graphed_step_is_one_replay_span(start, fake):
    state = _state(start, fake)
    step = lambda: training.train_step(state, start[1][0], torch.tensor(0.1), CONFIG)  # noqa: E731
    step()
    with profiling.root_span("idle"):  # a root with the profiler off: a new session
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        step()  # the capture and its replay
        step()
    session = profiling.sessions()[-1]
    units = sorted({r.unit for r in session.records})
    assert len(units) == 2
    phases = [[r.name for r in sorted(session.records, key=lambda r: r.start_ns)
               if r.unit == u and r.parent == "train_step"] for u in units]
    assert phases == [["capture", "replay"], ["replay"]]
    replayed = [r.name for r in session.records if r.unit == units[1]]
    assert sorted(replayed) == ["replay", "train_step"]
