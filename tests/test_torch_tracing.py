"""The port's spans (``utils.profiling``) on the CPU: the span tree of a
train step and of a served frame under ``torch.profiler``, nothing
recorded without it, the spans on the profiler's own clock, sessions and
their bound, and ``device_trace``'s files and summary.

On the CPU the kernel wrappers run their plain twins and count no launch,
so no kernel span opens either; ``tests/test_torch_cuda.py`` checks the
kernel spans against the launch counters on the card."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from endoscopydepthestimation_pytorch_tpu_torch import serving, training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet, FCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch.models.init import init_weights
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

PHASES = ["forward", "losses", "backward", "optimizer"]
KERNELS = {"dense_conv", "warp_fwd", "warp_bwd", "engine_fwd", "engine_dinput",
           "engine_dweight"}
H, W = 32, 40


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model = FCDenseNet(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2,
                       growth_rate=12, out_chans_first_conv=24, n_classes=1)
    state = training.create_train_state(chip_smoke.conditioned(model))
    batch = chip_smoke.synthetic_batch(2, H, W, seed=3, device="cpu")
    return state, batch


def _step(tiny, **kw):
    state, batch = tiny
    return training.train_step(state, batch, torch.tensor(0.1), training.TrainConfig(),
                               **kw)


def _profiler_off_root():
    """A root that finds the profiler off: the next session is a new one."""
    with profiling.root_span("idle"):
        pass


def _traced(fn, n=1):
    """``fn`` n times under a CPU profiler; returns (the session, the
    profiler)."""
    _profiler_off_root()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
    return profiling.sessions()[-1], prof


def test_train_step_span_tree(tiny):
    session, _ = _traced(lambda: _step(tiny), n=2)
    roots = sorted((r for r in session.records if r.parent is None), key=lambda r: r.start_ns)
    assert [r.name for r in roots] == ["train_step", "train_step"]
    assert len({r.unit for r in roots}) == 2
    for root in roots:
        spans = sorted((r for r in session.records if r.unit == root.unit),
                       key=lambda r: r.start_ns)
        phases = [r for r in spans if r.parent == "train_step"]
        assert [r.name for r in phases] == PHASES  # no process group: no all_reduce
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in phases)
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        # the plain twins on the CPU: no launch, no kernel span
        assert not [r for r in spans if r.name in KERNELS]
        assert {r.name for r in spans} == {"train_step", *PHASES}


def test_grad_accum_repeats_the_phases_in_one_unit(tiny):
    session, _ = _traced(lambda: _step(tiny, grad_accum=2))
    assert len({r.unit for r in session.records}) == 1
    phases = sorted((r for r in session.records if r.parent == "train_step"),
                    key=lambda r: r.start_ns)
    assert [r.name for r in phases] == PHASES[:3] * 2 + ["optimizer"]


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    g = torch.Generator().manual_seed(5)
    model = chip_smoke.conditioned(init_weights(FCDenseNet57(), g))
    path = tmp_path_factory.mktemp("tracing") / "seeded.pt"
    ckpt.save_checkpoint(path, training.create_train_state(model), 0, 0.0)
    return serving.DepthPredictor(path, chip_smoke.synthetic_sequence(64, 64),
                                  downsampling=1.0, device="cpu", dtype=torch.float32)


def test_predict_frame_span_tree(predictor):
    frame = chip_smoke.synthetic_frames(1, 64, 64, seed=2)[0]
    session, _ = _traced(lambda: predictor.predict_frame(frame))
    (root,) = [r for r in session.records if r.parent is None]
    assert root.name == "predict_frame"
    phases = sorted((r for r in session.records if r.parent == "predict_frame"),
                    key=lambda r: r.start_ns)
    assert [r.name for r in phases] == ["prepare", "dispatch", "readback"]
    assert {r.unit for r in session.records} == {root.unit}
    assert len(session.records) == 4  # K1's plain twin on the CPU: no span

    colors = np.repeat(predictor.prepare(frame)[None], 1, axis=0)
    session, _ = _traced(lambda: predictor.predict_batch(colors))
    assert sorted((r.name, r.parent) for r in session.records) == [
        ("dispatch", "predict_batch"), ("predict_batch", None),
        ("readback", "predict_batch")]


def test_nothing_records_without_the_profiler(tiny, predictor, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record_function range opened: {name}")
    _traced(lambda: _step(tiny))
    before = [(s.index, len(s.records)) for s in profiling.sessions()]
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _step(tiny)
    predictor.predict_frame(chip_smoke.synthetic_frames(1, 64, 64, seed=2)[0])
    assert [(s.index, len(s.records)) for s in profiling.sessions()] == before
    # off, a span is one shared object: nothing allocated
    assert profiling.span("forward") is profiling.span("losses")
    assert profiling.root_span("train_step") is profiling.span("backward")


def test_spans_bracket_their_ranges_on_the_profilers_clock(tiny, predictor):
    frame = chip_smoke.synthetic_frames(1, 64, 64, seed=2)[0]

    def both():
        _step(tiny)
        predictor.predict_frame(frame)
    session, prof = _traced(both)
    ranges = sorted((e.name()[len(profiling.PREFIX):], e.start_ns(),
                     e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(profiling.PREFIX))
    records = sorted((r.name, r.start_ns, r.end_ns) for r in session.records)
    assert len(ranges) == len(records) == 9
    slack = 1_000_000  # 1 ms
    for (name, a, b), (rname, start, end) in zip(ranges, records):
        assert name == rname
        assert start - slack <= a <= b <= end + slack, (name, a - start, end - b)


def test_each_profiler_session_is_its_own(tiny):
    first, _ = _traced(lambda: _step(tiny))
    second, _ = _traced(lambda: _step(tiny))
    assert second.index == first.index + 1
    assert profiling.sessions()[-2:] == [first, second]
    assert not {r.unit for r in first.records} & {r.unit for r in second.records}
    # back to back, with no root between that found the profiler off: one
    # session, unless device_trace began it
    _profiler_off_root()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(tiny)
    with profile(activities=[ProfilerActivity.CPU]):
        _step(tiny)
    assert len([r for r in profiling.sessions()[-1].records if r.parent is None]) == 2


def test_sessions_stay_bounded():
    seen = []
    for _ in range(3 * profiling.MAX_SESSIONS):
        session, _ = _traced(_root_only)
        seen.append(session.index)
    kept = profiling.sessions()
    assert len(kept) == profiling.MAX_SESSIONS
    assert [s.index for s in kept] == seen[-profiling.MAX_SESSIONS:]


def _root_only():
    with profiling.root_span("predict_batch"):
        with profiling.span("dispatch"):
            pass


def test_a_root_inside_a_root_is_a_plain_span():
    session, _ = _traced(_nested)
    assert sorted((r.name, r.parent) for r in session.records) == [
        ("dispatch", "predict_batch"), ("predict_batch", "predict_frame"),
        ("predict_frame", None)]


def _nested():
    with profiling.root_span("predict_frame"):
        _root_only()


def test_device_trace_writes_spans_and_phase_times(tiny, tmp_path):
    with profiling.device_trace(tmp_path) as summary:
        for _ in range(2):
            _step(tiny)
    assert {"trace.json", "ops.txt", "spans.json"} <= {p.name for p in tmp_path.iterdir()}
    spans = json.loads((tmp_path / "spans.json").read_text())["spans"]
    assert sum(s["name"] == "train_step" for s in spans) == 2
    assert [s["start_ns"] for s in spans] == sorted(s["start_ns"] for s in spans)
    for phase in PHASES:
        assert 0 < summary[f"host_ms.{phase}"] < summary["window_ms"] / 2
    # a second trace begins a session of its own
    with profiling.device_trace(tmp_path / "again") as again:
        _step(tiny)
    spans = json.loads((tmp_path / "again" / "spans.json").read_text())["spans"]
    assert sum(s["name"] == "train_step" for s in spans) == 1
    assert set(again) == set(summary)


def test_device_busy_is_the_union_of_device_intervals():
    def event(a, b, device=True, name="k", annotation=False):
        kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
        return SimpleNamespace(start_ns=lambda: a, duration_ns=lambda: b - a,
                               device_type=lambda: kind, name=lambda: name,
                               is_user_annotation=lambda: annotation)
    events = [event(0, 1_000_000), event(500_000, 1_500_000),  # two streams overlap
              event(3_000_000, 4_000_000), event(0, 9_000_000, device=False),
              event(0, 9_000_000, name="endo.train_step"),
              event(0, 9_000_000, annotation=True)]
    assert profiling._device_union_ms(events) == pytest.approx(2.5)
