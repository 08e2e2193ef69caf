"""The readers of the port's spans (``harness/port_spans.py``, the
``host_ms.*`` and ``idle_ms.*`` metrics) on a synthetic trace and
synthetic spans: the idle partition, a gap split between two phases, the
session chosen by the device stretch, and nothing read from a port
without spans.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import port_spans, registry  # noqa: E402
from harness.tracing import Trace  # noqa: E402

from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling  # noqa: E402
from endoscopydepthestimation_pytorch_tpu_torch.utils.profiling import (  # noqa: E402
    Session, SpanRecord)

MS = 1_000_000  # ns

# device operations (seconds): [0, 1.5] (two streams), [3, 4], [6, 7],
# [7.5, 8]: gaps (1.5, 3), (4, 6), (7, 7.5), 4 s in all
DEVICE = [("k", 0.0, 1.0), ("k", 0.5, 1.5), ("k", 3.0, 4.0), ("k", 6.0, 7.0),
          ("dinput_mma_kernel<5, true>", 7.5, 8.0)]


def _unit(unit, offset_s=0.0, phases=(("forward", -0.2, 2.0), ("losses", 2.0, 5.0),
                                      ("backward", 5.0, 5.5), ("optimizer", 7.2, 7.4))):
    """A train step's spans, seconds shifted by ``offset_s``."""
    def ns(s):
        return round((s + offset_s) * 1000) * MS
    records = [SpanRecord(name, "train_step", unit, ns(a), ns(b)) for name, a, b in phases]
    records.append(SpanRecord("engine_dinput", "backward", unit, ns(5.1), ns(5.2)))
    records.append(SpanRecord("train_step", None, unit, ns(-0.5), ns(8.5)))
    return records


def _trace():
    return Trace(device=list(DEVICE), host=[], units=1, wall_s=9.0, spans={})


def test_idle_partitions_the_gap_time():
    r = port_spans.reduce(_trace(), [Session(0, _unit(1))])
    assert r.units == 1 and r.gap_s == pytest.approx(4.0, abs=1e-12)
    # outside every phase: (5.5, 6), (7, 7.2), (7.4, 7.5)
    assert r.outside_s == pytest.approx(0.8, abs=1e-9)
    assert sum(r.idle_s.values()) + 0.8 == pytest.approx(r.gap_s, abs=1e-9)
    assert r.idle_s["backward"] == pytest.approx(0.5, abs=1e-9)
    assert r.idle_s["optimizer"] == pytest.approx(0.2, abs=1e-9)
    assert r.host_s == pytest.approx({"forward": 2.2, "losses": 3.0, "backward": 0.5,
                                      "optimizer": 0.2, "engine_dinput": 0.1})
    assert port_spans.k5_margin_s(_trace(), r) == pytest.approx(2.5)


def test_a_gap_across_two_phases_is_split_between_them():
    r = port_spans.reduce(_trace(), [Session(0, _unit(1))])
    # the gap (1.5, 3): 0.5 s under forward, 1 s under losses, which also
    # holds 1 s of the gap (4, 6)
    assert r.idle_s["forward"] == pytest.approx(0.5, abs=1e-9)
    assert r.idle_s["losses"] == pytest.approx(2.0, abs=1e-9)


def test_the_session_that_overlaps_the_device_stretch_is_read():
    older = Session(0, _unit(1, offset_s=-100.0))
    # the device stretch's step and, in the same session, a step of the
    # stretch that recorded the host's ops (no root between found the
    # profiler off)
    merged = Session(1, _unit(2) + _unit(3, offset_s=20.0))
    host_ops = Session(2, _unit(4, offset_s=40.0) + _unit(5, offset_s=50.0))
    r = port_spans.reduce(_trace(), [older, merged, host_ops])
    assert (r.session, r.units) == (1, 1)
    assert {rec.unit for rec in r.records} == {2}
    assert port_spans.reduce(_trace(), [older, host_ops]) is None


def _ctx(trace):
    lines = []
    return SimpleNamespace(trace=trace, say=lines.append), lines


@pytest.fixture(scope="module")
def bench():
    return registry.Benchmark.load()


def test_the_readers_report_per_unit(bench, monkeypatch):
    two = Trace(device=DEVICE + [(n, a + 10, b + 10) for n, a, b in DEVICE], host=[],
                units=2, wall_s=19.0, spans={})
    monkeypatch.setattr(port_spans, "port_sessions",
                        lambda: [Session(7, _unit(1) + _unit(2, offset_s=10.0))])
    ctx, lines = _ctx(two)
    read = {m.name: bench.metric_reader(m.name).read(ctx) for m in bench.per_layer
            if m.source == "program_span" and m.name.endswith(".train")}
    assert read == pytest.approx({
        "host_ms.forward.train": 2200.0, "host_ms.losses.train": 3000.0,
        "host_ms.backward.train": 500.0, "host_ms.optimizer.train": 200.0,
        "host_ms.kernels.train": 100.0, "idle_ms.forward.train": 600.0,
        "idle_ms.losses.train": 2000.0, "idle_ms.backward.train": 500.0,
        "idle_ms.optimizer.train": 200.0})
    # the gap between the two steps' device work, (8, 10), lies under the
    # second step's forward for its last 0.2 s and under no phase before
    assert len(lines) == 1 and "outside 1700.0000 ms" in lines[0], lines
    assert bench.metric_reader("idle_ms.prepare.live").read(ctx) is None


def test_nothing_is_read_from_a_port_without_spans(bench, monkeypatch):
    monkeypatch.delattr(profiling, "sessions")
    ctx, lines = _ctx(_trace())
    for m in bench.per_layer:
        if m.source == "program_span" and m.name != "prepare_ms.live":
            assert bench.metric_reader(m.name).read(ctx) is None, m.name
    assert lines == []
