"""Step timing, device traces and the port's spans (JAX package
``utils/profiling.py``: ``device_trace`` :18, ``StepTimer`` :42).

``device_trace`` records a ``torch.profiler`` trace (CPU and, on a CUDA
device, the card's kernels) and writes it as a Chrome trace, a table of
the device time by op and the spans it saw; ``StepTimer`` keeps per-step
wall-clock times with percentile summaries.

**Spans.** ``root_span`` opens one unit of work (``train_step``,
``predict_frame``, ``predict_batch``) and ``span`` a part of it: a phase
(``forward``, ``losses``, ``backward``, ``optimizer``, ``all_reduce``;
``prepare``, ``dispatch``, ``readback``) or a kernel wrapper's C call
(``dense_conv`` K1, ``warp_fwd`` K2, ``warp_bwd`` K3, ``engine_fwd`` K4,
``engine_dinput`` K5, ``engine_dweight`` K6, each beside its ``LAUNCHES``
counter). The switch is the profiler itself: a root checks once whether a
``torch.profiler`` session records on its thread, and its spans record
only then. Off, a span is one flag read and allocates nothing; on, it
also opens a ``record_function`` range ``endo.<name>``, which Chrome
traces show. A record holds the span's name, its parent's name, the unit
(one id per root call, shared by all of its spans) and its start and end
in ns on ``time.time_ns()``, the clock the profiler stamps its host and
device events with (CLOCK_REALTIME). Records stay in memory, grouped by
profiler session (``sessions()``): a session begins when a root finds the
profiler on after a root found it off, or after ``device_trace`` began;
the last ``MAX_SESSIONS`` are kept. Two profiler sessions with no root
between them that found the profiler off share one session here (torch
shows no session's identity); their units are told apart by time.
Spans assume one unit at a time: autograd's device thread runs a
backward's kernel spans while the step's thread waits in ``backward``,
and they nest there.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

MAX_SESSIONS = 4
PREFIX = "endo."  # the spans' record_function ranges


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # None for a root
    unit: int
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Session:
    """The spans of one profiler session, in the order they ended."""
    index: int
    records: List[SpanRecord] = dataclasses.field(default_factory=list)


_sessions: Deque[Session] = collections.deque(maxlen=MAX_SESSIONS)
_begun = 0          # sessions begun in this process
_on = False         # a root is open and the profiler records
_was_off = True     # the last root found the profiler off
_unit = 0
_stack: List[str] = []


def sessions() -> List[Session]:
    """The kept sessions, oldest first."""
    return list(_sessions)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.name)
        self.start = time.time_ns()
        self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _stack.pop()
        _sessions[-1].records.append(
            SpanRecord(self.name, self.parent, _unit, self.start, end))
        return False


class _Root(_Span):
    __slots__ = ()

    def __enter__(self):
        global _on, _was_off, _unit, _begun
        if _was_off:
            _sessions.append(Session(_begun))
            _begun += 1
            _was_off = False
        _unit += 1
        _on = True
        super().__enter__()

    def __exit__(self, *exc):
        global _on
        _on = False
        return super().__exit__(*exc)


def span(name: str):
    """A part of the open unit (a phase or a kernel call): recorded only
    inside a root that found the profiler on."""
    return _Span(name) if _on else _NULL


def root_span(name: str):
    """One unit of work; checks whether the profiler records. Inside
    another root it is a plain span."""
    global _was_off
    if _on:
        return _Span(name)
    if not torch._C._autograd._profiler_enabled():
        _was_off = True
        return _NULL
    return _Root(name)


def _phase_ms(session: Session, root: str) -> Dict[str, float]:
    """Host ms a unit of each span directly under the roots named
    ``root``, mean over those units (the sum of the span's calls in a
    unit, over the units)."""
    units = {r.unit for r in session.records if r.name == root and r.parent is None}
    total: Dict[str, float] = collections.defaultdict(float)
    for r in session.records:
        if r.unit in units and r.parent == root:
            total[r.name] += (r.end_ns - r.start_ns) * 1e-6
    return {k: v / len(units) for k, v in total.items()} if units else {}


def _device_union_ms(events) -> float:
    """The union of the device's operation intervals (kernels, memsets,
    copies; not the device-side copies of ``record_function`` ranges), in
    ms: work that overlaps on two streams counts once."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and not (e.name().startswith(PREFIX) or e.is_user_annotation()))
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6


@contextlib.contextmanager
def device_trace(log_dir, enabled: bool = True):
    """Profile the enclosed work into ``log_dir``: ``trace.json`` (open it
    in chrome://tracing or Perfetto), ``ops.txt``, the ops by their self
    device time (by CPU time without a card), and ``spans.json``, the
    spans recorded meanwhile. Yields a dict that is filled on exit with
    ``window_ms`` (wall clock, to the end of the device's work),
    ``host_ms.<phase>``, each ``train_step`` phase's host ms a step, and,
    on a card, ``device_busy_ms`` (the union of the device's operation
    intervals) and ``idle_share`` (1 - busy / window); yields None when
    not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    global _was_off
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    summary: Dict[str, float] = {}
    _was_off = True
    first = _begun
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield summary
        if cuda:
            torch.cuda.synchronize()
        summary["window_ms"] = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    events = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    (log_dir / "ops.txt").write_text(events.table(sort_by=key, row_limit=50))
    traced = Session(first, [r for s in _sessions if s.index >= first for r in s.records])
    (log_dir / "spans.json").write_text(json.dumps({
        "clock": "time.time_ns() (CLOCK_REALTIME), the profiler's",
        "spans": [r._asdict() for r in sorted(traced.records, key=lambda r: r.start_ns)]}))
    summary.update({f"host_ms.{phase}": ms
                    for phase, ms in _phase_ms(traced, "train_step").items()})
    if cuda:
        busy = _device_union_ms(prof.profiler.kineto_results.events())
        summary["device_busy_ms"] = busy
        summary["idle_share"] = 1.0 - busy / summary["window_ms"]


class StepTimer:
    """Wall-clock per-step timing with percentile summaries.

    Call ``tick()`` once per step after the step's result has reached the
    host (a scalar read back), so the time covers the device's work. The
    first ``skip`` intervals are warm-up.
    """

    def __init__(self, skip: int = 2):
        self.skip = skip
        self._times: List[float] = []
        self._last: Optional[float] = None
        self._seen = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            self._seen += 1
            dt = now - self._last
            if self._seen > self.skip:
                self._times.append(dt)
        self._last = now
        return dt

    def reset_epoch(self):
        self._last = None

    @property
    def times_ms(self) -> List[float]:
        """The step times kept (after the warm-up), in ms."""
        return [t * 1e3 for t in self._times]

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times) * 1000.0
        return {
            "steps": float(len(arr)),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()),
        }
