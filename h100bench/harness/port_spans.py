"""The port's own spans (``utils.profiling`` in the port), reduced for the
``host_ms.*`` and ``idle_ms.*`` metrics.

The port records spans only while a ``torch.profiler`` session records,
so in a run they come from the traced stretches; they are kept in memory
by profiler session. The readers take the session whose units (root
spans: one ``train_step`` or ``predict_frame`` each) overlap the device
operations of ``ctx.trace``, the stretch that records the device alone,
where the host runs at its untraced pace, and keep those units only.

- ``host_ms.<phase>``: the summed duration of the phase's spans, those
  directly under a unit's root, a unit; ``host_ms.kernels``: of the
  kernel wrappers' spans (K1-K6, around each C call), a unit.
- ``idle_ms.<phase>``: the device's idle gaps, those between consecutive
  segments of the union of the stretch's device intervals, covered by the
  phase's spans, sum of |gap ∩ span|, a unit. A unit's phases run one
  after the other, so they and the gap time under no phase ("outside",
  on the ``say`` line) partition the gap time exactly.

Where the port keeps no span (a program without them), every reader
returns None.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

from .readers import traced
from .tracing import Trace, _union

KERNEL_SPANS = ("dense_conv", "warp_fwd", "warp_bwd", "engine_fwd", "engine_dinput",
                "engine_dweight")


@dataclasses.dataclass
class Reading:
    """The units of one session read against one traced stretch; times in
    seconds, on the profiler's clock."""
    session: int
    root: str
    units: int
    records: list                  # every span of those units
    gap_s: float                   # idle gaps, summed over the stretch
    idle_s: Dict[str, float]       # gap time under each phase
    host_s: Dict[str, float]       # each phase's and kernel's summed span time
    spans: Dict[str, int]          # spans of each name

    @property
    def outside_s(self) -> float:
        return self.gap_s - sum(self.idle_s.values())


def _s(ns: int) -> float:
    return ns * 1e-9


def port_sessions() -> list:
    """The port's kept span sessions; none from a port without spans."""
    try:
        from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling
    except ImportError:
        return []
    sessions = getattr(profiling, "sessions", None)
    return sessions() if sessions is not None else []


def reduce(trace: Trace, sessions) -> Optional[Reading]:
    """The session whose units overlap ``trace``'s device operations, those
    units, and their host and idle time by span name."""
    if not trace.device:
        return None
    lo = min(a for _, a, _ in trace.device)
    hi = max(b for _, _, b in trace.device)
    best = None
    for session in sessions:
        roots = [r for r in session.records
                 if r.parent is None and _s(r.start_ns) < hi and _s(r.end_ns) > lo]
        if roots and (best is None or len(roots) > len(best[1])):
            best = (session, roots)
    if best is None:
        return None
    session, roots = best
    units = {r.unit for r in roots}
    records = [r for r in session.records if r.unit in units]
    root_names = {r.name for r in roots}
    segments = _union(trace.device)
    gaps = [(end, start) for (_, end), (start, _) in zip(segments, segments[1:])]
    starts = [a for a, _ in gaps]
    idle: Dict[str, float] = {}
    host: Dict[str, float] = {}
    spans: Dict[str, int] = {}
    for r in records:
        a, b = _s(r.start_ns), _s(r.end_ns)
        spans[r.name] = spans.get(r.name, 0) + 1
        if r.parent in root_names or r.name in KERNEL_SPANS:
            host[r.name] = host.get(r.name, 0.0) + (b - a)
        if r.parent in root_names:  # a phase
            covered, i = 0.0, max(0, bisect.bisect_right(starts, a) - 1)
            while i < len(gaps) and gaps[i][0] < b:
                covered += max(0.0, min(gaps[i][1], b) - max(gaps[i][0], a))
                i += 1
            idle[r.name] = idle.get(r.name, 0.0) + covered
    return Reading(session.index, "/".join(sorted(root_names)), len(units), records,
                   sum(b - a for a, b in gaps), idle, host, spans)


def k5_margin_s(trace: Trace, reading: Reading) -> Optional[float]:
    """The smallest lead of the i-th K5 kernel's start over the start of
    the first ``backward`` span of unit i // (K5 spans a unit): above 0
    where the spans and the device share the profiler's clock."""
    per_unit = reading.spans.get("engine_dinput", 0) // reading.units
    kernels = sorted(a for name, a, _ in trace.device if "dinput_mma_kernel" in name)
    units = sorted({r.unit for r in reading.records})
    backward = {}
    for r in sorted(reading.records, key=lambda r: r.start_ns):
        if r.name == "backward":
            backward.setdefault(r.unit, _s(r.start_ns))
    if not per_unit or len(kernels) != per_unit * len(units) or len(backward) != len(units):
        return None
    return min(a - backward[units[i // per_unit]] for i, a in enumerate(kernels))


_last: List[object] = [None, None]  # the trace last read, and its reading


def reading(ctx) -> Optional[Reading]:
    """``ctx.trace`` reduced against the port's sessions, once a run; the
    first time, a ``say`` line with the outside part and the span counts."""
    t = traced(ctx)
    if t is None:
        return None
    if _last[0] is not t:
        r = reduce(t, port_sessions())
        _last[:] = [t, r]
        if r is not None:
            ctx.say(_describe(t, r))
    return _last[1]


def _describe(t: Trace, r: Reading) -> str:
    def ms(by_name):
        return {k: round(1e3 * v / r.units, 4) for k, v in by_name.items()}
    margin = k5_margin_s(t, r)
    return (f"port spans: {r.units} units ({r.root}) of session {r.session}, {t.units} "
            f"traced; a unit: idle gaps {1e3 * r.gap_s / r.units:.4f} ms, by phase "
            f"{ms(r.idle_s)}, outside {1e3 * r.outside_s / r.units:.4f} ms "
            f"({100 * r.outside_s / max(r.gap_s, 1e-12):.2f}% of the gap time); host ms "
            f"{ms(r.host_s)}; spans {({k: v / r.units for k, v in r.spans.items()})}"
            + ("" if margin is None else f"; K5 after its step's backward began, "
               f"smallest lead {1e3 * margin:.4f} ms"))


def host_ms(ctx, names) -> Optional[float]:
    """Host ms a unit in the spans named ``names``; None where none ran."""
    r = reading(ctx)
    if r is None or not any(n in r.host_s for n in names):
        return None
    return 1e3 * sum(r.host_s.get(n, 0.0) for n in names) / r.units


def idle_ms(ctx, phase: str) -> Optional[float]:
    """The device's idle ms a unit under the phase's spans; None where the
    phase never ran."""
    r = reading(ctx)
    if r is None or phase not in r.idle_s:
        return None
    return 1e3 * r.idle_s[phase] / r.units
