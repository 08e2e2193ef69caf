"""The traced stretches: ``torch.profiler`` around a few whole units of
work (steps or frames) at the end of a window, reduced to device
intervals, host ops and spans.

Every number is read from a stretch that records the device's activity
alone: recording the host's ops as well costs the host some microseconds
an op, which doubles a step that the host's launch path paces. A second
stretch, with the host's ops recorded, only names the idle gaps of the
breakdown.

Busy time is the union of the device's operation intervals (kernels,
memsets, copies), so work that overlaps on two streams counts once. The
stretch's wall time runs from a device sync before the first unit to a
device sync after the last, on the host's clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

BENCH_SPAN = "h100bench."


@dataclasses.dataclass
class Trace:
    """What one traced stretch left: device operations and host ops as
    (name, start_s, end_s) on the profiler's clock, the number of units
    traced and the stretch's wall time."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    units: int
    wall_s: float
    spans: Dict[str, List[float]]  # the benchmark's own spans, seconds each

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device))

    def kernel_time_s(self, match) -> float:
        """Summed duration of the device operations whose name ``match``
        accepts."""
        return sum(b - a for name, a, b in self.device if match(name))

    def count(self, match=lambda name: True) -> int:
        return sum(1 for name, _, _ in self.device if match(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in them."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by_name[short_name(name)] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        segments = _union(self.device)
        for (_, end), (start, _) in zip(segments, segments[1:]):
            gaps.append((start - end, end, start))
        gaps.sort(reverse=True)
        named = [[self._host_at(0.5 * (a + b)), length] for length, a, b in gaps[:top]]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        """The outermost and the innermost host op running at ``t`` (the
        benchmark's own spans left out), as "outer > inner"; where none
        runs, the host is in Python between ops: named by the op that
        ended last before ``t``."""
        host = [(a, b, name) for name, a, b in self.host if not name.startswith(BENCH_SPAN)]
        live = sorted((e for e in host if e[0] <= t <= e[1]), key=lambda e: (e[0], -e[1]))
        if live:
            outer, inner = live[0][2], live[-1][2]
            return outer if outer == inner else f"{outer} > {inner}"
        before = [e for e in host if e[1] < t]
        return ("between ops, after " + max(before, key=lambda e: e[1])[2] if before
                else "between ops")


def _annotation(event) -> bool:
    probe = getattr(event, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its argument list, at most ``limit`` long."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:limit]


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted((a, b) for _, a, b in intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Spans:
    """Host-clock spans the drivers record around calls into the program's
    layers (only while a stretch is traced)."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.on = False

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.times[name].append(time.perf_counter() - t0)
        return timed


@contextlib.contextmanager
def traced(device: torch.device, spans: Spans, host_ops: bool = False) -> Iterator[dict]:
    """Profile the enclosed units: the device's activity, and with
    ``host_ops`` the host's ops too (on a machine without a card, always
    the host's). Yields a dict; the caller sets ``units``. On exit it
    holds ``trace``, a :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = (([ProfilerActivity.CPU] if host_ops or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    out: dict = {"units": 0}
    if cuda:
        torch.cuda.synchronize(device)
    spans.times.clear()
    spans.on = True
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            yield out
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        spans.on = False
    device_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, memsets, copies; not the device-side copies of
            # record_function ranges, which span whole units
            if not (e.name().startswith(BENCH_SPAN) or _annotation(e)):
                device_ops.append(span)
        else:
            host_ops.append(span)    # ops, spans, runtime calls
    out["trace"] = Trace(device_ops, host_ops, out["units"], wall,
                         {k: list(v) for k, v in spans.times.items()})
