"""Step timing and device traces (JAX package ``utils/profiling.py``:
``device_trace`` :18, ``StepTimer`` :42).

``device_trace`` records a ``torch.profiler`` trace (CPU and, on a CUDA
device, the card's kernels) and writes it as a Chrome trace plus a table
of the device time by op; ``StepTimer`` keeps per-step wall-clock times
with percentile summaries.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir, enabled: bool = True):
    """Profile the enclosed work into ``log_dir``: ``trace.json`` (open it
    in chrome://tracing or Perfetto) and ``ops.txt``, the ops by their
    self device time (by CPU time without a card). Yields a dict that is
    filled on exit with ``window_ms`` (wall clock, to the end of the
    device's work) and, on a card, ``device_busy_ms`` (the kernels' summed
    device time) and ``idle_share`` (1 - busy / window); yields None when
    not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    summary: Dict[str, float] = {}
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
    if cuda:
        busy = sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
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
