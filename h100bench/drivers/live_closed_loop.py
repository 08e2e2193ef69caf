"""Driver ``live_closed_loop``: one live stream, closed loop. Each raw
frame goes to ``DepthPredictor.predict_frame`` when the last depth is on
the host, as a live endoscope feed processes its newest frame when the
last is done. Frames cycle a seeded pool of raw uint8 BGR frames.

A frame's latency runs from handing the raw frame to ``predict_frame``
to holding its masked depth on the host; ``frame_latency_p95_ms`` is the
95th percentile over every frame of the window.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from harness import counters
from harness.compare import Check
from harness.serving import Answers, Serving, check_forward_path


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        if self.t["batch"] != 1:
            raise ValueError("a live stream serves batch 1")

    def setup(self) -> None:
        self.serving = Serving(self.ctx)
        self.predict = self.serving.predictor.predict_frame
        self.answers = Answers(self.t["pool"])
        self.index = 0
        warm = self.t["warmup_frames"]
        before = counters.launch_counts()
        for i in range(warm):
            self.serving.predictor.predict_frame(self.serving.frames[i % self.t["pool"]])
        per = counters.per_unit(before, counters.launch_counts(), warm)
        self.ctx.say("launches per frame (the port's counters): "
                     + ", ".join(f"{k} {v:g}" for k, v in per.items()))
        if self.ctx.device.type == "cuda":
            check_forward_path(per, self.ctx.config)
        # prepare's span, recorded only while a stretch is traced
        predictor = self.serving.predictor
        predictor.prepare = self.ctx.spans.wrap("prepare", predictor.prepare)

    def _frame(self) -> float:
        raw = self.serving.frames[self.index % self.t["pool"]]
        t0 = time.perf_counter()
        depth = self.predict(raw)
        latency = time.perf_counter() - t0
        self.answers.add(self.index, depth)
        self.index += 1
        return latency

    def window(self, seconds: float) -> dict:
        latencies: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            latencies.append(self._frame())
        elapsed = time.perf_counter() - t0
        ms = np.asarray(latencies) * 1e3
        p50, p95 = (float(v) for v in np.percentile(ms, [50, 95]))
        self.ctx.say(f"window: {len(ms)} frames in {elapsed:.6f} s; latency median "
                     f"{p50:.4f} ms, p95 {p95:.4f} ms, max {ms.max():.4f} ms "
                     f"({int((ms > p95).sum())} frames beyond the p95)")
        return {"metrics": {"frame_latency_p95_ms": p95}, "attempted": len(ms),
                "failed": self.answers.mismatched + self.answers.non_finite,
                "units": len(ms), "window_s": elapsed}

    def traced_units(self) -> int:
        n = self.t["trace_frames"]
        for _ in range(n):
            with torch.profiler.record_function("h100bench.frame"):
                self._frame()
        return n

    def release(self) -> None:
        del self.predict
        self.serving.release()

    def check(self) -> List[Check]:
        return self.serving.check(self.answers)
