"""Driver ``offline_stream``: a recorded sequence turned into depth by
``DepthPredictor.stream`` at the mix's batch, over an endless cycle of a
seeded pool of raw uint8 BGR frames. ``prepare`` runs on the stream's
producer thread; the device stays one batch ahead of the readback.

``offline_frames_per_s`` is every frame yielded in the window over the
window's time, from the call to ``stream``. After the window the source
ends and the stream is drained, so its producer thread ends too.
"""
from __future__ import annotations

import itertools
import time
from typing import List

import torch

from harness import counters
from harness.compare import Check
from harness.serving import Answers, Serving, check_forward_path


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        if self.t["pool"] % self.t["batch"]:
            raise ValueError("the pool is a whole number of batches")

    def _source(self, limit=None):
        """The pool, cycled until ``self.stop`` or ``limit`` frames."""
        for i in itertools.count():
            if self.stop or i == limit:
                return
            yield self.serving.frames[i % self.t["pool"]]

    def _open(self, limit=None):
        self.stop = False
        return self.serving.predictor.stream(self._source(limit),
                                             prefetch=self.t["prefetch"])

    def _drain(self, stream, record: bool) -> None:
        """End the source (a limited one ends by itself) and take what the
        stream still yields, so its producer thread ends."""
        self.stop = True
        for i, depth in stream:
            if record:
                self.answers.add(i, depth)

    def setup(self) -> None:
        self.serving = Serving(self.ctx)
        self.answers = Answers(self.t["pool"])
        b, warm = self.t["batch"], self.t["warmup_batches"]
        before = counters.launch_counts()
        for _ in self._open(limit=warm * b):
            pass
        per = counters.per_unit(before, counters.launch_counts(), warm)
        self.ctx.say(f"launches per forward of batch {b} (the port's counters, "
                     f"{warm} forwards): " + ", ".join(f"{k} {v:g}" for k, v in per.items()))
        if self.ctx.device.type == "cuda":
            check_forward_path(per, self.ctx.config)
        predictor = self.serving.predictor
        predictor.prepare = self.ctx.spans.wrap("prepare", predictor.prepare)
        self.stream = self._open()

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        for i, depth in self.stream:
            self.answers.add(i, depth)
            n += 1
            if time.perf_counter() - t0 >= seconds and n % self.t["batch"] == 0:
                break
        elapsed = time.perf_counter() - t0
        self.ctx.say(f"window: {n} frames in {elapsed:.6f} s "
                     f"({n / elapsed:.4f} frames/s, batch {self.t['batch']})")
        return {"metrics": {"offline_frames_per_s": n / elapsed}, "attempted": n,
                "failed": self.answers.mismatched + self.answers.non_finite,
                "units": n, "window_s": elapsed}

    def traced_units(self) -> int:
        n = self.t["trace_batches"] * self.t["batch"]
        for k in range(n):
            with torch.profiler.record_function("h100bench.frame"):
                i, depth = next(self.stream)
                self.answers.add(i, depth)
        return n

    def release(self) -> None:
        self._drain(self.stream, record=True)
        del self.stream
        self.serving.release()

    def check(self) -> List[Check]:
        return self.serving.check(self.answers)
