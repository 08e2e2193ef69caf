"""What the serving drivers share: the predictor built from seeded
weights, the raw frame pool, each answer's fingerprint, and the check
against the plain reference.

Every answer of the window is checked. The pool holds ``pool`` distinct
raw frames and the program is deterministic, so the first answer for
each pool frame is kept whole and compared with the reference, and every
later answer for that frame must carry the same fingerprint (a CRC of a
strided sample of its bytes) as the first: a count of mismatches with
the limit 0.
"""
from __future__ import annotations

import os
import tempfile
import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from . import counters, synthetic
from .compare import Check, masked_rel
from .registry import reference_model
from reference import serving as ref_serving

STRIDE = 7  # the fingerprint's sample: every 7th row and column


def fingerprint(depth: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(depth[::STRIDE, ::STRIDE]).tobytes())


class Answers:
    """The window's answers, by frame index, checked as they arrive."""

    def __init__(self, pool: int):
        self.pool = pool
        self.first: Dict[int, np.ndarray] = {}
        self.prints: Dict[int, int] = {}
        self.mismatched = 0
        self.non_finite = 0
        self.seen = 0
        self.order_errors = 0

    def add(self, index: int, depth: np.ndarray) -> bool:
        """Record one answer; False when it cannot be right."""
        if index != self.seen:
            self.order_errors += 1
        self.seen += 1
        key = index % self.pool
        fp = fingerprint(depth)
        if key not in self.first:
            self.first[key] = np.array(depth, copy=True)
            self.prints[key] = fp
            ok = bool(np.isfinite(self.first[key]).all())
        else:
            ok = fp == self.prints[key]
            self.mismatched += not ok
        self.non_finite += not np.isfinite(depth[::STRIDE, ::STRIDE]).all()
        return ok


class Serving:
    """The predictor of a serving cell and its inputs."""

    def __init__(self, ctx):
        self.ctx = ctx
        t, cfg = ctx.traffic, ctx.config
        if cfg["builder"] != "FCDenseNet57":
            raise ValueError("DepthPredictor serves FCDenseNet57 only, not "
                             f"{cfg['builder']}")
        t0 = time.perf_counter()
        self.factor = int(t["downsampling"])
        self.sequence = synthetic.sequence(t["height"], t["width"])
        self.frames = synthetic.raw_frames(t["pool"], t["height"], t["width"],
                                           self.factor, ctx.seed, ctx.device)
        with torch.device("meta"):
            skeleton = reference_model(cfg)
        # the head conditioned as in the train cells: at a raw init some
        # seeds' depth sits near |.|'s kink at 0, where a relative error
        # measures the seed more than the program
        weights = synthetic.seeded_state_dict(skeleton, ctx.seed, ctx.device,
                                              conditioned=True)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        t1 = time.perf_counter()
        self.predictor = self._predictor()
        ctx.say(f"set-up: frames and weights {t1 - t0:.3f} s, the predictor "
                f"{time.perf_counter() - t1:.3f} s")

    def _predictor(self):
        from endoscopydepthestimation_pytorch_tpu_torch import DepthPredictor
        t = self.ctx.traffic
        # the weights as a reference-format .pt under TMPDIR, removed once read
        fd, path = tempfile.mkstemp(suffix=".pt", prefix="h100bench-weights-")
        os.close(fd)
        try:
            torch.save({"model": {f"module.{k}": v for k, v in self.weights.items()}},
                       path)
            return DepthPredictor(path, self.sequence, batch_size=t["batch"],
                                  downsampling=float(t["downsampling"]),
                                  device=self.ctx.device,
                                  dtype=getattr(torch, self.ctx.config["dtype"]))
        finally:
            os.unlink(path)

    def release(self) -> None:
        del self.predictor

    def reference_depths(self, keys: List[int], quant=None, block: int = 8) -> Dict[int, np.ndarray]:
        """The reference's masked depth of pool frames ``keys``, in blocks."""
        model = reference_model(self.ctx.config).to(self.ctx.device)
        model.load_state_dict(self.weights, strict=True)
        mask = ref_serving.boundary(self.sequence.mask_boundary)
        crop = self.sequence.crop_positions
        out = {}
        for i in range(0, len(keys), block):
            part = keys[i:i + block]
            colors = np.stack([ref_serving.prepare(self.frames[k], crop, self.factor)
                               for k in part])
            for k, d in zip(part, ref_serving.masked_depth(model, colors, mask,
                                                           self.ctx.device, quant)):
                out[k] = d
        del model
        return out

    def check(self, answers: Answers) -> List[Check]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        keys = sorted(answers.first)
        ref = self.reference_depths(keys)
        mask = ref_serving.boundary(self.sequence.mask_boundary)
        self.gaps = gaps = [masked_rel(answers.first[k], ref[k], mask) for k in keys]
        lim = self.ctx.limits
        checks = [
            Check("depth_rel", max(gaps) if gaps else float("inf"), lim["depth_rel"]),
            Check("repeat_mismatch", float(answers.mismatched + answers.non_finite),
                  lim["repeat_mismatch"]),
            Check("order_errors", float(answers.order_errors), lim["order_errors"]),
        ]
        self.ctx.say(f"checked {answers.seen} answers: {len(keys)} distinct frames "
                     f"against the reference (worst masked mean rel "
                     f"{checks[0].value!r}), {answers.mismatched} repeats unlike the "
                     f"first, {answers.non_finite} non-finite, "
                     f"{answers.order_errors} out of order")
        return checks


def check_forward_path(per_forward, config: dict) -> None:
    """An eval forward runs every dense layer through K1, and nothing of
    the engine or the sampler."""
    from .roofline import dense_layer_shapes
    layers = len(dense_layer_shapes(config, 8, 8))
    counters.check_path(per_forward, {"K1": layers, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                                      "K6": 0}, "the serving forward")
