"""Driver ``train_step_vggt``: the port's ``training.train_step`` back to back
on VGGT (a DINOv2 patch embedder, alternating frame-wise and global
attention blocks over each pair's two frames, and a DPT depth head), on a
pool of synthetic batches staged on the device.

The ``train_step_dpt`` driver (Depth Anything V2's), with what this
network needs instead, as ``train_step_depth_pro`` does for Depth Pro:

- the seeded weights are ``train_step_dpt.seeded_state_dict``'s kinds,
  with the register and camera tokens drawn as the class token; the final
  1x1 conv (32 -> 2, depth = exp of its first channel) scaled by 0.1 with
  log 3 added to its bias, so the depth is near 3;
- the path check: no kernel of the port's own in the network (K1, K4-K6
  0), K2 and K3 once a step, the patch embedder's attention counter
  (``models.depth_anything.LAUNCHES["attention"]``) once a block, the
  aggregator's (``models.vggt.LAUNCHES``) a frame and a global call a
  pair of blocks, and 2B frames through it, all read here beside
  ``harness/counters.launch_counts`` before the window;
- the window also reads the views counter's advance (``views_per_s.vggt``);
  a replayed step advances it as an eager one does;
- the check's reference (``reference/vggt.py``) takes the stacked pair as
  ``reference/objective.loss`` hands it, frame 1's rows and then frame
  2's, and recomputes each transformer block in the backward
  (``reference_checkpoint_blocks`` in the configuration); its chunks of
  ``check_pairs`` pairs never split a sequence;
- the planted faults for the limits (``calibrate``): the reference stepped
  on the pool's next three batches (the program trained on other data),
  beside a state left unchanged and the float8 control.

``compare`` is ``train_step_dpt``'s: ``depth_rel``, ``first_update``,
``change``.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from harness import counters, synthetic
from harness.registry import load_module, reference_model

DPT = load_module(Path(__file__).resolve().parent / "train_step_dpt.py")
CHECK_STEPS = DPT.CHECK_STEPS
HEAD = "depth_head.scratch.output_conv2.2"  # the final 1x1 conv: depth = exp(channel 0)
TOKENS = ("register_tokens", "register_token", "camera_token")
compare = DPT.compare


def vggt_counts() -> Dict[str, int]:
    """The port's counters of VGGT's aggregator (zeros where the port has no
    VGGT)."""
    try:
        from endoscopydepthestimation_pytorch_tpu_torch.models import vggt
    except ImportError:
        return {"frame_attention": 0, "global_attention": 0, "views": 0}
    return dict(vggt.LAUNCHES)


def seeded_state_dict(skeleton, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``train_step_dpt.seeded_state_dict`` on the skeleton without its
    register and camera tokens, which are then drawn N(0, 0.02) as the class
    token, and ``HEAD`` conditioned: depth = exp(log 3 + 0.1 conv)."""
    tokens = {n: p for n, p in skeleton.named_parameters() if n.endswith(TOKENS)}
    for name in tokens:
        owner, attr = skeleton.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
        delattr(owner, attr)
    try:
        out = DPT.seeded_state_dict(skeleton, seed, device, conditioned=False)
    finally:
        for name, p in tokens.items():
            setattr(skeleton.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2], p)
    g = synthetic.generator(seed + 1, device)
    for name, p in tokens.items():
        out[name] = torch.randn(p.shape, generator=g, device=device) * 0.02
    out[f"{HEAD}.weight"] = out[f"{HEAD}.weight"] * 0.1
    out[f"{HEAD}.bias"] = out[f"{HEAD}.bias"] * 0.1 + math.log(3.0)
    return out


def reference_depth(model, batch: Dict[str, torch.Tensor], quant, pairs: int) -> torch.Tensor:
    """The reference's depth of ``batch``'s frames, stacked as the step
    stacks them (frame 1's rows, then frame 2's), NHWC, in chunks of
    ``pairs`` pairs, each chunk's two frames as one stacked pair; on the
    CPU."""
    parts = {1: [], 2: []}
    with torch.no_grad():
        for a in range(0, batch["color_1"].shape[0], pairs):
            bound = batch["boundary"][a:a + pairs]
            x = torch.cat([batch["color_1"][a:a + pairs] * bound,
                           batch["color_2"][a:a + pairs] * bound], 0).permute(0, 3, 1, 2)
            d1, d2 = model(x, quant).permute(0, 2, 3, 1).cpu().chunk(2, 0)
            parts[1].append(d1)
            parts[2].append(d2)
    return torch.cat(parts[1] + parts[2], 0)


class Driver(DPT.Driver):
    def setup(self) -> None:
        from endoscopydepthestimation_pytorch_tpu_torch import training

        t, cfg = self.traffic, self.ctx.config
        t0 = time.perf_counter()
        with torch.device("meta"):
            skeleton = reference_model(cfg)
            model = DPT.port_model(cfg, self.dtype)
        weights = seeded_state_dict(skeleton, self.ctx.seed, self.dev)
        model = model.to_empty(device=self.dev)
        model.load_state_dict(weights, strict=True)
        self.initial = {k: v.detach().cpu().clone() for k, v in weights.items()}
        del weights
        self.hyper = dict(t["hyper"])
        self.config = training.TrainConfig(compute_dtype=self.dtype, **self.hyper)
        self.dcl_weight = torch.tensor(self.hyper["dcl_weight"], device=self.dev)
        self.state = training.create_train_state(model)
        self.pool = synthetic.train_batches(t["pool"], t["batch"], t["height"], t["width"],
                                            self.ctx.seed, self.dev)
        self.train_step = training.train_step
        self.next = 0
        with torch.no_grad():
            self.depth = torch.cat(training._forward_pair(model, self.pool[0]), 0).cpu()
        t1 = time.perf_counter()
        before = counters.launch_counts(), DPT.attention_calls(), vggt_counts()
        losses, first_update = [], None
        for _ in range(CHECK_STEPS):
            _, metrics = self._step()
            losses.append(metrics["loss"])
            if first_update is None:
                first_update = DPT._norms(dict(zip(
                    (n for n, _ in model.named_parameters()), self.state.momentum)))
        per_step = counters.per_unit(before[0], counters.launch_counts(), CHECK_STEPS)
        per_step["attention"] = (DPT.attention_calls() - before[1]) / CHECK_STEPS
        per_step.update(counters.per_unit(before[2], vggt_counts(), CHECK_STEPS))
        t2 = time.perf_counter()
        self.ctx.say("launches per step (the port's counters): "
                     + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        self._check_path(per_step)
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        self.program = {
            "depth": self.depth,
            "losses": [float(v) for v in losses],
            "first_update": first_update,
            "change": DPT._norms({n: now[n].double() - self.initial[n].double()
                                  for n, _ in model.named_parameters()}),
        }
        self.ctx.say("program, steps 1-3: losses " + ", ".join(
            f"{v!r}" for v in self.program["losses"]))
        self.ctx.say(f"set-up: weights, model and batches {t1 - t0:.3f} s, the first "
                     f"{CHECK_STEPS} steps {t2 - t1:.3f} s, their readings "
                     f"{time.perf_counter() - t2:.3f} s")

    def _check_path(self, per_step: Dict[str, float]) -> None:
        """No kernel of the port's own in the network, one K2 and one K3 a
        step, one attention call a patch-embedder block, a frame and a global
        call a pair of aggregator blocks, 2B frames a step."""
        if self.dev.type != "cuda":
            return  # plain twins on the CPU count no launch
        depth = self.ctx.config["depth"]
        counters.check_path(per_step, {"K1": 0, "K2": 1, "K3": 1, "K4": 0, "K5": 0, "K6": 0,
                                       "attention": depth, "frame_attention": depth,
                                       "global_attention": depth,
                                       "views": 2 * self.traffic["batch"]},
                            "the train step")

    def window(self, seconds: float) -> dict:
        before = vggt_counts()["views"]
        out = super().window(seconds)
        out["views"] = vggt_counts()["views"] - before
        self.ctx.say(f"window: {out['views']} frames through the aggregator")
        return out

    def reference_readings(self, quant=None, rows=None) -> dict:
        """The reference's three steps from the initial weights, float32 with
        TF32 off, in chunks of ``check_pairs`` pairs."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = reference_model(self.ctx.config).to(self.dev)
        model.load_state_dict({k: v.to(self.dev) for k, v in self.initial.items()},
                              strict=True)
        pairs = self.traffic["check_pairs"]
        depth = reference_depth(model, self.pool[0], quant, pairs)
        out = DPT.chunked_train_steps(model, self.pool[:CHECK_STEPS], self.hyper, quant, pairs)
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        readings = {
            "depth": depth,
            "boundary": self.pool[0]["boundary"].cpu(),
            "spacing": {n: float(np.linalg.norm(np.spacing(self.initial[n].numpy())))
                        for n, _ in model.named_parameters()},
            "losses": out["losses"],
            "first_update": DPT._norms(out["first_update"]),
            "change": DPT._norms({n: now[n].double() - self.initial[n].double()
                                  for n, _ in model.named_parameters()}),
        }
        del model, out
        return readings


def calibrate(ctx, control: bool, emit) -> dict:
    """Readings for the limits (``calibrate_by_driver.py``): the program's
    against the reference; with ``control`` also the reference with Q, K,
    V and every other matmul and convolution input in float8 e4m3, the
    reference stepped on the pool's next three batches, and a state left
    unchanged."""
    from reference.fcdensenet import fp8_round

    drv = Driver(ctx)
    drv.setup()
    program = drv.program
    other = drv.pool[CHECK_STEPS:2 * CHECK_STEPS]
    drv.release()
    DPT._free(ctx.device)
    ref = drv.reference_readings()
    raw = {"reference": ref, "program": program}
    if control:
        raw["control_fp8_reference"] = drv.reference_readings(quant=fp8_round)
        drv.pool = other
        raw["fault_other_batches"] = drv.reference_readings()
        raw["fault_state_unchanged"] = {
            "depth": program["depth"],
            "losses": program["losses"],
            "first_update": program["first_update"],
            "change": {n: 0.0 for n in ref["change"]}}
    for side, readings in raw.items():
        if side != "reference":
            checks, leaves = compare(readings, ref, ctx.limits)
            emit(side, {**{c.name: c.value for c in checks}, "leaves": leaves})
    return {side: {k: v for k, v in r.items() if k not in ("depth", "boundary")}
            for side, r in raw.items()}
