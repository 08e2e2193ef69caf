"""Driver ``train_step_depth_pro``: the port's ``training.train_step`` back to
back on Depth Pro (a tiled multi-scale ViT encoder and a multi-resolution
decoder), on a pool of synthetic batches staged on the device.

The ``train_step_dpt`` driver (Depth Anything V2's), with what this
network needs instead:

- its final 1x1 conv is ``head.4``: the seeded weights are
  ``train_step_dpt.seeded_state_dict``'s, drawn unconditioned, then that
  conv scaled by 0.1 with its bias set to 3;
- the path check: no kernel of the port's own in the network (K1, K4-K6
  0), K2 and K3 once a step, two attention calls a block (the patch
  encoder's one call over every tile, the image encoder's), and 35 tiles
  a frame through the patch encoder
  (``models.depth_pro.LAUNCHES["tiles"]``, read here beside
  ``harness/counters.launch_counts``);
- the window also reads the tiles counter's advance (``tiles_per_s.dpro``);
  a replayed step advances it as an eager one does;
- the check's reference (``reference/depth_pro.py``) recomputes each ViT
  block in the backward (``reference_checkpoint_blocks`` in the
  configuration): a pair's float32 gradient then fits on the card;
- the planted faults for the limits (``calibrate``): with one pair a
  batch there is no half batch to leave out, so the fault is the
  reference stepped on the pool's next three batches (the program trained
  on other data), beside a state left unchanged and the float8 control.

``compare`` is ``train_step_dpt``'s: ``depth_rel``, ``first_update``,
``change``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict

import torch

from harness import counters, synthetic
from harness.registry import load_module, reference_model

DPT = load_module(Path(__file__).resolve().parent / "train_step_dpt.py")
CHECK_STEPS = DPT.CHECK_STEPS
HEAD = "head.4"  # the final 1x1 conv: depth = relu(its output)
TILES_PER_FRAME = 35
compare = DPT.compare


def tiles_encoded() -> int:
    """The port's count of tiles through Depth Pro's patch encoder (0 where
    the port has no Depth Pro)."""
    try:
        from endoscopydepthestimation_pytorch_tpu_torch.models import depth_pro
    except ImportError:
        return 0
    return depth_pro.LAUNCHES["tiles"]


def seeded_state_dict(skeleton, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``train_step_dpt.seeded_state_dict`` with ``HEAD`` conditioned: the
    depth is relu(3 + 0.1 conv)."""
    out = DPT.seeded_state_dict(skeleton, seed, device, conditioned=False)
    out[f"{HEAD}.weight"] = out[f"{HEAD}.weight"] * 0.1
    out[f"{HEAD}.bias"] = out[f"{HEAD}.bias"] * 0.1 + 3.0
    return out


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
        before = counters.launch_counts(), DPT.attention_calls(), tiles_encoded()
        losses, first_update = [], None
        for _ in range(CHECK_STEPS):
            _, metrics = self._step()
            losses.append(metrics["loss"])
            if first_update is None:
                first_update = DPT._norms(dict(zip(
                    (n for n, _ in model.named_parameters()), self.state.momentum)))
        per_step = counters.per_unit(before[0], counters.launch_counts(), CHECK_STEPS)
        per_step["attention"] = (DPT.attention_calls() - before[1]) / CHECK_STEPS
        per_step["tiles"] = (tiles_encoded() - before[2]) / CHECK_STEPS
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
        step, two attention calls a block and 35 tiles a frame."""
        if self.dev.type != "cuda":
            return  # plain twins on the CPU count no launch
        cfg, frames = self.ctx.config, 2 * self.traffic["batch"]
        counters.check_path(per_step, {"K1": 0, "K2": 1, "K3": 1, "K4": 0, "K5": 0, "K6": 0,
                                       "attention": 2 * cfg["depth"],
                                       "tiles": TILES_PER_FRAME * frames}, "the train step")

    def window(self, seconds: float) -> dict:
        before = tiles_encoded()
        out = super().window(seconds)
        out["tiles"] = tiles_encoded() - before
        self.ctx.say(f"window: {out['tiles']} tiles through the patch encoder")
        return out


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
