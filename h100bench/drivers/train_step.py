"""Driver ``train_step``: the port's ``training.train_step`` back to back on
a pool of synthetic batches staged on the device.

Set-up builds one ``TrainState`` (the configuration's network in its
activation type, float32 parameters, weights from the seed with the head
conditioned), drives it through the window's own call on the pool's
batches 0, 1 and 2, records what the check needs, and hands that same
state to the window. The window cycles the pool from batch 3 and ends at
a device sync; ``train_samples_per_s`` is every sample of every step
enqueued over the window's time.

The check runs the plain reference (``reference/``) in float32 from the
same initial weights over the same three batches, once the program's
state is freed, and compares each step's loss, the first update (the
momentum after one step: the clipped gradient) per parameter, the
parameters' change after three steps per parameter, and the running
statistics' change per buffer.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import counters, synthetic
from harness.compare import Check, percentile_leaf_gap, worst_leaf_gap
from harness.registry import reference_model
from reference import objective as ref_objective

CHECK_STEPS = 3
# leaves whose reference gradient is below this share of the median
# leaf's are nought to rounding (a conv bias under a BatchNorm) and move
# under the update by round-off alone: they stay out of the comparisons
ZERO_GRADIENT = 1e-3
# a parameter's change over three steps at a rate near 1e-4 can be a few
# float32 spacings of its values (BatchNorm weights near 1 often do not
# move at all): the change is compared for leaves whose reference change
# is at least this many times the norm of their values' spacings
REPRESENTABLE = 16.0


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[n].detach().double().norm() for n in names])
    return dict(zip(names, values.cpu().tolist()))


def port_model(models, cfg: dict, dtype):
    """The port's network of a configuration: its named builder, or with
    the builder ``FCDenseNet`` the generic class at the file's sizes.
    ``port_flags`` (the calibration's act8 control) pass to the builder."""
    flags = cfg.get("port_flags", {})
    if cfg["builder"] == "FCDenseNet":
        return models.FCDenseNet(cfg["down_blocks"], cfg["up_blocks"],
                                 cfg["bottleneck_layers"], cfg["growth_rate"],
                                 cfg["out_chans_first_conv"], cfg["n_classes"], dtype=dtype,
                                 **flags)
    return getattr(models, cfg["builder"])(n_classes=cfg["n_classes"], dtype=dtype, **flags)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.dtype = getattr(torch, ctx.config["dtype"])
        self.dev = ctx.device

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from endoscopydepthestimation_pytorch_tpu_torch import models, training

        t, cfg = self.traffic, self.ctx.config
        t0 = time.perf_counter()
        with torch.device("meta"):
            skeleton = reference_model(cfg)
            model = port_model(models, cfg, self.dtype)
        weights = synthetic.seeded_state_dict(skeleton, self.ctx.seed, self.dev,
                                              conditioned=True)
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
        t1 = time.perf_counter()
        before = counters.launch_counts()
        losses, first_update = [], None
        for _ in range(CHECK_STEPS):
            _, metrics = self._step()
            losses.append(metrics["loss"])
            if first_update is None:
                first_update = _norms(dict(zip(
                    (n for n, _ in model.named_parameters()), self.state.momentum)))
        per_step = counters.per_unit(before, counters.launch_counts(), CHECK_STEPS)
        t2 = time.perf_counter()
        self.ctx.say("launches per step (the port's counters): "
                     + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        self._check_path(per_step)
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        self.program = {
            "losses": [float(v) for v in losses],
            "first_update": first_update,
            "change": _norms({n: now[n].double() - self.initial[n].double()
                              for n, _ in model.named_parameters()}),
            "stats_change": _norms({n: now[n].double() - self.initial[n].double()
                                    for n in now if "running_" in n}),
        }
        self.ctx.say("program, steps 1-3: losses " + ", ".join(
            f"{v!r}" for v in self.program["losses"]))
        self.ctx.say(f"set-up: weights, model and batches {t1 - t0:.3f} s, the first "
                     f"{CHECK_STEPS} steps {t2 - t1:.3f} s, their readings "
                     f"{time.perf_counter() - t2:.3f} s")

    def _check_path(self, per_step: Dict[str, float]) -> None:
        """The train path runs every dense layer through the engine: one
        K4, K5 and K6 a layer, one K2 and one K3, and no K1."""
        from harness.roofline import dense_layer_shapes
        if self.dev.type != "cuda" or self.ctx.config.get("port_flags"):
            return  # plain twins on the CPU count no launch; act8 replays K4
        layers = len(dense_layer_shapes(self.ctx.config, 8, 8))
        counters.check_path(per_step, {"K1": 0, "K2": 1, "K3": 1, "K4": layers,
                                       "K5": layers, "K6": layers}, "the train step")

    def _step(self):
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.train_step(self.state, batch, self.dcl_weight, self.config)

    # -- the window --------------------------------------------------------------

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float) -> dict:
        self._sync()
        step0 = int(self.state.step)
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
            steps += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        finite = int(self.state.step) - step0
        batch = self.traffic["batch"]
        rate = steps * batch / elapsed
        self.ctx.say(f"window: {steps} steps of batch {batch} in {elapsed:.6f} s, "
                     f"{1e3 * elapsed / steps:.4f} ms a step on average; "
                     f"{steps - finite} steps with a non-finite loss")
        return {"metrics": {"train_samples_per_s": rate}, "attempted": steps,
                "failed": steps - finite, "units": steps, "window_s": elapsed}

    def traced_units(self) -> int:
        n = self.traffic["trace_steps"]
        for _ in range(n):
            with torch.profiler.record_function("h100bench.step"):
                self._step()
        return n

    def release(self) -> None:
        del self.state, self.train_step
        self.pool = self.pool[:CHECK_STEPS]

    # -- the check ----------------------------------------------------------------

    def check(self) -> List[Check]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        reference = self.reference_readings(quant=None)
        lim = self.ctx.limits
        checks, leaves = compare(self.program, reference, lim)
        for c in checks:
            self.ctx.say(f"  {c.name}: program {c.value!r} (limit {c.limit!r}) "
                         f"{leaves.get(c.name, '')}")
        return checks

    def reference_readings(self, quant=None, rows=None) -> dict:
        """The reference's three steps from the initial weights; ``rows``
        keeps only those rows of every batch (a planted fault)."""
        model = reference_model(self.ctx.config).to(self.dev)
        model.load_state_dict({k: v.to(self.dev) for k, v in self.initial.items()},
                              strict=True)
        batches = self.pool[:CHECK_STEPS]
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        out = ref_objective.train_steps(model, batches, self.hyper, quant)
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        readings = {
            "spacing": {n: float(np.linalg.norm(np.spacing(self.initial[n].numpy())))
                        for n, _ in model.named_parameters()},
            "losses": out["losses"],
            "first_update": _norms(out["first_update"]),
            "change": _norms({n: now[n].double() - self.initial[n].double()
                              for n, _ in model.named_parameters()}),
            "stats_change": _norms({n: now[n].double() - self.initial[n].double()
                                    for n in now if "running_" in n}),
        }
        del model
        return readings


def compare(program: dict, reference: dict, limits: Dict[str, float]):
    """The numbers of a train cell, and the leaf each worst one was read at.

    - ``loss``: the worst of the three steps' relative loss gaps;
    - ``first_update``: the worst parameter's gap in the first update's
      norm (the momentum after one step: the clipped gradient), and
      ``first_update_p90`` the 90th percentile of the parameters' gaps,
      steady from seed to seed where the worst is one small leaf's
      rounding;
    - ``change``: the worst parameter's gap in the norm of its change over
      the three steps, among those whose change float32 can hold;
    - ``bn_stats_change``: the worst running statistic's gap in its change.

    A gap is |program - reference| over the larger of the reference's norm
    of that leaf and of the median leaf. Leaves whose reference gradient is
    nought to rounding are left out of the first update and the change."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    loss_gap = max(losses) if all(np.isfinite(losses)) else float("inf")
    grads = reference["first_update"]
    median = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= ZERO_GRADIENT * median]
    first, first_leaf = worst_leaf_gap(program["first_update"], grads, moving)
    first_p90 = percentile_leaf_gap(program["first_update"], grads, moving, 90)
    held = [n for n in moving
            if reference["change"][n] >= REPRESENTABLE * reference["spacing"][n]]
    change, change_leaf = worst_leaf_gap(program["change"], reference["change"], held)
    stats, stats_leaf = worst_leaf_gap(program["stats_change"], reference["stats_change"])
    checks = [Check("loss", loss_gap, limits["loss"]),
              Check("first_update", first, limits["first_update"]),
              Check("first_update_p90", first_p90, limits["first_update_p90"]),
              Check("change", change, limits["change"]),
              Check("bn_stats_change", stats, limits["bn_stats_change"])]
    return checks, {"first_update": first_leaf, "change": f"{change_leaf} ({len(held)} "
                    f"of {len(moving)} leaves held)", "bn_stats_change": stats_leaf}
