"""Driver ``train_step_dpt``: the port's ``training.train_step`` back to back
on a vision transformer with a DPT head (Depth Anything V2), on a pool of
synthetic batches staged on the device.

As the ``train_step`` driver, with what this network needs instead:

- weights from the seed for its kinds of tensors (``seeded_state_dict``
  below), the final 1x1 conv conditioned (x0.1, bias 3);
- the path check: no kernel of the port's own in the network (K1, K4-K6
  0), K2 and K3 once a step, and the attention counter
  (``models.depth_anything.LAUNCHES["attention"]``, read here beside
  ``harness/counters.launch_counts``) once a block;
- the check's reference runs each batch in chunks of pairs and adds the
  chunks' gradients, each weighted by its share of the pairs: the
  objective is a mean over the pairs' terms and no layer couples rows, so
  the sum is the whole batch's gradient, and a float32 attention of the
  whole batch would not fit the card;
- ``compare``: ``depth_rel``, the network's depth on the first batch
  before any step (the forward of ``training._forward_pair``, the step's
  own) against the reference's, and the ``train_step`` driver's
  ``first_update`` and ``change``. Not its ``loss`` nor its
  ``first_update_p90``: the conditioned depth is near 3 and varies by a
  few percent over a frame, so both move with the update of the head's
  last conv more than with the program's precision, and no control or
  planted fault reads above the program on every seed (PERF.md section
  2); nor its running statistics, which this network does not have.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from harness import counters, synthetic
from harness.compare import Check, worst_leaf_gap
from harness.registry import load_module, reference_model
from reference import objective as ref_objective

STEP_DRIVER = load_module(Path(__file__).resolve().parent / "train_step.py")
CHECK_STEPS = STEP_DRIVER.CHECK_STEPS
HEAD = "depth_head.scratch.output_conv2.2"  # the final 1x1 conv: depth = relu(its output)
CONV_GAIN = 0.75  # of Kaiming's std (seeded_state_dict)
_norms = STEP_DRIVER._norms


def attention_calls() -> int:
    """The port's count of its attention calls (0 where the port has none)."""
    try:
        from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything
    except ImportError:
        return 0
    return depth_anything.LAUNCHES["attention"]


def seeded_state_dict(skeleton: nn.Module, seed: int, device: torch.device,
                      conditioned: bool) -> Dict[str, torch.Tensor]:
    """Weights for ``skeleton``'s state_dict (names and shapes; it may live
    on the meta device), drawn on ``device`` from ``seed``, one draw per
    kind: convolutions and transposed convolutions normal with 3/4 of
    Kaiming's std (0.75 sqrt(2 / (input channels x kernel area))), Linear
    weights N(0, 0.02),
    zero biases, LayerNorm weight U[0.5, 1.5) and bias N(0, 0.02),
    LayerScale U[0.5, 1.5), the position embedding N(0, 0.02) and the class
    token N(0, 0.02). ``conditioned`` scales the final 1x1 conv by 0.1 and
    sets its bias to 3, so the depth is relu(3 + 0.1 conv), away from the
    objective's 1/z pole. At Kaiming's full std the DPT head's residual
    sums grow its activations to ~20 and the depth to 9.7 +- 3.4 with
    zeros at the ReLU; at 3/4 of it, 3.16 +- 0.13 and at least 2.51 (one
    518x644 frame's features N(0, 1), on the CPU)."""
    g = synthetic.generator(seed, device)
    mods = list(skeleton.named_modules())
    convs = [(n, m) for n, m in mods if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    linears = [(n, m) for n, m in mods if isinstance(m, nn.Linear)]
    norms = [(n, m) for n, m in mods if isinstance(m, nn.LayerNorm)]
    named = dict(skeleton.named_parameters())
    scales = [n for n in named if n.endswith(".gamma")]
    tokens = [n for n in named if n.endswith(("pos_embed", "cls_token"))]

    def draw(kind, count):
        return kind(count, generator=g, device=device)

    out: Dict[str, torch.Tensor] = {}
    z = draw(torch.randn, sum(m.weight.numel() for _, m in convs))
    off = 0
    for name, m in convs:
        w = m.weight
        fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]) \
            * w.shape[2] * w.shape[3]
        out[f"{name}.weight"] = (z[off:off + w.numel()] * CONV_GAIN * (2.0 / fan_in) ** 0.5
                                 ).view(w.shape)
        off += w.numel()
        if m.bias is not None:
            out[f"{name}.bias"] = torch.zeros(m.bias.shape, device=device)
    z = draw(torch.randn, sum(m.weight.numel() for _, m in linears)) * 0.02
    off = 0
    for name, m in linears:
        out[f"{name}.weight"] = z[off:off + m.weight.numel()].view(m.weight.shape)
        out[f"{name}.bias"] = torch.zeros(m.bias.shape, device=device)
        off += m.weight.numel()
    n_norm = sum(m.weight.numel() for _, m in norms)
    weight, bias = draw(torch.rand, n_norm) + 0.5, draw(torch.randn, n_norm) * 0.02
    off = 0
    for name, m in norms:
        n = m.weight.numel()
        out[f"{name}.weight"], out[f"{name}.bias"] = weight[off:off + n], bias[off:off + n]
        off += n
    z = draw(torch.rand, sum(named[n].numel() for n in scales)) + 0.5
    off = 0
    for name in scales:
        out[name] = z[off:off + named[name].numel()].view(named[name].shape)
        off += named[name].numel()
    for name in tokens:
        out[name] = draw(torch.randn, named[name].numel()).view(named[name].shape) * 0.02
    if conditioned:
        out[f"{HEAD}.weight"] = out[f"{HEAD}.weight"] * 0.1
        out[f"{HEAD}.bias"] = out[f"{HEAD}.bias"] * 0.1 + 3.0
    missing = set(skeleton.state_dict()) ^ set(out)
    if missing:
        raise KeyError(f"seeded weights and the skeleton disagree on {sorted(missing)}")
    return {k: v.contiguous() for k, v in out.items()}


def port_model(cfg: dict, dtype):
    """The port's network of the configuration: its named builder."""
    from endoscopydepthestimation_pytorch_tpu_torch import models
    return getattr(models, cfg["builder"])(n_classes=cfg["n_classes"], dtype=dtype)


def reference_depth(model, batch: Dict[str, torch.Tensor], quant, pairs: int
                    ) -> torch.Tensor:
    """The reference's depth of ``batch``'s frames, stacked as the step
    stacks them (frame 1's rows, then frame 2's), NHWC, in chunks of
    ``pairs`` pairs; on the CPU."""
    parts = {1: [], 2: []}
    with torch.no_grad():
        for a in range(0, batch["color_1"].shape[0], pairs):
            bound = batch["boundary"][a:a + pairs]
            for f in (1, 2):
                x = (batch[f"color_{f}"][a:a + pairs] * bound).permute(0, 3, 1, 2)
                parts[f].append(model(x, quant).permute(0, 2, 3, 1).cpu())
    return torch.cat(parts[1] + parts[2], 0)


def depth_gap(program: torch.Tensor, reference: torch.Tensor, boundary: torch.Tensor) -> float:
    """mean |program - reference| over the frames' boundary masks, over the
    mean |reference - its frame's masked mean| there: the gap as a share of
    how far the depth varies over a frame, not of its level near 3."""
    mask = torch.cat([boundary, boundary], 0).double()
    ref = reference.double()
    level = (ref * mask).sum((1, 2, 3), keepdim=True) / mask.sum((1, 2, 3), keepdim=True)
    spread = float(((ref - level).abs() * mask).sum())
    value = float(((program.double() - ref).abs() * mask).sum()) / spread
    return value if np.isfinite(value) else float("inf")


def chunked_train_steps(model, batches: List[Dict[str, torch.Tensor]], hyper: dict,
                        quant=None, pairs: int = 1) -> dict:
    """``reference.objective.train_steps`` with each batch's gradient summed
    over chunks of ``pairs`` pairs, each chunk's loss weighted by its share
    of the batch's pairs; the optimizer step is that function's."""
    params = dict(model.named_parameters())
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first_update, count = [], None, 0
    model.train()
    for batch in batches:
        rows = batch["color_1"].shape[0]
        value, grads = 0.0, None
        for a in range(0, rows, pairs):
            chunk = {k: v[a:a + pairs] for k, v in batch.items()}
            share = chunk["color_1"].shape[0] / rows
            part = share * ref_objective.loss(model, chunk, hyper["sfl_weight"],
                                              hyper["dcl_weight"],
                                              hyper["zero_division_epsilon"], quant)
            g = torch.autograd.grad(part, list(params.values()))
            grads = list(g) if grads is None else [s + t for s, t in zip(grads, g)]
            value = value + float(part.detach())
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            clip = hyper["grad_clip_norm"]
            factor = 1.0 if norm < clip else float(clip / norm)
            lr = ref_objective.cyclic_lr(count, hyper["min_lr"], hyper["max_lr"],
                                         hyper["lr_step_size"])
            for (n, p), g in zip(params.items(), grads):
                momentum[n] = g * factor + hyper["momentum"] * momentum[n]
                p -= lr * momentum[n]
        losses.append(value)
        count += 1
        if first_update is None:
            first_update = {n: m.detach().clone() for n, m in momentum.items()}
    return {"losses": losses, "first_update": first_update}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.dtype = getattr(torch, ctx.config["dtype"])
        self.dev = ctx.device

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        from endoscopydepthestimation_pytorch_tpu_torch import training

        t, cfg = self.traffic, self.ctx.config
        t0 = time.perf_counter()
        with torch.device("meta"):
            skeleton = reference_model(cfg)
            model = port_model(cfg, self.dtype)
        weights = seeded_state_dict(skeleton, self.ctx.seed, self.dev, conditioned=True)
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
            depth = torch.cat(training._forward_pair(model, self.pool[0]), 0)
        self.depth = depth.cpu()
        del depth
        t1 = time.perf_counter()
        before, calls = counters.launch_counts(), attention_calls()
        losses, first_update = [], None
        for _ in range(CHECK_STEPS):
            _, metrics = self._step()
            losses.append(metrics["loss"])
            if first_update is None:
                first_update = _norms(dict(zip(
                    (n for n, _ in model.named_parameters()), self.state.momentum)))
        per_step = counters.per_unit(before, counters.launch_counts(), CHECK_STEPS)
        per_step["attention"] = (attention_calls() - calls) / CHECK_STEPS
        t2 = time.perf_counter()
        self.ctx.say("launches per step (the port's counters): "
                     + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        self._check_path(per_step)
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        self.program = {
            "depth": self.depth,
            "losses": [float(v) for v in losses],
            "first_update": first_update,
            "change": _norms({n: now[n].double() - self.initial[n].double()
                              for n, _ in model.named_parameters()}),
        }
        self.ctx.say("program, steps 1-3: losses " + ", ".join(
            f"{v!r}" for v in self.program["losses"]))
        self.ctx.say(f"set-up: weights, model and batches {t1 - t0:.3f} s, the first "
                     f"{CHECK_STEPS} steps {t2 - t1:.3f} s, their readings "
                     f"{time.perf_counter() - t2:.3f} s")

    def _check_path(self, per_step: Dict[str, float]) -> None:
        """No kernel of the port's own in the network, one K2 and one K3 a
        step, and one attention call a block."""
        if self.dev.type != "cuda":
            return  # plain twins on the CPU count no launch
        counters.check_path(per_step, {"K1": 0, "K2": 1, "K3": 1, "K4": 0, "K5": 0, "K6": 0,
                                       "attention": self.ctx.config["depth"]},
                            "the train step")

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
        self.ctx.say(f"window: {steps} steps of batch {batch} in {elapsed:.6f} s, "
                     f"{1e3 * elapsed / steps:.4f} ms a step on average; "
                     f"{steps - finite} steps with a non-finite loss")
        return {"metrics": {"train_samples_per_s": steps * batch / elapsed},
                "attempted": steps, "failed": steps - finite, "units": steps,
                "window_s": elapsed}

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
        reference = self.reference_readings(quant=None)
        checks, leaves = compare(self.program, reference, self.ctx.limits)
        for c in checks:
            self.ctx.say(f"  {c.name}: program {c.value!r} (limit {c.limit!r}) "
                         f"{leaves.get(c.name, '')}")
        return checks

    def reference_readings(self, quant=None, rows=None) -> dict:
        """The reference's three steps from the initial weights, float32 with
        TF32 off, in chunks of ``check_pairs`` pairs; ``rows`` keeps only
        those rows of every batch (a planted fault)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = reference_model(self.ctx.config).to(self.dev)
        model.load_state_dict({k: v.to(self.dev) for k, v in self.initial.items()},
                              strict=True)
        depth = reference_depth(model, self.pool[0], quant, self.traffic["check_pairs"])
        batches = self.pool[:CHECK_STEPS]
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        out = chunked_train_steps(model, batches, self.hyper, quant,
                                  self.traffic["check_pairs"])
        now = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        readings = {
            "depth": depth,
            "boundary": self.pool[0]["boundary"].cpu(),
            "spacing": {n: float(np.linalg.norm(np.spacing(self.initial[n].numpy())))
                        for n, _ in model.named_parameters()},
            "losses": out["losses"],
            "first_update": _norms(out["first_update"]),
            "change": _norms({n: now[n].double() - self.initial[n].double()
                              for n, _ in model.named_parameters()}),
        }
        del model, out
        return readings


def compare(program: dict, reference: dict, limits: Dict[str, float]):
    """``depth_rel`` (``depth_gap`` of the first batch's depth before any
    step), and ``first_update`` and ``change`` as the ``train_step``
    driver's ``compare`` defines them, over this network's parameters; and
    the leaf each worst one was read at."""
    grads = reference["first_update"]
    median = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= STEP_DRIVER.ZERO_GRADIENT * median]
    first, first_leaf = worst_leaf_gap(program["first_update"], grads, moving)
    held = [n for n in moving
            if reference["change"][n] >= STEP_DRIVER.REPRESENTABLE * reference["spacing"][n]]
    change, change_leaf = worst_leaf_gap(program["change"], reference["change"], held)
    depth = depth_gap(program["depth"], reference["depth"], reference["boundary"])
    checks = [Check("depth_rel", depth, limits["depth_rel"]),
              Check("first_update", first, limits["first_update"]),
              Check("change", change, limits["change"])]
    return checks, {"first_update": first_leaf,
                    "change": f"{change_leaf} ({len(held)} of {len(moving)} leaves held)"}


def calibrate(ctx, control: bool, emit) -> dict:
    """Readings for the limits (``calibrate_by_driver.py``): the program's
    against the reference; with ``control`` also the reference with Q, K,
    V and every other matmul and convolution input in float8 e4m3, half
    the batch left out, and a state left unchanged."""
    from reference.fcdensenet import fp8_round

    drv = Driver(ctx)
    drv.setup()
    program = drv.program
    drv.release()
    _free(ctx.device)
    ref = drv.reference_readings()
    raw = {"reference": ref, "program": program}
    if control:
        raw["control_fp8_reference"] = drv.reference_readings(quant=fp8_round)
        raw["fault_half_batch"] = drv.reference_readings(
            rows=slice(0, ctx.traffic["batch"] // 2))
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


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
