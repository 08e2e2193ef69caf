"""Driver ``trainer_cli``: the port's trainer, ``train.main``, called whole
in the window, on a synthetic SfM data root written at set-up.

Set-up writes the mix's sequences (``harness/sfm_sequence.py``, a frozen
copy of the tests' writer; the points and frames drawn from the seed),
and a reference-format ``.pt`` of the configuration's network with
weights from the seed, the head conditioned (x0.1, bias 3), which every
call resumes from (``--load_trained_model``: epoch 0, zero momentum).
Then three calls of ``train.main`` for one epoch each:

- the check's: ``check_steps`` steps, every step's loss read back
  (``--log_interval 1``); it also runs the precompute, whose pickle the
  later calls load (``--load_intermediate_data``);
- the timing's: ``time_steps`` steps; the window's epoch takes as many
  steps as fit ``--seconds`` at that call's pace, its fixed costs
  counted as steps;
- the window: that epoch, timed whole: the loader's threads, a board
  every ``display_interval`` steps, validation at the epoch's end and the
  checkpoint. ``trainer_samples_per_s`` is its samples over its time.

A traced unit is a step of a ``trace_steps``-step call.

The check rebuilds the check call's three batches and the validation
batches from the trainer's ``SEED`` (its datasets, augmentation and
loaders, as ``train.py`` makes them) and runs the plain reference
(``reference/``) in float32 on them. From the check call's weights, with
the trainer's epoch-0 objective (DCL weight 0.1) and schedule (half cycle
``num_iter``), it compares the three losses, the parameters' change (the
worst leaf, less the leaves ``compare`` names) and the running
statistics' change. From the window's own checkpoint, it compares the
window's validation SFL, which the checkpoint records, with the
reference's over the same validation batches and weights.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from harness import synthetic
from harness.compare import Check, worst_leaf_gap
from harness.env import CACHE_DIR
from harness.registry import BENCH_DIR, load_module, reference_model
from harness.sfm_sequence import write_sequence
from reference import objective as ref_objective

STEP_DRIVER = load_module(BENCH_DIR / "drivers" / "train_step.py")
_norms = STEP_DRIVER._norms


def _trainer():
    from endoscopydepthestimation_pytorch_tpu_torch import train
    return train


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.dev = ctx.device
        self.calls = 0

    # -- the trainer's command line -------------------------------------------

    def argv(self, steps: int, *extra: str) -> List[str]:
        t = self.traffic
        self.calls += 1
        return ["--adjacent_range", *map(str, t["adjacent_range"]), "--id_range", "1", "2",
                "--input_size", str(t["height"]), str(t["width"]),
                "--batch_size", str(t["batch"]), "--num_iter", str(t["batch"] * steps),
                "--number_epoch", "0", "--display_interval", str(t["display_interval"]),
                "--validation_interval", "1", "--num_workers", str(t["num_workers"]),
                "--num_pre_workers", str(t["num_pre_workers"]),
                "--training_patient_id", "1", "--testing_patient_id", "1",
                "--validation_patient_id", "1", "--load_intermediate_data",
                "--load_trained_model", "--trained_model_path", str(self.start),
                "--compute_dtype", self.ctx.config["dtype"],
                "--architecture", self.ctx.config["name"],
                "--training_data_root", str(self.data),
                "--training_result_root", str(self.root / f"run{self.calls}"),
                "--device", self.dev.type, *extra]

    def _main(self, argv: List[str]):
        with contextlib.redirect_stdout(sys.stderr):  # the result line stays last
            return _trainer().main(argv)

    # -- set-up ------------------------------------------------------------------

    def setup(self) -> None:
        t, cfg = self.traffic, self.ctx.config
        base = Path(t.get("root") or CACHE_DIR)
        base.mkdir(parents=True, exist_ok=True)
        self.root = Path(tempfile.mkdtemp(prefix="trainer-", dir=base))
        t0 = time.perf_counter()
        self.data = self.root / "data"
        for segment in range(1, t["sequences"] + 1):
            write_sequence(self.data, seed=(self.ctx.seed + 20 + segment) % 2**32,
                           n_frames=t["frames"], height=t["raw_height"],
                           width=t["raw_width"], n_points=t["points"], segment=segment,
                           first_frame=100 * segment)
        with torch.device("meta"):
            skeleton = reference_model(cfg)
        weights = synthetic.seeded_state_dict(skeleton, self.ctx.seed, self.dev,
                                              conditioned=True)
        self.initial = {k: v.detach().cpu().clone() for k, v in weights.items()}
        self.start = self.root / "start.pt"
        torch.save({"model": {f"module.{k}": v for k, v in self.initial.items()},
                    "optimizer": {"state": {}, "param_groups": []},
                    "epoch": 0, "step": 0, "validation": 0.0}, str(self.start))
        del weights
        t1 = time.perf_counter()
        steps = t["check_steps"]
        self.check_argv = self.argv(steps, "--log_interval", "1")
        self.program = self.check_call()
        t2 = time.perf_counter()
        self._sync()
        run = self._main(self.argv(t["time_steps"]))
        self._sync()
        t3 = time.perf_counter()
        del run
        self.step_s = (t3 - t2) / t["time_steps"]  # the call's fixed costs counted as steps
        self.ctx.say("program, steps 1-3: losses " + ", ".join(
            f"{v!r}" for v in self.program["losses"]))
        self.ctx.say(f"set-up: data root and weights {t1 - t0:.3f} s, the check's "
                     f"{steps}-step call {t2 - t1:.3f} s (the precompute in it), the "
                     f"timing's {t['time_steps']}-step call {t3 - t2:.3f} s")

    def check_call(self, *extra: str) -> dict:
        """The check's call of ``train.main`` (``extra`` appended to its
        arguments) and what the check reads of it."""
        run = self._main([*self.check_argv, *extra])
        now = {k: v.detach().cpu() for k, v in run.state.model.state_dict().items()}
        names = [n for n, _ in run.state.model.named_parameters()]
        readings = {
            "losses": [float(v) for v in run.losses],
            "change": _norms({n: now[n].double() - self.initial[n].double() for n in names}),
            "stats_change": _norms({n: now[n].double() - self.initial[n].double()
                                    for n in now if "running_" in n}),
        }
        del run, now
        return readings

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window --------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        steps, batch = max(2, int(seconds / self.step_s)), self.traffic["batch"]
        self._sync()
        t0 = time.perf_counter()
        run = self._main(self.argv(steps))
        self._sync()
        elapsed = time.perf_counter() - t0
        finite = int(run.state.step)
        losses = np.asarray(run.losses, dtype=np.float64)
        self.window_checkpoint = run.checkpoints[-1]
        self.ctx.say(f"window: train.main, {steps} steps of batch {batch}, validation and "
                     f"a checkpoint in {elapsed:.6f} s, {1e3 * elapsed / steps:.4f} ms a "
                     f"step on average; {steps - finite} steps with a non-finite loss; "
                     f"losses read back {len(losses)}, last {losses[-1]!r}")
        return {"metrics": {"trainer_samples_per_s": steps * batch / elapsed},
                "attempted": steps, "failed": steps - finite, "units": steps,
                "window_s": elapsed}

    def traced_units(self) -> int:
        n = self.traffic["trace_steps"]
        self._main(self.argv(n))
        return n

    def release(self) -> None:
        gc.collect()

    # -- the check ----------------------------------------------------------------

    def loaders(self):
        """The check call's train loader and the validation loader, rebuilt
        from the trainer's ``SEED``: its datasets, augmentation and loaders
        as ``train.py`` makes them for epoch 0 of one process."""
        from endoscopydepthestimation_pytorch_tpu_torch.data import readers
        from endoscopydepthestimation_pytorch_tpu_torch.data.augment import (
            TrainingAugmentation)
        from endoscopydepthestimation_pytorch_tpu_torch.data.dataset import (BatchLoader,
                                                                             SfMDataset)
        train = _trainer()
        args = train.build_parser().parse_args(self.check_argv)
        np.random.seed(train.SEED)
        random.seed(train.SEED)
        root = Path(args.training_data_root)
        train_files, val_files, _ = readers.get_color_file_names_by_bag(
            root, args.training_patient_id, args.validation_patient_id,
            args.testing_patient_id)
        common = dict(folder_list=readers.get_parent_folder_names(root, args.id_range),
                      adjacent_range=args.adjacent_range,
                      downsampling=args.input_downsampling,
                      network_downsampling=args.network_downsampling,
                      inlier_percentage=args.inlier_percentage,
                      visible_interval=args.visibility_overlap, store_data_root=root,
                      is_hsv=args.use_hsv_colorspace, num_pre_workers=args.num_pre_workers,
                      rgb_mode=args.rgb_mode)
        dataset = SfMDataset(image_file_names=train_files,
                             transform=TrainingAugmentation(seed=train.SEED),
                             use_store_data=True, phase="train", num_iter=args.num_iter,
                             **common)
        val_dataset = SfMDataset(image_file_names=val_files, transform=None,
                                 use_store_data=True, phase="validation", **common)
        dataset.seed(train.SEED + 1)  # epoch 0
        loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                             num_workers=args.num_workers, seed=train.SEED,
                             process_index=0, process_count=1)
        loader.set_epoch(0)
        val_loader = BatchLoader(val_dataset, args.batch_size, shuffle=False,
                                 num_workers=args.num_workers, seed=train.SEED,
                                 drop_last=True, process_index=0, process_count=1)
        return loader, val_loader

    def batches(self) -> List[Dict[str, torch.Tensor]]:
        """The check call's batches."""
        from endoscopydepthestimation_pytorch_tpu_torch.parallel import to_device
        loader, _ = self.loaders()
        steps = self.traffic["check_steps"]
        return [to_device(b, self.dev) for b in itertools.islice(loader, steps)]

    def validation_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The validation batches of every call (the window's among them)."""
        from endoscopydepthestimation_pytorch_tpu_torch.parallel import to_device
        _, val_loader = self.loaders()
        return [to_device(b, self.dev) for b in val_loader]

    def hyper(self) -> dict:
        return {**self.traffic["hyper"], "lr_step_size": self.traffic["batch"]
                * self.traffic["check_steps"]}

    def read_back(self) -> None:
        """What the check needs from the data root and the window's
        checkpoint, before the root is removed: the check call's and the
        validation batches, the window's weights and its validation SFL."""
        self.check_batches = self.batches()
        self.val_batches = self.validation_batches()
        saved = torch.load(str(self.window_checkpoint), map_location="cpu",
                           weights_only=True)
        self.window_weights = {k.removeprefix("module."): v
                               for k, v in saved["model"].items()}
        self.program["validation_sfl"] = float(saved["validation"])
        shutil.rmtree(self.root, ignore_errors=True)

    def check(self) -> List[Check]:
        self.read_back()
        reference = self.reference_readings(quant=None)
        checks, leaves = compare(self.program, reference, self.ctx.limits,
                                 rounding_unit(self.ctx.config))
        for c in checks:
            self.ctx.say(f"  {c.name}: program {c.value!r} (limit {c.limit!r}) "
                         f"{leaves.get(c.name, '')}")
        return checks

    def _reference(self, weights: Dict[str, torch.Tensor]):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = reference_model(self.ctx.config).to(self.dev)
        model.load_state_dict({k: v.to(self.dev) for k, v in weights.items()}, strict=True)
        return model

    def reference_validation(self, weights: Dict[str, torch.Tensor], quant=None, rows=None,
                             running_stats: bool = False) -> float:
        """The mean over the validation batches of the reference's SFL
        (weighted, as the trainer records it) with ``weights``, the
        BatchNorms on the batch's statistics, as the trainer's validation
        runs them (``running_stats``: on the weights' running statistics,
        a planted fault); ``rows`` keeps only those rows of every batch."""
        model = self._reference(weights)
        model.train(not running_stats)
        h = self.traffic["hyper"]
        values = []
        with torch.no_grad():
            for b in self.val_batches:
                if rows is not None:
                    b = {k: v[rows] for k, v in b.items()}
                values.append(float(ref_objective.loss(
                    model, b, h["sfl_weight"], 0.0, h["zero_division_epsilon"], quant)))
        del model
        return float(np.mean(values))

    def reference_readings(self, quant=None, rows=None) -> dict:
        """The reference's steps on the rebuilt batches from the initial
        weights, and its validation SFL with the window's weights; float32
        with TF32 off; ``rows`` keeps only those rows of every batch (a
        planted fault)."""
        model = self._reference(self.initial)
        batches = self.check_batches
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        out = ref_objective.train_steps(model, batches, self.hyper(), quant)
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
        readings["validation_sfl"] = self.reference_validation(self.window_weights, quant,
                                                               rows)
        readings["cancellation"] = self.cancellation(batches[0])
        return readings

    def cancellation(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Per convolution bias, the condition number of the sum that makes
        its gradient on ``batch`` from the initial weights: ||sum |g|||
        over ||sum g||, the sums per channel over the rows and pixels of
        the convolution's output gradient g, the norms over the channels.
        A bias that feeds a train-mode BatchNorm gets large terms from it
        that cancel exactly; in a lower precision their rounding does not
        (``compare`` leaves such biases out)."""
        model = self._reference(self.initial)
        model.train()
        sums: Dict[str, tuple] = {}

        def hook(name):
            def on_grad(g):
                sums[name] = (g.abs().sum((0, 2, 3)).double(), g.sum((0, 2, 3)).double())

            def on_output(module, inputs, out):
                out.register_hook(on_grad)
            return on_output

        handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
                   if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m.bias is not None]
        h = self.hyper()
        value = ref_objective.loss(model, batch, h["sfl_weight"], h["dcl_weight"],
                                   h["zero_division_epsilon"])
        torch.autograd.grad(value, list(model.parameters()))
        for handle in handles:
            handle.remove()
        del model
        return {f"{n}.bias": float(a.norm() / s.norm()) for n, (a, s) in sums.items()}


def compare(program: dict, reference: dict, limits: Dict[str, float], unit: float):
    """``loss`` and ``bn_stats_change`` as the ``train_step`` driver's
    ``compare`` defines them; ``change``: the worst leaf's gap in its
    change over the steps, over the leaves whose change float32 holds (as
    that driver's ``change`` takes them), less the biases whose gradient's
    sum the program's rounding (``unit``, half its type's epsilon) can
    move by its own size: those whose ``cancellation`` times ``unit`` is 1
    or more; and ``validation_sfl``: the window's validation SFL against
    the reference's, relative. A trainer call shows no first update.
    Returns the checks and the leaf each worst reading was taken at."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    ok = len(losses) == len(reference["losses"]) and all(np.isfinite(losses))
    loss_gap = max(losses) if ok else float("inf")
    grads = reference["first_update"]
    median = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= STEP_DRIVER.ZERO_GRADIENT * median]
    held = [n for n in moving
            if reference["change"][n] >= STEP_DRIVER.REPRESENTABLE * reference["spacing"][n]]
    kept = [n for n in held if unit * reference["cancellation"].get(n, 0.0) < 1.0]
    change, change_leaf = worst_leaf_gap(program["change"], reference["change"], kept)
    stats, stats_leaf = worst_leaf_gap(program["stats_change"], reference["stats_change"])
    val = abs(program["validation_sfl"] - reference["validation_sfl"]) \
        / abs(reference["validation_sfl"])
    checks = [Check("loss", loss_gap, limits["loss"]),
              Check("change", change, limits["change"]),
              Check("bn_stats_change", stats, limits["bn_stats_change"]),
              Check("validation_sfl", val if np.isfinite(val) else float("inf"),
                    limits["validation_sfl"])]
    return checks, {"change": f"{change_leaf} ({len(kept)} of {len(moving)} leaves: "
                              f"{len(held) - len(kept)} cancelling biases left out)",
                    "bn_stats_change": stats_leaf}


def rounding_unit(config: dict) -> float:
    """Half the epsilon of the configuration's activation type."""
    return torch.finfo(getattr(torch, config["dtype"])).eps / 2


CALIBRATION_WINDOW_S = 4.0  # a window's call of ~10 steps: its checkpoint and validation


def calibrate(ctx, control: bool, emit) -> dict:
    """Readings for the limits (``calibrate_by_driver.py``): the program's
    against the reference, a short window's call giving the checkpoint;
    with ``control`` also the check's call in float32 (the program at the
    reference's precision: what rounding leaves of each gap), the
    reference with every stored activation in float8 e4m3, half the batch
    left out, a state left unchanged, and the validation on the running
    statistics."""
    from reference.fcdensenet import fp8_round

    drv = Driver(ctx)
    drv.setup()
    drv.window(CALIBRATION_WINDOW_S)
    program_f32 = drv.check_call("--compute_dtype", "float32") if control else None
    drv.release()
    drv.read_back()
    ref = drv.reference_readings()
    raw = {"reference": ref, "program": drv.program}
    if control:
        raw["program_float32"] = {**program_f32,
                                  "validation_sfl": drv.program["validation_sfl"]}
        raw["control_fp8_reference"] = drv.reference_readings(quant=fp8_round)
        raw["fault_half_batch"] = drv.reference_readings(
            rows=slice(0, ctx.traffic["batch"] // 2))
        raw["fault_state_unchanged"] = {
            "losses": drv.program["losses"],
            "change": {n: 0.0 for n in ref["change"]},
            "stats_change": {n: 0.0 for n in ref["stats_change"]},
            "validation_sfl": drv.reference_validation(drv.initial)}
        raw["fault_validation_running_stats"] = {
            **drv.program,
            "validation_sfl": drv.reference_validation(drv.window_weights,
                                                       running_stats=True)}
    for side, readings in raw.items():
        if side != "reference":
            checks, leaves = compare(readings, ref, ctx.limits, rounding_unit(ctx.config))
            emit(side, {**{c.name: c.value for c in checks}, "leaves": leaves})
    return raw

