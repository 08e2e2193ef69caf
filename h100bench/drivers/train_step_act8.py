"""Driver ``train_step_act8``: the ``train_step`` driver with the builder's
``act8=True`` (as ``calibrate.py`` builds its act8 control): every dense
block keeps a float8 e4m3 copy for its backward and replays from it
(``ops/act8.ReplayBlock``, per ``act8.BWD_MODE``), the transitions and
the final conv through ``act8.compressed_call``.

What differs from ``train_step``:

- the path check: one K4 a dense layer for the forward and, with
  ``BWD_MODE`` ``"replay"``, one more for the backward's replay; one K5
  and one K6 a layer, one K2 and one K3, no K1. Set-up says which store
  ran;
- ``compare`` reads only the numbers this cell's limits file holds: the
  57 train cell's limits take the act8 program as a control that must
  fail, so this cell's were set anew from the act8 program's own readings
  against the planted faults (``calibrate``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from harness.compare import Check
from harness.registry import load_module

STEP = load_module(Path(__file__).resolve().parent / "train_step.py")
CHECK_STEPS = STEP.CHECK_STEPS


def compare(program: dict, reference: dict, limits: Dict[str, float]):
    """``train_step.compare``'s numbers, those that ``limits`` names."""
    every = {"loss", "first_update", "first_update_p90", "change", "bn_stats_change"}
    checks, leaves = STEP.compare(program, reference,
                                  {k: limits.get(k, float("inf")) for k in every})
    return [c for c in checks if c.name in limits], leaves


class Driver(STEP.Driver):
    def __init__(self, ctx):
        ctx.config = {**ctx.config, "port_flags": {"act8": True}}
        super().__init__(ctx)

    def setup(self) -> None:
        from endoscopydepthestimation_pytorch_tpu_torch.ops import act8
        self.ctx.say(f"act8 backward store: act8.BWD_MODE {act8.BWD_MODE!r}")
        super().setup()

    def _check_path(self, per_step: Dict[str, float]) -> None:
        from endoscopydepthestimation_pytorch_tpu_torch.ops import act8

        from harness import counters
        from harness.roofline import dense_layer_shapes
        if self.dev.type != "cuda":
            return  # plain twins on the CPU count no launch
        layers = len(dense_layer_shapes(self.ctx.config, 8, 8))
        replays = 1 if act8.BWD_MODE == "replay" else 0
        counters.check_path(per_step, {"K1": 0, "K2": 1, "K3": 1, "K4": layers * (1 + replays),
                                       "K5": layers, "K6": layers}, "the act8 train step")

    def check(self) -> List[Check]:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        checks, leaves = compare(self.program, self.reference_readings(), self.ctx.limits)
        for c in checks:
            self.ctx.say(f"  {c.name}: program {c.value!r} (limit {c.limit!r}) "
                         f"{leaves.get(c.name, '')}")
        return checks


def calibrate(ctx, control: bool, emit) -> dict:
    """Readings for the limits (``calibrate_by_driver.py``): the act8
    program's every number against the float32 reference; with
    ``control`` also the reference in float8 e4m3, half the batch left out,
    and a state left unchanged."""
    import gc

    import torch
    from reference.fcdensenet import fp8_round

    drv = Driver(ctx)
    drv.setup()
    program = drv.program
    drv.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = drv.reference_readings()
    raw = {"reference": ref, "program": program}
    if control:
        raw["control_fp8_reference"] = drv.reference_readings(quant=fp8_round)
        raw["fault_half_batch"] = drv.reference_readings(
            rows=slice(0, ctx.traffic["batch"] // 2))
        raw["fault_state_unchanged"] = {
            **program, "change": {n: 0.0 for n in ref["change"]},
            "stats_change": {n: 0.0 for n in ref["stats_change"]}}
    every = {k: float("inf") for k in ("loss", "first_update", "first_update_p90", "change",
                                       "bn_stats_change")}
    for side, readings in raw.items():
        if side != "reference":
            checks, leaves = compare(readings, ref, every)
            emit(side, {**{c.name: c.value for c in checks}, "leaves": leaves})
    return raw
