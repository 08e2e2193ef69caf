"""Readings that set the limits of ``correct`` (the benchmark's own runs do
not run this).

    python3 h100bench/calibrate.py --workload CELL --seeds 11 12 ... \
        [--control-seeds 3] [--seconds 2]

For every seed, in one process, the cell's program runs as in a
benchmark run (its set-up, and for a serving cell a short window of
``--seconds`` that covers the frame pool) and its numbers are compared
with the float32 reference: the lower readings. On the first
``--control-seeds`` seeds it also reads:

- the control: the reference itself in the program's place, with every
  stored activation rounded to float8 e4m3, the precision below the
  configuration's bfloat16;
- for a train cell, the program's own e4m3 path (``act8``: the dense
  blocks, transitions and head keep e4m3 copies for the backward), and
  the planted fault of half the batch left out (the reference on the
  first half of every batch, the mean over those rows);
- a state left unchanged reads 1 by the per-leaf measure and needs no run.

Each line printed is one JSON object: {cell, seed, side, checks}.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import env, registry  # noqa: E402
from harness.cli import Context  # noqa: E402
from harness.compare import masked_rel  # noqa: E402
from reference.fcdensenet import fp8_round  # noqa: E402
from reference.serving import boundary  # noqa: E402


def emit(cell, seed, side, values, out):
    line = json.dumps({"cell": cell, "seed": seed, "side": side, "checks": values})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_readings(ctx, control: bool, out):
    drv_mod = registry.load_module(HERE / "drivers" / "train_step.py")
    drv = drv_mod.Driver(ctx)
    drv.setup()
    program = drv.program
    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = drv.reference_readings()

    raw = {"reference": ref, "program": program}

    def values(side):
        checks, leaves = drv_mod.compare(side, ref, ctx.limits)
        return {**{c.name: c.value for c in checks}, "leaves": leaves}

    emit(ctx.cell.name, ctx.seed, "program", values(program), out)
    if control:
        raw["control_fp8_reference"] = drv.reference_readings(quant=fp8_round)
        half = ctx.traffic["batch"] // 2
        raw["fault_half_batch"] = drv.reference_readings(rows=slice(0, half))
        # the program's own e4m3 store, in the program's place
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        act8 = drv_mod.Driver(Context(ctx.cell, {**ctx.config, "port_flags": {"act8": True}},
                                      ctx.traffic, ctx.limits, ctx.seed, ctx.device,
                                      say=ctx.say))
        act8.setup()
        raw["control_program_act8"] = act8.program
        act8.release()
        del act8
        gc.collect()
        torch.cuda.empty_cache()
        for side in ("control_fp8_reference", "fault_half_batch", "control_program_act8"):
            emit(ctx.cell.name, ctx.seed, side, values(raw[side]), out)
    if out:  # every per-leaf reading, for limits worked out afterwards
        with open(f"{out}.seed{ctx.seed}.json", "w") as f:
            json.dump(raw, f)


def serving_readings(ctx, kind: str, seconds: float, control: bool, out):
    drv = registry.load_module(HERE / "drivers" / f"{kind}.py").Driver(ctx)
    drv.setup()
    drv.window(seconds)
    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    checks = drv.check()
    emit(ctx.cell.name, ctx.seed, "program", {**{c.name: c.value for c in checks},
                                              "per_frame": drv.serving.gaps}, out)
    if not control:
        return
    serving = drv.serving
    keys = sorted(drv.answers.first)
    ref = serving.reference_depths(keys)
    low = serving.reference_depths(keys, quant=fp8_round)
    mask = boundary(serving.sequence.mask_boundary)
    per_frame = [masked_rel(low[k], ref[k], mask) for k in keys]
    emit(ctx.cell.name, ctx.seed, "control_fp8_reference",
         {"depth_rel": max(per_frame), "per_frame": per_frame}, out)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args()
    env.set_cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate.py needs the card", file=sys.stderr)
        return 3
    bench = registry.Benchmark.load()
    cell = bench.cell(args.workload)
    device = torch.device("cuda", 0)
    for line in env.info_lines(device):
        print(line, file=sys.stderr)
    for i, seed in enumerate(args.seeds):
        ctx = Context(cell, bench.config(cell.config), bench.traffic(cell.traffic),
                      bench.limits(cell.name), seed, device,
                      say=lambda s: print(s, file=sys.stderr))
        kind = ctx.traffic["driver"]
        control = i < args.control_seeds
        if kind == "train_step":
            train_readings(ctx, control, args.out)
        else:
            serving_readings(ctx, kind, args.seconds, control, args.out)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"calibrate.py done in {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
