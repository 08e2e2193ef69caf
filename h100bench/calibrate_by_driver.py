"""Readings that set the limits of ``correct`` for cells whose driver
module has a ``calibrate(ctx, control, emit)`` function (``train_step_dpt``,
``trainer_cli``); ``calibrate.py`` knows the drivers that came before
them. The benchmark's own runs do not run this.

    python3 h100bench/calibrate_by_driver.py --workload CELL --seeds 11 12 ... \
        [--control-seeds 3] [--out FILE]

For every seed, in one process, the driver's set-up runs the program as
a benchmark run does and its numbers are compared with the float32
reference: the lower readings. On the first ``--control-seeds`` seeds
the driver also reads the control (the reference in float8 e4m3, the
precision below the configuration's bfloat16) and its planted faults.
Each line printed is one JSON object: {cell, seed, side, checks}; with
``--out`` every raw per-leaf reading also goes to ``FILE.seed<n>.json``.
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


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    env.set_cache_dirs()
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate_by_driver.py needs the card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    bench = registry.Benchmark.load()
    cell = bench.cell(args.workload)
    for line in env.info_lines(device):
        print(line, file=sys.stderr)
    for i, seed in enumerate(args.seeds):
        ctx = Context(cell, bench.config(cell.config), bench.traffic(cell.traffic),
                      bench.limits(cell.name), seed, device,
                      say=lambda s: print(s, file=sys.stderr))

        def emit(side, values, seed=seed):
            line = json.dumps({"cell": cell.name, "seed": seed, "side": side,
                               "checks": values})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")

        raw = bench.driver(ctx.traffic["driver"]).calibrate(ctx, i < args.control_seeds, emit)
        if args.out:
            with open(f"{args.out}.seed{seed}.json", "w") as f:
                json.dump(raw, f)
        del raw
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"calibrate_by_driver.py done in {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
