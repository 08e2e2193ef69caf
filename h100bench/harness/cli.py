"""One run of one cell: set up, measure, trace, check, print.

    python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics; the harness takes ``setup_s``
and ``peak_memory_gib`` itself, the driver's window the rest),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number ``correct`` compared, with its limit. The same numbers end standard error. Earlier lines say
what ran where: the card and its power limit, the host's CPU, versions,
the port's launch counts, the window's counts and statistics.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional

from . import env, registry, tracing

EXIT_NO_DEVICE = 3
EXIT_JAX_LOADED = 4


@dataclasses.dataclass
class Context:
    """What a driver and the metric readers share in one run."""
    cell: registry.Cell
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    device: "object"  # torch.device
    spans: tracing.Spans = dataclasses.field(default_factory=tracing.Spans)
    window: dict = dataclasses.field(default_factory=dict)
    trace: Optional[tracing.Trace] = None
    say: Callable[[str], None] = print


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="h100bench/run.py", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: registry.Benchmark, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t0: float, config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None, say=print) -> dict:
    """Set up, measure and check one cell on ``device``; return the result
    line's object (``checks`` last). ``*_override`` replace entries of the
    configuration or the mix (the CPU tests run a tiny one)."""
    import torch

    cell = bench.cell(cell_name)
    config = {**bench.config(cell.config), **(config_override or {})}
    traffic = {**bench.traffic(cell.traffic), **(traffic_override or {})}
    ctx = Context(cell, config, traffic, bench.limits(cell.name), seed, device, say=say)
    for line in env.info_lines(device):
        say(line)
    driver = bench.driver(traffic["driver"]).Driver(ctx)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    say(f"setup_s {setup_s:.4f}")
    ctx.window = driver.window(seconds)
    if trace:
        with tracing.traced(device, ctx.spans) as stretch:
            stretch["units"] = driver.traced_units()
        ctx.trace = stretch["trace"]
        with tracing.traced(device, ctx.spans, host_ops=True) as named:
            named["units"] = driver.traced_units()
        t, w = ctx.trace, ctx.window
        say(f"traced {t.units} units in {t.wall_s:.6f} s, {1e3 * t.wall_s / t.units:.4f} ms "
            f"a unit (the window: {1e3 * w['window_s'] / max(w['units'], 1):.4f}); "
            f"{len(t.device)} device ops, busy {t.busy_s:.6f} s; with the host's ops "
            f"recorded, {1e3 * named['trace'].wall_s / named['trace'].units:.4f} ms a unit")
    # the allocator's peak over set-up, the window and any traced stretch,
    # before the check's reference runs: ``peak_memory_gib`` and the
    # result's ``memory_peak_bytes``
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    say(f"memory peak {peak} bytes")
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check()

    if trace:
        metrics = {}
        for m in bench.per_layer_of(cell.name):
            value = bench.metric_reader(m.name).read(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        values = {**ctx.window["metrics"], "setup_s": setup_s,
                  "peak_memory_gib": peak / 2**30}
        metrics = {m.name: {"value": values[m.name], "unit": m.unit}
                   for m in bench.end_to_end_of(cell.name)}
    result = {
        "correct": all(c.ok for c in checks) and bool(checks),
        "attempted": ctx.window["attempted"],
        "failed": ctx.window["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": peak},
    }
    if trace:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.wall_s)
        result["breakdown"] = {"device_ops": ctx.trace.breakdown()["device_ops"],
                               "idle_gaps": named["trace"].breakdown()["idle_gaps"]}
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit}
                        for c in checks}
    return result


def _number(x: float) -> float:
    """A check's reading as a JSON number: NaN or infinite (a failed check)
    as 1e300."""
    return x if math.isfinite(x) else 1e300


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    env.set_cache_dirs()
    bench = registry.Benchmark.load()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_DEVICE
    result = run_cell(bench, cell.name, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0)
    found = env.forbidden_modules(list(sys.modules))
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return EXIT_JAX_LOADED
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
