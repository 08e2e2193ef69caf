"""The host cost of the port's spans (``utils.profiling``): a ``span`` and
a ``root_span`` entered and left with ``torch.profiler`` off, and on
(recording the host's ops, or, with a card, the device's activity alone
as the benchmark's traced stretch does). Prints one line of microseconds
a call, the best of five rounds.

    python3 torch_span_cost.py [--calls 20000]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling


def _us(fn, calls: int) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / calls


def _span():
    with profiling.span("engine_fwd"):
        pass


def _root():
    with profiling.root_span("train_step"):
        pass


def _span_in_root(calls: int) -> float:
    """A span's cost inside an open root (the switch on when the profiler
    is); the root's own entry is left out."""
    with profiling.root_span("train_step"):
        return _us(_span, calls)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--calls", type=int, default=20000)
    calls = p.parse_args().calls
    out = {"torch": torch.__version__,
           "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "off": {"span_us": _span_in_root(calls), "root_span_us": _us(_root, calls)}}
    modes = {"on_host_ops": [ProfilerActivity.CPU]}
    if torch.cuda.is_available():
        modes["on_device_only"] = [ProfilerActivity.CUDA]
    for mode, activities in modes.items():
        with profile(activities=activities):
            # few calls: each recorded range is an event the profiler keeps
            out[mode] = {"span_us": _span_in_root(calls // 10),
                         "root_span_us": _us(_root, calls // 10)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
