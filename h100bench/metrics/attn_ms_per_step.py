"""attn_ms_per_step.<cell> (``attn_ms_per_step.dav2l``): the attention
kernels' device ms a traced train step (the kernel-name map of
``attn_roofline.py``); None where none ran."""
from harness.readers import traced
from harness.registry import BENCH_DIR, load_module

ATTENTION = load_module(BENCH_DIR / "metrics" / "attn_roofline.py").ATTENTION


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    ms = 1e3 * t.kernel_time_s(ATTENTION) / t.units
    return ms if ms > 0 else None
