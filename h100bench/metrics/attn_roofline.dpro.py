"""attn_roofline.dpro: Depth Pro's attention kernels against their
roofline, in %: each traced train step's 24 forward and 24 backward calls
of the patch encoder over 70 B sequences (every tile of the pair's two
frames at once) and 24 of each of the image encoder over 2 B, N = 577
tokens, 16 heads of 64, each bound by the larger of its operations over
the bf16 tensor peak and its bytes over HBM's rate
(``harness.roofline_depth_pro.step_attention_bound_s``, which counts as
``harness.roofline_attention.attention_counts``), over the kernels'
measured device time. ``attn_roofline.py`` bounds one sequence an image
and does not hold here. Kernel-name map: ``attn_roofline.py``'s
``ATTENTION``. None where no attention kernel ran."""
from harness import roofline_depth_pro
from harness.readers import itemsize, share_pct, traced, train_rows
from harness.registry import BENCH_DIR, load_module

ATTENTION = load_module(BENCH_DIR / "metrics" / "attn_roofline.py").ATTENTION


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    bound = roofline_depth_pro.step_attention_bound_s(ctx.config, train_rows(ctx), itemsize(ctx))
    return share_pct(t.units * bound, t.kernel_time_s(ATTENTION))
