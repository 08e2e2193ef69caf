"""attn_roofline.vggt: VGGT's attention kernels against their roofline, in
%: each traced train step's forward and backward calls of the 24 DINOv2
blocks and the 24 frame blocks over 2B frames (1,115 tokens each at
420x518) and of the 24 global blocks over B sequences of both frames
(2,230 tokens), 16 heads of 64, each bound by the larger of its
operations over the bf16 tensor peak and its bytes over HBM's rate
(``harness.roofline_vggt.step_attention_bound_s``, which counts as
``harness.roofline_attention.attention_counts``), over the kernels'
measured device time. ``attn_roofline.py`` bounds one sequence a frame
and does not hold here. Kernel-name map: ``attn_roofline.py``'s
``ATTENTION``. None where no attention kernel ran."""
from harness import roofline_vggt
from harness.readers import itemsize, share_pct, traced
from harness.registry import BENCH_DIR, load_module

ATTENTION = load_module(BENCH_DIR / "metrics" / "attn_roofline.py").ATTENTION


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    tr = ctx.traffic
    bound = roofline_vggt.step_attention_bound_s(ctx.config, tr["batch"], tr["height"],
                                                 tr["width"], itemsize(ctx))
    return share_pct(t.units * bound, t.kernel_time_s(ATTENTION))
