"""k1_roofline.<serving cell kind> (``k1_roofline.live``): K1
(``ops.dense_conv``: BN fold + ReLU + 3x3 conv, one launch a dense layer
and its finish pass where split) against its roofline, in %: the sum over each traced forward's dense layers of the
least time the card could take (the larger of the conv's operations over
the bf16 tensor peak and its bytes over HBM's rate;
``harness.roofline.k1_counts``: x and the weights read once, y written
once), over K1's measured device time. The serving forward runs no
engine kernel (checked from the port's counters), so the function K1
shares with K4 is K1's here.

Kernel-name map (CUDA function names):
  K1  conv3x3_fwd_mma_kernel<TWL, VW, false>, conv3x3_fwd_finish_kernel
      (bf16), dense_conv_fwd_kernel (f32)
"""
from harness import roofline
from harness.readers import itemsize, layer_shapes, matcher, share_pct, traced

K1 = matcher([r"conv3x3_fwd_mma_kernel", r"conv3x3_fwd_finish_kernel",
              r"dense_conv_fwd_kernel"])


def forward_bound_s(ctx) -> float:
    """The least device time of one forward's K1 launches at the mix's batch."""
    b, f, size = ctx.traffic["batch"], ctx.config["growth_rate"], itemsize(ctx)
    counts = [roofline.k1_counts(b * h * w, c, f, size) for h, w, c in layer_shapes(ctx)]
    return roofline.sum_bounds_s(counts, ctx.config["dtype"])


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    forwards = t.units / ctx.traffic["batch"]
    return share_pct(forwards * forward_bound_s(ctx), t.kernel_time_s(K1))
