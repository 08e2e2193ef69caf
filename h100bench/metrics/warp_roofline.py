"""warp_roofline: the depth warp's sampler kernels (K2 forward, K3
backward: ``ops.warp_sample``) against their roofline, in %: per traced
step one K2 and one K3 call over the stacked 2B x H x W queries of a
2-channel f32 image (``harness.roofline.warp_counts``), each bound by the
larger of its operations over the f32 FFMA peak and its bytes over HBM's
rate, over the kernels' measured device time. K3's memset of its scratch
(one of its four device operations, ~1 us) is not in the measured time:
memsets carry no kernel name to tell them apart.

Kernel-name map (CUDA function names):
  K2  warp_sample_fwd_kernel
  K3  max_grad_kernel, warp_sample_bwd_kernel, dimg_kernel
"""
from harness import roofline
from harness.readers import matcher, share_pct, traced, train_rows

WARP = matcher([r"warp_sample_fwd_kernel", r"max_grad_kernel", r"warp_sample_bwd_kernel",
                r"\bdimg_kernel"])


def step_bound_s(ctx) -> float:
    t = ctx.traffic
    queries = train_rows(ctx) * t["height"] * t["width"]
    return roofline.sum_bounds_s(roofline.warp_counts(queries).values(), "float32")


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    return share_pct(t.units * step_bound_s(ctx), t.kernel_time_s(WARP))
