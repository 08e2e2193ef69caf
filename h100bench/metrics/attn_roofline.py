"""attn_roofline.<cell> (``attn_roofline.dav2l``): the attention kernels of
a vision transformer's train step (``F.scaled_dot_product_attention`` in
``models.depth_anything``: cuDNN's or flash's fused kernels) against their
roofline, in %: each traced step's 24 forward and 24 backward calls at
2B images, each bound by the larger of its operations over the bf16
tensor peak and its bytes over HBM's rate
(``harness.roofline_attention.attention_counts``: 4 B H N^2 d forward,
10 B H N^2 d backward; Q, K, V, O, dO and the log-sum-exp read once, the
outputs written once), over the kernels' measured device time.

Kernel-name map (what the profiler names; ``ATTENTION``):
  cuDNN  cudnn_generated_fort_native_sdpa_* (forward and backward), the
         backward's cudnn::fusion::compute_dot_do_o_specialized and
         cudnn::fusion::convert_dq_to_16bits, and any name holding "sdpa"
         or "fmha"
  flash  flash_fwd_kernel, flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel,
         flash_bwd_dot_do_o_kernel, flash_bwd_convert_dq_kernel
None where no attention kernel ran (a program without the network).
"""
from harness import roofline_attention
from harness.readers import itemsize, matcher, share_pct, traced, train_rows

ATTENTION = matcher([r"flash_fwd", r"flash_bwd", r"fmha", r"sdpa", r"cudnn::fusion::compute_dot_do_o",
                     r"cudnn::fusion::convert_dq"])


def step_bound_s(ctx) -> float:
    t = ctx.traffic
    return roofline_attention.step_attention_bound_s(ctx.config, train_rows(ctx), t["height"],
                                                     t["width"], itemsize(ctx))


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    return share_pct(t.units * step_bound_s(ctx), t.kernel_time_s(ATTENTION))
