"""torch_ops_ms_per_step.train: device time per traced train step of the
kernels that are not the port's own (K1-K6): PyTorch's elementwise and
reduction kernels and cuDNN's convolutions of the transitions, the head
and the losses' and optimizer's passes. Memsets and copies are left out.

Kernel-name map of the port's kernels (CUDA function names):
  K1, K4  conv3x3_fwd_mma_kernel, conv3x3_fwd_finish_kernel (bf16),
          dense_conv_fwd_kernel, fwd_kernel<...> (f32)
  K5      dinput_mma_kernel (bf16), dinput_kernel<...> (f32)
  K6      dweight_mma_kernel, sum_partials_kernel (bf16), dweight_kernel<...>
  K2      warp_sample_fwd_kernel
  K3      max_grad_kernel, warp_sample_bwd_kernel, dimg_kernel
"""
from harness.readers import NOT_KERNELS, matcher, traced

PORT_KERNELS = matcher([r"conv3x3_fwd_mma_kernel", r"conv3x3_fwd_finish_kernel",
                        r"dense_conv_fwd_kernel", r"\bfwd_kernel<", r"dinput_mma_kernel",
                        r"\bdinput_kernel<", r"dweight_mma_kernel", r"sum_partials_kernel",
                        r"\bdweight_kernel<", r"warp_sample_fwd_kernel", r"max_grad_kernel",
                        r"warp_sample_bwd_kernel", r"\bdimg_kernel"])


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    other = t.kernel_time_s(lambda n: not PORT_KERNELS(n) and not NOT_KERNELS.search(n))
    return 1e3 * other / t.units
