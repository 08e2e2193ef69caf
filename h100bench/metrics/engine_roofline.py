"""engine_roofline: the block engine's kernels (K4, K5, K6:
``ops.block_engine``) against their roofline, in %: the sum over each
traced step's launches of the least time the card could take for that
launch (the larger of its operations over the bf16 tensor peak and its
bytes over HBM's rate; ``harness.roofline.engine_layer_counts``: one 3x3
convolution's multiply-adds each, each input read once and each output
written once, from the layer's shape at 2B = 16), over the kernels'
measured device time.

Kernel-name map (CUDA function names):
  K4  conv3x3_fwd_mma_kernel<TWL, VW, true>, conv3x3_fwd_finish_kernel
      (the split pass), fwd_kernel<float, ...> in f32
  K5  dinput_mma_kernel, dinput_kernel<float, ...> in f32
  K6  dweight_mma_kernel, sum_partials_kernel, dweight_kernel<float, ...>
A train step runs no K1 (checked from the port's counters), so the
function K1 shares with K4 is K4's here.
"""
from harness import roofline
from harness.readers import itemsize, layer_shapes, matcher, share_pct, traced, train_rows

ENGINE = matcher([r"conv3x3_fwd_mma_kernel", r"conv3x3_fwd_finish_kernel", r"\bfwd_kernel<",
                  r"dinput_mma_kernel", r"\bdinput_kernel<", r"dweight_mma_kernel",
                  r"sum_partials_kernel", r"\bdweight_kernel<"])


def step_bound_s(ctx) -> float:
    """The least device time of one step's 3 x (dense layers) launches."""
    rows, size, dtype = train_rows(ctx), itemsize(ctx), ctx.config["dtype"]
    f = ctx.config["growth_rate"]
    counts = [bo for h, w, c in layer_shapes(ctx)
              for bo in roofline.engine_layer_counts(rows * h * w, c, f, size).values()]
    return roofline.sum_bounds_s(counts, dtype)


def read(ctx):
    t = traced(ctx)
    if t is None:
        return None
    return share_pct(t.units * step_bound_s(ctx), t.kernel_time_s(ENGINE))
