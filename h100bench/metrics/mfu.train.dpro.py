"""mfu.train.dpro: Depth Pro's train step's share of the card's bf16
tensor peak, in %: the analytic operations of a forward at 2B frames (both
ViTs' matmuls and attention over 70 B + 2 B sequences, and every
convolution of the project-upsample branches, the decoder and the head:
``harness.roofline_depth_pro.forward_flops``), times 3 for the forward and
the two gradients, times the window's steps, over the window's time times
989 TFLOP/s (H100 SXM, dense, 700 W: the card's power limit is on an
earlier line)."""
from harness import roofline, roofline_depth_pro
from harness.readers import train_rows


def step_flops(ctx) -> float:
    return 3 * roofline_depth_pro.forward_flops(ctx.config, train_rows(ctx))


def read(ctx):
    w = ctx.window
    if not w.get("units"):
        return None
    return 100.0 * w["units"] * step_flops(ctx) / (
        w["window_s"] * roofline.PEAK_FLOPS[ctx.config["dtype"]])
