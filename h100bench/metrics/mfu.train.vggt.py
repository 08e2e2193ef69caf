"""mfu.train.vggt: VGGT's train step's share of the card's bf16 tensor
peak, in %: the analytic operations of a forward over B pairs as 2-view
sequences (the patch embedder's, the 24 frame and 24 global blocks'
matmuls and attention, every convolution of the depth head:
``harness.roofline_vggt.forward_flops``), times 3 for the forward and the
two gradients, times the window's steps, over the window's time times
989 TFLOP/s (H100 SXM, dense, 700 W: the card's power limit is on an
earlier line)."""
from harness import roofline, roofline_vggt


def step_flops(ctx) -> float:
    t = ctx.traffic
    return 3 * roofline_vggt.forward_flops(ctx.config, t["batch"], t["height"], t["width"])


def read(ctx):
    w = ctx.window
    if not w.get("units"):
        return None
    return 100.0 * w["units"] * step_flops(ctx) / (
        w["window_s"] * roofline.PEAK_FLOPS[ctx.config["dtype"]])
