"""mfu.train.dav2l: Depth Anything V2's train step's share of the card's
bf16 tensor peak, in %: the analytic operations of a forward at 2B
images (the encoder's matmuls and attention,
``harness.roofline_attention.encoder_flops``, and the DPT head's
convolutions, ``head_flops``), times 3 for the forward and the two
gradients, times the window's steps, over the window's time times 989
TFLOP/s (H100 SXM, dense, 700 W: the card's power limit is on an earlier
line)."""
from harness import roofline, roofline_attention
from harness.readers import train_rows


def step_flops(ctx) -> float:
    t, cfg, rows = ctx.traffic, ctx.config, train_rows(ctx)
    return 3 * (roofline_attention.encoder_flops(cfg, rows, t["height"], t["width"])
                + roofline_attention.head_flops(cfg, rows, t["height"], t["width"]))


def read(ctx):
    w = ctx.window
    if not w.get("units"):
        return None
    return 100.0 * w["units"] * step_flops(ctx) / (
        w["window_s"] * roofline.PEAK_FLOPS[ctx.config["dtype"]])
