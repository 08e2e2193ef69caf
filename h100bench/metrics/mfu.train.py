"""mfu.train: the whole train step's share of the card's bf16 tensor
peak, in %: the convolutions' operations of a step (the forward's, from
the configuration's shapes at 2B = 16, times 3 for the forward and the
two gradients; ``harness.roofline.forward_conv_flops``) times the
window's steps, over the window's time times 989 TFLOP/s (H100 SXM,
dense, 700 W: the card's power limit is on an earlier line)."""
from harness import roofline
from harness.readers import train_rows


def read(ctx):
    w, t = ctx.window, ctx.traffic
    if not w.get("units"):
        return None
    flops = 3 * roofline.forward_conv_flops(ctx.config, train_rows(ctx), t["height"],
                                            t["width"])
    return 100.0 * w["units"] * flops / (w["window_s"] * roofline.PEAK_FLOPS[ctx.config["dtype"]])
