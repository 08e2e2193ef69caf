"""mfu.<serving cell kind> (``mfu.live``; ``mfu.train`` has a file of its
own): the served forward's share of the card's bf16 tensor peak, in %:
the convolutions' operations of one frame
(``harness.roofline.forward_conv_flops`` at batch 1; a batched forward
does the same work a frame) times the window's frames, over the window's
time times 989 TFLOP/s (H100 SXM, dense, 700 W)."""
from harness import roofline


def read(ctx):
    w, t = ctx.window, ctx.traffic
    if not w.get("units"):
        return None
    flops = roofline.forward_conv_flops(ctx.config, 1, t["height"], t["width"])
    return 100.0 * w["units"] * flops / (w["window_s"] * roofline.PEAK_FLOPS[ctx.config["dtype"]])
