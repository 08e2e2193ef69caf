"""views_per_s.vggt: frames through VGGT's aggregator a second of the
window: the advance of the port's counter ``models.vggt.LAUNCHES["views"]``
over the window (2B a step, a replayed step advances it as an eager one
does), read by the ``train_step_vggt`` driver, over the window's time.
None where the window read no views (a program without VGGT)."""


def read(ctx):
    w = ctx.window
    views = w.get("views")
    if not views or not w.get("window_s"):
        return None
    return views / w["window_s"]
