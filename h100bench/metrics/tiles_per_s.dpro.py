"""tiles_per_s.dpro: tiles through Depth Pro's patch encoder a second of
the window: the advance of the port's counter
``models.depth_pro.LAUNCHES["tiles"]`` over the window (35 a frame; a
replayed step advances it as an eager one does), read by the
``train_step_depth_pro`` driver, over the window's time. None where the
window read no tiles (a program without Depth Pro)."""


def read(ctx):
    w = ctx.window
    tiles = w.get("tiles")
    if not tiles or not w.get("window_s"):
        return None
    return tiles / w["window_s"]
