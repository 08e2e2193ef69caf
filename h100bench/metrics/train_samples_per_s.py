"""train_samples_per_s.<cell> (``train_samples_per_s.fcdn57``): the
window's training rate, read per layer where the host's swings spread it
too widely for an end-to-end bound (PERF.md): every sample of every step
enqueued in the window over the window's time, which ends at a device
sync. The window runs untraced; the traced stretch comes after it."""


def read(ctx):
    return ctx.window.get("metrics", {}).get("train_samples_per_s")
