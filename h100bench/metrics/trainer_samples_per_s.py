"""trainer_samples_per_s.<cell> (``trainer_samples_per_s.fcdn57``): the
trainer's rate, ``train.main`` called whole in the window (the loader's
threads, boards, validation and the checkpoint included): every sample
of the epoch's steps over the call's time. Read per layer, as the train
cell's rate is, where the host's swings spread it too widely for an
end-to-end bound (PERF.md)."""


def read(ctx):
    return ctx.window.get("metrics", {}).get("trainer_samples_per_s")
