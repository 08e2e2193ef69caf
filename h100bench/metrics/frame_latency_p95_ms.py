"""frame_latency_p95_ms.<cell> (``frame_latency_p95_ms.live``): the 95th
percentile of every frame's latency in the window, raw frame into
``predict_frame`` to masked depth on the host, read per layer where the
host's swings spread it too widely for an end-to-end bound (PERF.md). The
window runs untraced; the traced stretch comes after it."""


def read(ctx):
    return ctx.window.get("metrics", {}).get("frame_latency_p95_ms")
