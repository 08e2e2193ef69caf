"""host_ms.dispatch.live: the host's ms a frame inside
``DepthPredictor.predict_frame``'s ``dispatch`` span (H2D and
``predict_step``'s enqueue), the mean over the traced frames
(``harness/port_spans.py``)."""
from harness.port_spans import host_ms


def read(ctx):
    return host_ms(ctx, ["dispatch"])
