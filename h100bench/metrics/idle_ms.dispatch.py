"""idle_ms.dispatch.live: the device's idle ms a frame while
``DepthPredictor.predict_frame``'s ``dispatch`` span (H2D and
``predict_step``'s enqueue) is open: the gaps between the traced
stretch's device operations that the span covers, the mean over the
traced frames (``harness/port_spans.py``)."""
from harness.port_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "dispatch")
