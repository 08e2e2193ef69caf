"""host_ms.readback.live: the host's ms a frame inside
``DepthPredictor.predict_frame``'s ``readback`` span
(``.cpu().numpy()``, which waits for the device), the mean over the
traced frames (``harness/port_spans.py``)."""
from harness.port_spans import host_ms


def read(ctx):
    return host_ms(ctx, ["readback"])
