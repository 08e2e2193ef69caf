"""host_ms.losses.train: the host's ms a step inside
``training.train_step``'s ``losses`` span (``compute_losses``), the
mean over the traced steps (``harness/port_spans.py``)."""
from harness.port_spans import host_ms


def read(ctx):
    return host_ms(ctx, ["losses"])
