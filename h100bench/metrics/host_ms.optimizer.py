"""host_ms.optimizer.train: the host's ms a step inside
``training.train_step``'s ``optimizer`` span (``apply_gradients``),
the mean over the traced steps (``harness/port_spans.py``)."""
from harness.port_spans import host_ms


def read(ctx):
    return host_ms(ctx, ["optimizer"])
