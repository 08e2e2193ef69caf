"""idle_ms.forward.train: the device's idle ms a step while
``training.train_step``'s ``forward`` span (``_forward_pair``) is
open: the gaps between the traced stretch's device operations that the
span covers, the mean over the traced steps
(``harness/port_spans.py``)."""
from harness.port_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "forward")
