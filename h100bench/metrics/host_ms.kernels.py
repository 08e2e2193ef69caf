"""host_ms.kernels.<cell kind>: the host's ms a unit inside the port's
kernel wrapper spans, each around one C call beside its ``LAUNCHES``
counter: K2-K6 (``warp_fwd``, ``warp_bwd``, ``engine_fwd``,
``engine_dinput``, ``engine_dweight``) a train step, the 44 K1
(``dense_conv``) a live frame; the mean over the traced units
(``harness/port_spans.py``)."""
from harness.port_spans import KERNEL_SPANS, host_ms


def read(ctx):
    return host_ms(ctx, KERNEL_SPANS)
