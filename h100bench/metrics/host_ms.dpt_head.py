"""host_ms.dpt_head.<cell> (``host_ms.dpt_head.dav2l``): the host's ms a
unit inside the port's ``dpt_head`` spans (Depth Anything V2's forward
opens one under ``forward``, around the DPT head), the mean over the
traced units, read from the units' records as ``host_ms.encoder``; None
where the port keeps no such span."""
from harness.registry import BENCH_DIR, load_module

span_ms = load_module(BENCH_DIR / "metrics" / "host_ms.encoder.py").span_ms


def read(ctx):
    return span_ms(ctx, "dpt_head")
