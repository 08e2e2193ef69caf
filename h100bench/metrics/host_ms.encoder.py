"""host_ms.encoder.<cell> (``host_ms.encoder.dav2l``): the host's ms a
unit inside the port's ``encoder`` spans (Depth Anything V2's forward
opens one under ``forward``, around the ViT: the patch embedding, the
blocks and their attention calls), the mean over the traced units. The
span is no phase of the step, so it is read from the units' records
(``harness/port_spans.reading``); None where the port keeps no such span."""
from harness.port_spans import reading


def span_ms(ctx, name: str):
    r = reading(ctx)
    if r is None:
        return None
    spans = [rec for rec in r.records if rec.name == name]
    if not spans:
        return None
    return 1e-6 * sum(rec.end_ns - rec.start_ns for rec in spans) / r.units


def read(ctx):
    return span_ms(ctx, "encoder")
