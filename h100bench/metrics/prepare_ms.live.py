"""prepare_ms.live: ``DepthPredictor.prepare`` (resize, crop, BGR to RGB,
normalize) on the host's clock, a span the live driver records around
the call while a stretch is traced; the mean over the traced frames."""
from harness.readers import traced


def read(ctx):
    t = traced(ctx)
    spans = [] if t is None else t.spans.get("prepare", [])
    return 1e3 * sum(spans) / len(spans) if spans else None
