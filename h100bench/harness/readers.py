"""What the per-layer metric readers share: kernel-name matching, the
cell's shapes and the peaks. Each reader (``metrics/<name>.py``) holds
its own kernel-name map and says which counts it reads."""
from __future__ import annotations

import re
from typing import Iterable, Optional

from . import roofline
from .tracing import Trace

# device operations that are no kernel launched by a kernel function
NOT_KERNELS = re.compile(r"^(Memset|Memcpy)")


def matcher(patterns: Iterable[str]):
    """A predicate on a kernel's name: any of the regular expressions
    matches it."""
    compiled = [re.compile(p) for p in patterns]
    return lambda name: any(c.search(name) for c in compiled)


def traced(ctx) -> Optional[Trace]:
    """The trace, when a stretch was traced and the device ran in it."""
    t = ctx.trace
    return t if t is not None and t.units > 0 and t.device else None


def share_pct(bound_s: float, measured_s: float) -> Optional[float]:
    """A roofline share in %, None when the kernels never ran."""
    return 100.0 * bound_s / measured_s if measured_s > 0 else None


def itemsize(ctx) -> int:
    return roofline.ITEMSIZE[ctx.config["dtype"]]


def layer_shapes(ctx):
    t = ctx.traffic
    return roofline.dense_layer_shapes(ctx.config, t["height"], t["width"])


def train_rows(ctx) -> int:
    """Rows of the train step's stacked batch: both frames, 2B."""
    return 2 * ctx.traffic["batch"]
