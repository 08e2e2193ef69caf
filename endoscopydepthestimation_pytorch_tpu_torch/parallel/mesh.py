"""Batch shaping for one device: the single-device part of the JAX
package's ``parallel/mesh.py`` (``pad_batch_to`` :280)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def pad_batch_to(batch: Dict, batch_size: int) -> Dict:
    """Pad a ragged last batch up to ``batch_size`` rows with repeats of
    its last row; list fields pass through. The result's ``"_valid"`` is
    the number of real rows, so callers slice per-sample outputs back to
    it (the evaluate CLI, as the JAX one does)."""
    out = {}
    valid = batch_size
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = v
            continue
        valid = v.shape[0]
        if valid < batch_size:
            pad = np.repeat(v[-1:], batch_size - valid, axis=0)
            v = np.concatenate([v, pad], axis=0)
        out[k] = v
    out["_valid"] = valid
    return out
