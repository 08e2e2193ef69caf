"""The numbers ``correct`` compares, each against its limit."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # NaN fails: a comparison with NaN is false
        return bool(self.value <= self.limit)


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The largest |program - reference| of a per-leaf norm, over the larger
    of that leaf's reference norm and the median leaf's: the gap between
    the two norms, not the norm of their difference. Returns (gap, leaf)."""
    names = list(reference) if keep is None else list(keep)
    if set(names) - set(program):
        return float("inf"), "missing: " + ",".join(sorted(set(names) - set(program)))
    median = statistics.median(reference[n] for n in names)
    worst, leaf = -1.0, ""
    for n in names:
        gap = abs(program[n] - reference[n]) / max(reference[n], median)
        if not np.isfinite(gap):
            return float("inf"), n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def percentile_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                        keep: Iterable[str], q: float) -> float:
    """The ``q``-th percentile over ``keep`` of the per-leaf gaps that
    ``worst_leaf_gap`` takes the largest of."""
    names = list(keep)
    if set(names) - set(program):
        return float("inf")
    median = statistics.median(reference[n] for n in names)
    gaps = [abs(program[n] - reference[n]) / max(reference[n], median) for n in names]
    value = float(np.percentile(gaps, q))
    return value if np.isfinite(value) else float("inf")


def masked_rel(got: np.ndarray, ref: np.ndarray, mask: np.ndarray) -> float:
    """mean |got - ref| / mean |ref| where ``mask`` is set."""
    m = np.broadcast_to(mask > 0, ref.shape)
    denom = np.abs(ref[m]).mean()
    value = float(np.abs(got[m].astype(np.float64) - ref[m]).mean() / denom)
    return value if np.isfinite(value) else float("inf")
