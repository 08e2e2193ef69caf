"""The port's own host-side counters of its kernel wrappers' calls (K1-K6),
read before and after a stretch of work to check a cell's path."""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                              warp_sample)
    return {"K1": dense_conv.LAUNCHES, "K2": warp_sample.LAUNCHES["warp_sample_fwd"],
            "K3": warp_sample.LAUNCHES["warp_sample_bwd"],
            "K4": block_engine.LAUNCHES["block_engine_fwd"],
            "K5": block_engine.LAUNCHES["block_engine_dinput"],
            "K6": block_engine.LAUNCHES["block_engine_dweight"]}


def per_unit(before: Dict[str, int], after: Dict[str, int], units: int) -> Dict[str, float]:
    return {k: (after[k] - before[k]) / units for k in after}


def check_path(per: Dict[str, float], want: Dict[str, float], where: str) -> None:
    if per != want:
        raise RuntimeError(f"{where} left its path: launches {per}, expected {want}")
