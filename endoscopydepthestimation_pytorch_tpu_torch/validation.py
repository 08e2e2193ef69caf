"""Standalone network validation (JAX package ``validation.py``:
``validation_step`` :25, ``network_validation`` :78).

The validation routine of the reference's older training script (utils.py:
1615-1731): boundaries binarized at 0.9, the model with its running BN
statistics, the SFL and the translation-weighted masked L2 depth
consistency, NaN batches skipped, and the per-batch loss vector returned
beside the mean. That vector feeds the outlier-robust best-model
selection (``failure.save_if_best``). The trainer's own validation is
``training.eval_step``, with another DCL.

The forward is the eval-mode FCDenseNet (K1 at every dense layer, one
call over both frames stacked) and the depth warp K2, with no gradient.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from . import losses, training
from .ops import geometry


def validation_step(state: training.TrainState, batch: Dict[str, torch.Tensor],
                    sfl_weight: float = 20.0, dcl_weight: float = 5.0,
                    epsilon: float = 1.0e-8) -> Dict[str, torch.Tensor]:
    """One batch (NHWC tensors on the model's device; the keys of the
    train batch): the weighted loss, SFL and DCL (reference
    utils.py:1654-1705). The model runs in eval mode and is left in the
    mode it was in."""
    model = state.model
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()
            boundaries = (batch["boundary"] >= 0.9).float()
            bound2 = torch.cat([boundaries, boundaries], 0)
            colors = torch.cat([batch["color_1"], batch["color_2"]], 0)
            depths = model((colors * bound2).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

            def stack(a, b):
                return torch.cat([batch[a], batch[b]], 0)

            k2 = stack("intrinsic", "intrinsic")
            t_fwd = stack("translation_1_wrt_2", "translation_2_wrt_1")
            r_fwd = stack("rotation_1_wrt_2", "rotation_2_wrt_1")
            scaled, _ = geometry.scale_recovery(
                depths, stack("sparse_depth_1", "sparse_depth_2"),
                stack("depth_mask_1", "depth_mask_2"), epsilon)
            s1, s2 = scaled.chunk(2, 0)
            flows_from_depth = geometry.flow_from_depth(
                scaled, bound2, t_fwd, r_fwd, k2) * bound2
            sfl = losses.sparse_masked_l1_loss(
                stack("flow_1", "flow_2") * bound2, flows_from_depth,
                stack("flow_mask_1", "flow_mask_2") * bound2)
            warped, intersect = geometry.warp_depth(
                scaled, torch.cat([s2, s1], 0), bound2, t_fwd, r_fwd, k2, epsilon)
            dcl = losses.normalized_weighted_masked_l2_loss(
                scaled, warped, intersect, t_fwd, epsilon)
    finally:
        model.train(was_training)
    return {"loss": sfl_weight * sfl + dcl_weight * dcl,
            "sparse_flow_loss": sfl_weight * sfl,
            "depth_consistency_loss": dcl_weight * dcl}


def network_validation(state: training.TrainState,
                       batches: Iterable[Dict[str, np.ndarray]],
                       sfl_weight: float = 20.0, dcl_weight: float = 5.0,
                       epsilon: float = 1.0e-8, writer=None, epoch: int = 0
                       ) -> Tuple[float, List[float]]:
    """``validation_step`` over ``batches`` (numpy or tensors; moved to the
    model's device); returns (mean loss, per-batch loss vector), as the
    reference's routine returns ``np.mean(validation_losses),
    validation_losses`` (utils.py:1727-1731). Batches whose loss is NaN are
    skipped (utils.py:1707). With a ``writer`` (``MetricWriter``) the three
    "Validation" means go to it at ``epoch``."""
    device = next(state.model.parameters()).device
    totals: List[float] = []
    sfls: List[float] = []
    dcls: List[float] = []
    for batch in batches:
        tensors = {k: torch.as_tensor(v).to(device)
                   for k, v in batch.items() if not isinstance(v, list)}
        metrics = validation_step(state, tensors, sfl_weight, dcl_weight, epsilon)
        loss = float(metrics["loss"])
        if not np.isnan(loss):
            totals.append(loss)
            sfls.append(float(metrics["sparse_flow_loss"]))
            dcls.append(float(metrics["depth_consistency_loss"]))
    if writer is not None and totals:
        writer.add_scalars("Validation", {
            "overall": float(np.mean(totals)),
            "depth consistency": float(np.mean(dcls)),
            "sparse opt": float(np.mean(sfls))}, epoch)
    mean = float(np.mean(totals)) if totals else float("nan")
    return mean, totals
