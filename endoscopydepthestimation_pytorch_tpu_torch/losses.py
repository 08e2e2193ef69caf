"""Losses and evaluation metrics, NHWC (JAX package ``losses.py``, itself
the reference's losses.py:17-227).

The two training losses are ``sparse_masked_l1_loss`` (SFL) and
``normalized_distance_loss`` (DCL); the rest serve distillation, the
legacy variants and evaluation (AbsRel, sigma thresholds). Every function
reduces over (H, W, C) per sample, then takes the batch mean.
"""
from __future__ import annotations

from typing import Tuple

import torch

_AXES = (1, 2, 3)


def sparse_masked_l1_loss(flows, flows_from_depth, sparse_masks,
                          epsilon: float = 1.0) -> torch.Tensor:
    """Sparse Flow Loss: sum(mask*|f - f_hat|)/(eps + sum(mask)), batch
    mean (reference losses.py:57-66)."""
    return sparse_masked_l1_loss_per_sample(flows, flows_from_depth,
                                            sparse_masks, epsilon).mean()


def sparse_masked_l1_loss_per_sample(flows, flows_from_depth, sparse_masks,
                                     epsilon: float = 1.0) -> torch.Tensor:
    """Per-sample SFL (no batch mean), for the outlier detector
    (reference losses.py:69-79)."""
    return ((sparse_masks * torch.abs(flows - flows_from_depth)).sum(_AXES) /
            (epsilon + sparse_masks.sum(_AXES)))


def normalized_distance_loss(depth_maps, warped_depth_maps, intersect_masks,
                             intrinsics, eps: float = 1.0e-5) -> torch.Tensor:
    """Depth Consistency Loss: unproject both depth maps to 3-D with K and
    compare, normalized by the masked depth magnitude (reference
    losses.py:112-146). ``mean_value`` carries no gradient, as the
    reference computes it under no_grad."""
    b, h, w, _ = depth_maps.shape
    fx = intrinsics[:, 0, 0][:, None, None, None]
    fy = intrinsics[:, 1, 1][:, None, None, None]
    cx = intrinsics[:, 0, 2][:, None, None, None]
    cy = intrinsics[:, 1, 2][:, None, None, None]
    x = torch.arange(w, dtype=depth_maps.dtype,
                     device=depth_maps.device)[None, None, :, None]
    y = torch.arange(h, dtype=depth_maps.dtype,
                     device=depth_maps.device)[None, :, None, None]

    mean_value = ((intersect_masks * depth_maps).sum(_AXES) /
                  (eps + intersect_masks.sum(_AXES))).detach()

    def unproject(d):
        return torch.cat([(x - cx) / fx * d, (y - cy) / fy * d, d], dim=-1)

    diff = torch.abs(unproject(depth_maps) - unproject(warped_depth_maps))
    per_sample = (2.0 * (intersect_masks * diff).sum(_AXES) /
                  (1.0e-5 * mean_value +
                   (intersect_masks * (depth_maps + torch.abs(warped_depth_maps))
                    ).sum(_AXES)))
    return per_sample.mean()


def scale_invariant_loss(predicted_depths, goal_depths, boundaries,
                         epsilon: float = 1.0e-8) -> torch.Tensor:
    """Eigen log-ratio scale-invariant loss for teacher-student
    distillation (reference losses.py:17-32)."""
    ratio = (torch.log(boundaries * predicted_depths + epsilon) -
             torch.log(boundaries * goal_depths + epsilon))
    weight = boundaries.sum(_AXES)
    loss_1 = (ratio * ratio).sum(_AXES) / weight
    sum_2 = ratio.sum(_AXES)
    loss_2 = (sum_2 * sum_2) / (weight * weight)
    return (loss_1 + loss_2).mean()


def masked_scale_invariant_loss(predicted_depths, sparse_depths, sparse_masks,
                                epsilon: float = 1.0e-8) -> torch.Tensor:
    """Sparse-masked Eigen loss (reference losses.py:167-186)."""
    ratio = torch.where(sparse_depths < 0.5, 0.0,
                        torch.log(predicted_depths + epsilon) -
                        torch.log(sparse_depths))
    weight = sparse_masks.sum(_AXES)
    loss_1 = (sparse_masks * ratio * ratio).sum(_AXES) / weight
    sum_2 = (sparse_masks * ratio).sum(_AXES)
    loss_2 = (sum_2 * sum_2) / (weight * weight)
    return (loss_1 + loss_2).mean()


def masked_l1_loss(images, twice_warped_images, intersect_masks,
                   epsilon: float = 1.0) -> torch.Tensor:
    """Masked mean absolute error (reference losses.py:82-91)."""
    per_sample = ((intersect_masks * torch.abs(images - twice_warped_images)
                   ).sum(_AXES) / (epsilon + intersect_masks.sum(_AXES)))
    return per_sample.mean()


def normalized_l2_loss(depth_maps, warped_depth_maps, intersect_masks,
                       eps: float = 1.0e-3) -> torch.Tensor:
    """Legacy symmetric normalized L2 DCL (reference losses.py:94-109)."""
    mean_value = ((intersect_masks * depth_maps).sum(_AXES) /
                  (eps + intersect_masks.sum(_AXES))).detach()
    diff = depth_maps - warped_depth_maps
    per_sample = ((intersect_masks * diff * diff).sum(_AXES) /
                  (0.5 * (intersect_masks * (depth_maps ** 2 +
                                             warped_depth_maps ** 2)).sum(_AXES) +
                   1.0e-5 * mean_value * mean_value))
    return per_sample.mean()


def normalized_l1_loss(depth_maps, warped_depth_maps, masks,
                       eps: float = 1.0e-3) -> torch.Tensor:
    """Symmetric normalized L1 (reference losses.py:149-164)."""
    mean_value = (masks * depth_maps).sum(_AXES) / (eps + masks.sum(_AXES))
    per_sample = ((masks * torch.abs(depth_maps - warped_depth_maps)).sum(_AXES) /
                  (0.5 * (masks * (torch.abs(depth_maps) +
                                   torch.abs(warped_depth_maps))).sum(_AXES) +
                   1.0e-5 * mean_value))
    return per_sample.mean()


def normalized_weighted_masked_l2_loss(depth_maps, warped_depth_maps,
                                       intersect_masks, translations,
                                       epsilon: float = 1.0) -> torch.Tensor:
    """Translation-magnitude-weighted normalized L2, a legacy DCL variant
    (reference losses.py:35-54)."""
    t = translations.reshape(-1, 3)
    weights = 1.0 / (1.0e-8 + torch.sqrt((t * t).sum(1)))
    diff = depth_maps - warped_depth_maps
    per_sample = ((intersect_masks * diff * diff).sum(_AXES) /
                  (0.5 * (intersect_masks * (depth_maps ** 2 +
                                             warped_depth_maps ** 2)).sum(_AXES) +
                   epsilon))
    return (per_sample * weights).sum() / weights.sum()


def abs_rel_error(scaled_depth_maps, sparse_depth_maps, sparse_depth_masks,
                  eps: float = 1.0e-8) -> torch.Tensor:
    """Per-sample absolute relative error over the sparse ground-truth
    pixels (reference losses.py:189-199)."""
    return ((sparse_depth_masks * torch.abs(scaled_depth_maps - sparse_depth_maps) /
             (eps + sparse_depth_maps)).sum(_AXES) /
            sparse_depth_masks.sum(_AXES))


def threshold_metric(scaled_depth_maps, sparse_depth_maps, sparse_depth_masks,
                     eps: float = 1.0e-8
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sigma < 1.25 / 1.25^2 / 1.25^3 accuracies over the sparse pixels,
    per sample (reference losses.py:202-227)."""
    ratio = torch.maximum(
        scaled_depth_maps * sparse_depth_masks / (eps + sparse_depth_maps),
        sparse_depth_maps / (eps + scaled_depth_maps * sparse_depth_masks))
    threshold_map = sparse_depth_masks * ratio + (1.0 - sparse_depth_masks) * 10.0
    n = sparse_depth_masks.sum(_AXES)
    return tuple((threshold_map < 1.25 ** k).float().sum(_AXES) / n
                 for k in (1, 2, 3))
