"""Differentiable geometry of the self-supervised objective, NHWC (JAX
package ``ops/geometry.py``, itself the reference's models.py:317-554).

Conventions (the reference's):
  * depth maps, masks: (B, H, W, 1) float32
  * rotation: (B, 3, 3); translation: (B, 3, 1); intrinsics: (B, 3, 3)
  * the pixel grid is (u = x = column, v = y = row), origin top-left
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gridsample import grid_sample, grid_sample_nhwc

MASKED_DEPTH_SENTINEL = 1.0e30  # reference models.py:410


def intrinsics_inverse(k: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (B, 3, 3) pinhole intrinsics
    [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] (the reference solves with LU,
    models.py:392)."""
    fx, fy, cx, cy = k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([
        torch.stack([1.0 / fx, zeros, -cx / fx], dim=-1),
        torch.stack([zeros, 1.0 / fy, -cy / fy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)


def _pixel_grid(height: int, width: int, like: torch.Tensor):
    x = torch.arange(width, dtype=like.dtype, device=like.device)
    y = torch.arange(height, dtype=like.dtype, device=like.device)
    return x[None, :].expand(height, width), y[:, None].expand(height, width)


def _reprojection_terms(rotation, translation, intrinsics, height: int,
                        width: int):
    """W = K R^T (-t), M = K R^T K^-1, and the per-pixel M @ [u, v, 1]^T.
    Returns (w_vec (B, 3), m_pix (B, H, W, 3)); reference models.py:377-402."""
    k_inv = intrinsics_inverse(intrinsics)
    temp = intrinsics @ rotation.transpose(1, 2)       # K R^T
    w_vec = (temp @ (-translation))[..., 0]            # (B, 3)
    m = (temp @ k_inv)[:, None, None, :, :]            # (B, 1, 1, 3, 3)
    x, y = _pixel_grid(height, width, intrinsics)
    m_pix = (m[..., 0] * x[None, :, :, None] +
             m[..., 1] * y[None, :, :, None] + m[..., 2])
    return w_vec, m_pix


def warp_coordinates(depth_maps, img_masks, translation, rotation,
                     intrinsics) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source pixel coordinates (u2, v2) in frame 2 of every frame-1
    pixel, from frame-1 depth; masked pixels get z2 = 1e30, so u2, v2 go
    to ~0 (reference models.py:377-429)."""
    _, h, w, _ = depth_maps.shape
    w_vec, m_pix = _reprojection_terms(rotation, translation, intrinsics, h, w)
    w_b = w_vec[:, None, None, :]
    z2 = w_b[..., 2:3] + depth_maps * m_pix[..., 2:3]
    z2 = MASKED_DEPTH_SENTINEL * (1.0 - img_masks) + img_masks * z2
    u2 = (w_b[..., 0:1] + depth_maps * m_pix[..., 0:1]) / z2
    v2 = (w_b[..., 1:2] + depth_maps * m_pix[..., 1:2]) / z2
    return u2, v2


def flow_from_depth(depth_maps, img_masks, translation, rotation,
                    intrinsics) -> torch.Tensor:
    """Dense flow frame 1 -> 2 implied by depth and relative pose,
    normalized by the image size: ((u2-u)/W, (v2-v)/H), (B, H, W, 2)
    (reference models.py:366-374, 433-451)."""
    _, h, w, _ = depth_maps.shape
    u2, v2 = warp_coordinates(depth_maps, img_masks, translation, rotation,
                              intrinsics)
    x, y = _pixel_grid(h, w, depth_maps)
    return torch.stack([(u2[..., 0] - x) / float(w),
                        (v2[..., 0] - y) / float(h)], dim=-1)


def warp_depth(depth_maps_1, depth_maps_2, img_masks, translation, rotation,
               intrinsics, epsilon: float = 1.0e-8, align_corners: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp frame 2's depth into frame 1's geometry.

    1. (u2, v2) of every frame-1 pixel from d1 and the 1 -> 2 pose;
    2. frame-1 depth as seen from frame 2:
       d1_in_2 = (K t)_z + d2 * (K R K^-1 [u, v, 1])_z, masked;
    3. one bilinear sample of [d1_in_2, mask] at (u2, v2), the gradient
       through channel 0 only (the mask feeds a hard threshold);
    4. intersection mask = (sampled mask * mask >= 0.9).

    Returns (warped depth (B, H, W, 1), intersect mask (B, H, W, 1));
    reference models.py:454-554.
    """
    _, h, w, _ = depth_maps_1.shape
    d1 = depth_maps_1 * img_masks
    d2 = depth_maps_2 * img_masks

    w_vec, m_pix = _reprojection_terms(rotation, translation, intrinsics, h, w)
    w_b = w_vec[:, None, None, :]
    z2 = w_b[..., 2:3] + d1 * m_pix[..., 2:3]
    z2 = torch.where(img_masks > 0.5, z2, epsilon)
    z2 = torch.where(z2 > 0.0, z2, epsilon)
    u2 = (w_b[..., 0:1] + d1 * m_pix[..., 0:1]) / z2
    v2 = (w_b[..., 1:2] + d1 * m_pix[..., 1:2]) / z2

    # frame-1 depth as seen from frame 2 (reference models.py:531-541)
    k_inv = intrinsics_inverse(intrinsics)
    w2_z = (intrinsics @ translation)[:, 2, 0][:, None, None, None]
    m2 = intrinsics @ rotation @ k_inv
    x, y = _pixel_grid(h, w, depth_maps_1)
    m2_z = (m2[:, None, None, 2, 0] * x + m2[:, None, None, 2, 1] * y +
            m2[:, None, None, 2, 2])[..., None]
    d1_in_2 = img_masks * (w2_z + d2 * m2_z)

    stacked = torch.cat([d1_in_2, img_masks], dim=-1)
    sampled = grid_sample(stacked, u2[..., 0], v2[..., 0],
                          align_corners=align_corners, grad_first_only=True)
    warped = sampled[..., 0:1]
    intersect = (sampled[..., 1:2] * img_masks >= 0.9).to(depth_maps_1.dtype)
    return warped, intersect


def scale_recovery_per_sample(predicted_depths, sparse_depths,
                              weighted_sparse_masks, epsilon: float = 1.0e-8
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample scale recovery with the raw (B,) diagnostics.

    Keeps the sparse depths above half their masked mean; the scale is
    the mean ratio sparse/predicted over them. Returns (scaled depths,
    scale stds (B,), scales (B,)); reference models.py:339-363.
    """
    axes = (1, 2, 3)
    binary = (weighted_sparse_masks > 1.0e-8).to(predicted_depths.dtype)
    mean_sparse = ((sparse_depths * binary).sum(axes, keepdim=True) /
                   binary.sum(axes, keepdim=True))
    above = (sparse_depths > 0.5 * mean_sparse).to(predicted_depths.dtype)
    scale_maps = sparse_depths * above / (epsilon + predicted_depths)
    n_above = above.sum(axes, keepdim=True)
    mean_scales = scale_maps.sum(axes, keepdim=True) / n_above
    centered = scale_maps - above * mean_scales
    scale_stds = torch.sqrt((centered * centered).sum(axes) / n_above[:, 0, 0, 0])
    return mean_scales * predicted_depths, scale_stds, mean_scales[:, 0, 0, 0]


def normalized_scale_std(scale_stds: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """The reference's diagnostic mean(std_i) * mean(1/scale_j): it divides
    a (B,) std vector by a (B, 1, 1, 1) tensor, broadcasting to
    (B, 1, 1, B) before the mean (models.py:361-363), a cross-batch
    normalization kept as it is."""
    return scale_stds.mean() * (1.0 / scales).mean()


def scale_recovery(predicted_depths, sparse_depths, weighted_sparse_masks,
                   epsilon: float = 1.0e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample scale from the sparse SfM depths, plus the batch's
    normalized-std diagnostic (reference models.py:339-363)."""
    scaled, scale_stds, scales = scale_recovery_per_sample(
        predicted_depths, sparse_depths, weighted_sparse_masks, epsilon)
    return scaled, normalized_scale_std(scale_stds, scales)


def images_warping(images: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """Warp NHWC images by absolute source pixel coordinates (u, v), each
    (B, H, W) (reference models.py:317-322)."""
    return grid_sample_nhwc(images, u, v, align_corners=align_corners)
