"""Depth map -> colored point cloud: the port's copy of the JAX package's
``utils/pointcloud.py`` (``point_cloud_from_depth`` :17; numpy only).

The reference unprojects pixel by pixel in nested Python loops
(utils.py:825-852); this is the same unprojection vectorized, with the
same content and order (row-major pixel order, masked pixels only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .plyio import write_point_cloud  # re-export  # noqa: F401


def point_cloud_from_depth(depth_map: np.ndarray, color_img: np.ndarray,
                           mask_img: np.ndarray, intrinsic_matrix: np.ndarray,
                           point_cloud_downsampling: int = 1,
                           min_threshold: Optional[float] = None,
                           max_threshold: Optional[float] = None) -> np.ndarray:
    """Unproject the masked pixels to (N, 6) float32 [x, y, z, r, g, b].

    x = (u - cx)/fx * z, y = (v - cy)/fy * z. ``color_img`` is BGR: its
    channels 2, 1, 0 become the stored r, g, b, as the reference reads its
    BGR buffer. With both thresholds, only pixels whose brightest channel
    is >= ``max_threshold`` and darkest <= ``min_threshold`` are kept.
    Parity: reference utils.py:825-852.
    """
    depth_map = np.asarray(depth_map)
    color_img = np.asarray(color_img)
    mask_img = np.asarray(mask_img)
    height, width = depth_map.shape[:2]

    fx = intrinsic_matrix[0, 0]
    cx = intrinsic_matrix[0, 2]
    fy = intrinsic_matrix[1, 1]
    cy = intrinsic_matrix[1, 2]

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    keep = (mask_img.reshape(height, width) > 0.5)
    if point_cloud_downsampling > 1:
        stride_mask = np.zeros_like(keep)
        stride_mask[::point_cloud_downsampling, ::point_cloud_downsampling] = True
        keep &= stride_mask

    z = depth_map.reshape(height, width)[keep]
    u = us[keep].astype(np.float64)
    v = vs[keep].astype(np.float64)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z

    bgr = color_img.reshape(height, width, -1)[keep]
    r = bgr[:, 2].astype(np.float32)
    g = bgr[:, 1].astype(np.float32)
    b = bgr[:, 0].astype(np.float32)

    if min_threshold is not None and max_threshold is not None:
        bright = np.max(bgr[:, :3], axis=1) >= max_threshold
        dark = np.min(bgr[:, :3], axis=1) <= min_threshold
        sel = bright & dark
        x, y, z, r, g, b = x[sel], y[sel], z[sel], r[sel], g[sel], b[sel]

    cloud = np.stack([x, y, z, np.uint8(r), np.uint8(g), np.uint8(b)], axis=1)
    return cloud.astype(np.float32).reshape(-1, 6)
