"""Sparse supervision rasterizer: the port's copy of the JAX package's
``data/rasterizer.py`` (``rasterize_pair`` :44), the plain version of the
native rasterizer in ``data/native.py``.

Projects the clean+visible SfM points into both frames of a training pair
and scatters them into fixed-shape per-pixel maps: sparse depth (camera-z),
a 0/1 depth mask, sparse flow ((p_other - p_this) normalized by W, H), and a
0/1 flow mask. This runs per sample per iteration on the host, so it is
fully vectorized numpy (the reference's version is utils.py:460-612).

Semantics matched to the reference:
  * pixel locations are np.round()-ed (banker's rounding) before scatter;
  * a point lands only if inside the image, in front of the camera
    (z > 0), and on a mask_boundary == 255 pixel;
  * flow entries with |component| > 5.0 are zeroed and unmasked
    (utils.py:567-574);
  * when several points round to the same pixel the LAST write wins in the
    reference's fancy-indexing assignment; np.ufunc-style duplicate handling
    here uses plain fancy assignment, which has identical last-wins
    semantics.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _project(points_h: np.ndarray, projection: np.ndarray, extrinsic: np.ndarray):
    """2-D pixel (rounded, homogeneous-normalized) + camera-frame coords."""
    img2d = points_h @ np.asarray(projection).T
    img2d = np.round(img2d / img2d[:, 2:3])
    cam = points_h @ np.asarray(extrinsic).T
    cam = cam / cam[:, 3:4]
    return img2d, cam


def _visible_indexes(view_indexes_per_point: np.ndarray, view_col: int,
                     clean_point_list: np.ndarray) -> np.ndarray:
    vis = view_indexes_per_point[:, view_col] > 0.5
    if clean_point_list is not None and clean_point_list.size:
        vis &= clean_point_list > 0.5
    return np.where(vis)[0]


def rasterize_pair(pair_extrinsics: List[np.ndarray], pair_projections: List[np.ndarray],
                   pair_indexes: List[int], point_cloud: np.ndarray,
                   mask_boundary: np.ndarray, view_indexes_per_point: np.ndarray,
                   clean_point_list: np.ndarray, visible_view_indexes: List[int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rasterize sparse depth/flow supervision for a frame pair.

    Returns (depth_masks, sparse_depths, flow_masks, flows) with shapes
    (2, H, W, 1), (2, H, W, 1), (2, H, W, 1), (2, H, W, 2) — float32, NHWC.
    Parity: reference utils.py:460-612 (which returns the same content in
    the same tuple order).
    """
    height, width = mask_boundary.shape[:2]
    points_h = np.asarray(point_cloud, dtype=np.float64).reshape(-1, 4)
    flat_mask = np.asarray(mask_boundary).reshape(-1)

    img2d_1, cam_1 = _project(points_h, pair_projections[0], pair_extrinsics[0])
    img2d_2, cam_2 = _project(points_h, pair_projections[1], pair_extrinsics[1])

    col_1 = visible_view_indexes.index(pair_indexes[0])
    col_2 = visible_view_indexes.index(pair_indexes[1])
    vis_1 = _visible_indexes(view_indexes_per_point, col_1, clean_point_list)
    vis_2 = _visible_indexes(view_indexes_per_point, col_2, clean_point_list)

    flows = np.zeros((2, height * width, 2), dtype=np.float32)
    flow_masks = np.zeros((2, height * width, 1), dtype=np.float32)
    depths = np.zeros((2, height * width, 1), dtype=np.float32)
    depth_masks = np.zeros((2, height * width, 1), dtype=np.float32)

    for frame, (vis, img2d_this, cam_this, img2d_other) in enumerate([
            (vis_1, img2d_1, cam_1, img2d_2),
            (vis_2, img2d_2, cam_2, img2d_1)]):
        p2d = img2d_this[vis]
        p3d = cam_this[vis]
        in_img = np.where((p2d[:, 0] <= width - 1) & (p2d[:, 0] >= 0) &
                          (p2d[:, 1] <= height - 1) & (p2d[:, 1] >= 0) &
                          (p3d[:, 2] > 0))[0]
        locations = (np.round(p2d[in_img, 0]) +
                     np.round(p2d[in_img, 1]) * width).astype(np.int32)
        in_mask = np.where(flat_mask[locations] == 255)[0]
        locations = locations[in_mask]
        source_points = vis[in_img[in_mask]]

        flow_masks[frame, locations, 0] = 1.0
        flow = (img2d_other[source_points, :2] - img2d_this[source_points, :2]).astype(np.float32)
        flow[:, 0] /= width
        flow[:, 1] /= height
        flows[frame, locations, :] = flow

        depths[frame, locations, 0] = cam_this[source_points, 2]
        depth_masks[frame, locations, 0] = 1.0

        # flow-outlier rejection (reference utils.py:567-574)
        outliers = np.where((np.abs(flows[frame, :, 0]) > 5.0) |
                            (np.abs(flows[frame, :, 1]) > 5.0))[0]
        flow_masks[frame, outliers, 0] = 0.0
        flows[frame, outliers, :] = 0.0

    return (depth_masks.reshape(2, height, width, 1),
            depths.reshape(2, height, width, 1),
            flow_masks.reshape(2, height, width, 1),
            flows.reshape(2, height, width, 2))
