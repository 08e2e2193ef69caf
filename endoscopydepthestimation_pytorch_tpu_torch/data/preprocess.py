"""Per-sequence calibration record and frame loading (JAX package
``data/preprocess.py``: ``SequenceData`` :247-260, ``load_color_image``
:82-96). OpenCV is imported only where a file is read or a frame resized.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class SequenceData:
    """Everything the sampler needs about one video sequence."""
    folder: str
    crop_positions: List[int]                 # [start_h, end_h, start_w, end_w]
    selected_indexes: List[int]
    visible_view_indexes: List[int]
    point_cloud: np.ndarray                   # (N, 4) homogeneous
    intrinsic_matrix: np.ndarray              # 3x4 (cropped/downsampled)
    mask_boundary: np.ndarray                 # (H, W) uint8 eroded mask
    view_indexes_per_point: np.ndarray        # (N, n_views) smoothed counts
    extrinsics: List[np.ndarray]              # n_views x 4x4
    projections: List[np.ndarray]             # n_views x 3x4
    clean_point_list: np.ndarray              # (N,) float 0/1
    estimated_scale: float = 1.0


def load_color_image(path, start_h, end_h, start_w, end_w, downsampling_factor,
                     is_hsv=False, rgb_mode="bgr") -> np.ndarray:
    """Read a frame, resize by 1/downsampling, crop, convert colorspace.

    Parity: reference utils.py:71-81 / 288-300 / 441-457 (cv2 BGR read,
    INTER_LINEAR resize, HSV_FULL or RGB conversion).
    """
    import cv2
    img = cv2.imread(str(path))
    img = cv2.resize(img, (0, 0), fx=1.0 / downsampling_factor, fy=1.0 / downsampling_factor)
    img = img[start_h:end_h, start_w:end_w, :]
    if is_hsv:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2HSV_FULL)
    elif rgb_mode == "rgb":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img
