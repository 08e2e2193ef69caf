"""Color normalization (JAX package ``data/augment.py:157-160``)."""
from __future__ import annotations

import numpy as np


def normalize_color(image: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (reference dataset.py:148:
    albu.Normalize(mean=std=0.5, max_pixel_value=255))."""
    return (np.asarray(image, dtype=np.float32) / 255.0 - 0.5) / 0.5
