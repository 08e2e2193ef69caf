"""The serving path, plain NumPy and PyTorch: a raw BGR frame to the
boundary-masked depth of its crop (the endoscopy reference's
evaluate.py:322-327 and dataset.py:148).

Frame prep: downsample by the integer factor f the way OpenCV's bilinear
resize does (each output pixel samples the input at ((i + 0.5) f - 0.5),
the two nearest rows and columns weighted, rounded half up to uint8),
crop, BGR to RGB, then (x / 255 - 0.5) / 0.5. The boundary mask is the
sequence's mask above 0.9 of 255.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def downsample(frame: np.ndarray, factor: int) -> np.ndarray:
    """Bilinear downsampling of a uint8 (H, W, C) frame by an integer
    factor, the sample points at ((i + 0.5) * factor - 0.5)."""
    if factor == 1:
        return frame
    out = frame.astype(np.float64)
    for axis in (0, 1):
        n = frame.shape[axis] // factor
        pos = (np.arange(n) + 0.5) * factor - 0.5
        lo = np.floor(pos).astype(np.int64)
        t = (pos - lo).reshape([-1 if a == axis else 1 for a in range(3)])
        out = (np.take(out, lo, axis) * (1 - t)
               + np.take(out, np.minimum(lo + 1, frame.shape[axis] - 1), axis) * t)
    return np.floor(out + 0.5).clip(0, 255).astype(np.uint8)


def prepare(frame: np.ndarray, crop: Sequence[int], factor: int) -> np.ndarray:
    """Raw uint8 BGR frame -> normalized float32 RGB crop (H, W, 3)."""
    sh, eh, sw, ew = crop
    img = downsample(np.asarray(frame), factor)[sh:eh, sw:ew, ::-1]
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def boundary(mask_boundary: np.ndarray) -> np.ndarray:
    return (mask_boundary.astype(np.float32) / 255.0 > 0.9).astype(np.float32)


@torch.no_grad()
def masked_depth(model, colors: np.ndarray, mask: np.ndarray, device,
                 quant=None) -> np.ndarray:
    """(N, H, W, 3) normalized colors -> (N, H, W) masked depth, the model
    in eval mode (running statistics)."""
    model.eval()
    m = torch.from_numpy(mask).to(device)
    x = torch.from_numpy(np.ascontiguousarray(colors)).to(device) * m[None, :, :, None]
    depth = model(x.permute(0, 3, 1, 2), quant)[:, 0]
    return (depth * m).cpu().numpy()
