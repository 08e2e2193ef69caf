"""Test-phase inference step (JAX package ``training.py``, ``predict_step``
:339-344). The train step is not ported yet."""
from __future__ import annotations

import torch
from torch import nn


def predict_step(model: nn.Module, colors: torch.Tensor,
                 boundaries: torch.Tensor) -> torch.Tensor:
    """Depth inference: model(boundary * color) with running BN statistics
    (reference evaluate.py:322-327). colors (B, H, W, 3) and boundaries
    (B, H, W, 1), NHWC as in the JAX package -> depth (B, H, W, 1) float32.
    ``model`` must be in eval mode."""
    with torch.inference_mode():
        x = (colors * boundaries).permute(0, 3, 1, 2)  # NCHW, channels_last
        return model(x).permute(0, 2, 3, 1)
