"""Bilinear image resampling with torch ``grid_sample`` semantics (JAX
package ``ops/gridsample.py``).

The reference warps with ``F.grid_sample(mode='bilinear',
padding_mode='zeros')`` on a grid normalized as ``2*(x/W) - 1``
(reference models.py:325-336); under ``align_corners=False`` that samples
at pixel coordinate ``x - 0.5``.

``grid_sample`` is the sampler the train step uses: it shifts and clamps
the coordinates here, in PyTorch, and samples through
``ops.warp_sample`` (the hand-written kernels on the card).
``grid_sample_nhwc`` is the plain four-gather formulation without the
clamp, the sampler's plain version.
"""
from __future__ import annotations

import torch

from .warp_sample import sample_bilinear, sample_bilinear_reference


def _shift(x, y, h: int, w: int, align_corners: bool):
    if align_corners:
        return x * (w - 1) / w, y * (h - 1) / h
    return x - 0.5, y - 0.5


def grid_sample_nhwc(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at pixel coordinates (x, y) each
    (B, H', W') in the reference's grid convention, zeros padding, by four
    gathers (JAX gridsample.py:35-76). Differentiable by autograd."""
    _, h, w, _ = image.shape
    px, py = _shift(x, y, h, w, align_corners)
    return sample_bilinear_reference(image, px, py)


def grid_sample(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                align_corners: bool = False,
                grad_first_only: bool = False) -> torch.Tensor:
    """The sampler entry (JAX ``grid_sample`` with its Pallas backend,
    warp_pallas.py:296-313): shift to the sampler's convention, clamp far
    coordinates to [-2, size+1] (a tap there is outside the image either
    way, the clamp passes no gradient outside the band, and floor() stays
    a small int), then sample. ``grad_first_only`` declares that only
    image channel 0 needs a gradient."""
    _, h, w, _ = image.shape
    px, py = _shift(x, y, h, w, align_corners)
    px = torch.clamp(px, -2.0, w + 1.0)
    py = torch.clamp(py, -2.0, h + 1.0)
    return sample_bilinear(image.contiguous(), px.contiguous(),
                           py.contiguous(), grad_first_only=grad_first_only)
