"""UNet in PyTorch: the port of the JAX package's ``UNetConvBlock``
(``models/fcdensenet.py:789``) and ``UNet`` (:805), itself the
reference's alternative encoder-decoder (models.py:211-291), which its
train and evaluate scripts never build; the trainer offers it as
``--architecture unet``.

(3x3 conv -> ReLU) x2 blocks, 2x2 average pooling down; up either by a
nearest x2 upsample and a 3x3 conv (``up_mode="upsample"``, the default)
or by a 3x3 stride-2 transposed conv (``"upconv"``); the skip is
center-cropped to the upsampled map and concatenated after it; a 1x1
head. No normalization layer, so no running statistics, and no kernel of
the port's own: every convolution is PyTorch's.

Module names follow the JAX parameter names (``down{i}.conv0``,
``up{i}_conv``, ``up{i}_block.conv1``, ``last``), so
``models.torch_import.from_jax_variables`` maps the JAX tree one to one.
Like ``FCDenseNet``, the module takes NCHW, keeps its activations in
``torch.channels_last`` memory and in ``dtype``, keeps its parameters
float32 and returns float32.

The transposed conv: flax's ``ConvTranspose((3, 3), strides=2,
padding="SAME")`` does not flip its kernel, and pads the 2x zero-
interleaved input by 2 before and 1 after; torch's ``ConvTranspose2d``
flips it. So the port holds the JAX kernel flipped in both spatial axes
(``from_jax_variables``), runs ``conv_transpose2d`` with no padding
(2n + 1 outputs) and keeps the first 2n: out[o] = sum_k w[k] xd[o + k - 2]
on both sides. Torch's ``padding=1, output_padding=1`` would shift the
map by one pixel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .fcdensenet import _conv, center_crop

UP_MODES = ("upsample", "upconv")


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of an NCHW tensor, in channels_last
    memory (JAX ``nearest_upsample_2x``, fcdensenet.py:540)."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return up.contiguous(memory_format=torch.channels_last)


class UNetConvBlock(nn.Module):
    """(3x3 conv -> ReLU) x2 (reference models.py:267-284)."""

    def __init__(self, in_size: int, out_size: int, padding: bool = True):
        super().__init__()
        self.pad = 1 if padding else 0
        self.conv0 = nn.Conv2d(in_size, out_size, 3, padding=self.pad)
        self.conv1 = nn.Conv2d(out_size, out_size, 3, padding=self.pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_conv(x, self.conv0, self.pad))
        return torch.relu(_conv(x, self.conv1, self.pad))


class UNet(nn.Module):
    """(B, in_channels, H, W) -> (B, out_channels, H', W') float32, with
    H' = H and W' = W when both are multiples of 2^(depth - 1) and
    ``padding`` is on; otherwise the skips are center-cropped and the map
    shrinks, as in the JAX model."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1, depth: int = 6,
                 wf: int = 6, padding: bool = True, up_mode: str = "upsample",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if up_mode not in UP_MODES:
            raise ValueError(f"unknown up_mode {up_mode!r}")
        self.depth, self.up_mode, self.dtype = depth, up_mode, dtype
        prev = in_channels
        for i in range(depth):
            self.add_module(f"down{i}", UNetConvBlock(prev, 2 ** (wf + i), padding))
            prev = 2 ** (wf + i)
        for i in reversed(range(depth - 1)):
            width = 2 ** (wf + i)
            self.add_module(f"up{i}_conv", (
                nn.ConvTranspose2d(prev, width, 3, stride=2) if up_mode == "upconv"
                else nn.Conv2d(prev, width, 3, padding=1)))
            self.add_module(f"up{i}_block", UNetConvBlock(2 * width, width, padding))
            prev = width
        self.last = nn.Conv2d(prev, out_channels, 1)

    def _up(self, x: torch.Tensor, i: int) -> torch.Tensor:
        conv = getattr(self, f"up{i}_conv")
        if self.up_mode == "upsample":
            return _conv(nearest_upsample_2x(x), conv, 1)
        h, w = x.shape[2], x.shape[3]
        up = F.conv_transpose2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                                stride=2)
        return up[:, :, :2 * h, :2 * w].contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        bridges = []
        for i in range(self.depth):
            x = getattr(self, f"down{i}")(x)
            if i != self.depth - 1:
                bridges.append(x)
                x = F.avg_pool2d(x, 2)
        for i in reversed(range(self.depth - 1)):
            up = self._up(x, i)
            bridge = center_crop(bridges.pop(), up.shape[2], up.shape[3])
            x = getattr(self, f"up{i}_block")(torch.cat([up, bridge], 1))
        return _conv(x, self.last, 0).float()
