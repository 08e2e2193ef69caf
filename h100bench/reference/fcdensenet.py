"""FC-DenseNet (Jegou et al., "The One Hundred Layers Tiramisu", 2017, as
the endoscopy reference's models.py:19-208 builds it), plain PyTorch,
NCHW, float32.

Dense layer: BN -> ReLU -> 3x3 conv (growth channels, with bias), its
output concatenated to its input. Transition down: BN -> ReLU -> 1x1 conv
-> 2x2 max-pool. Transition up: nearest x2 upsample -> 3x3 conv, cropped
to the skip's size and concatenated before it. The bottleneck and the up
blocks but the last return only their new channels. The head is a 1x1
conv whose absolute value is the depth.

BatchNorm in train mode normalizes with the batch's biased variance and
moves the running statistics to 0.9 r + 0.1 stat with that same biased
variance (as the reference's trainer is set up in the port's
documentation, not torch's unbiased running variance). The modules keep
the reference's state_dict names, so one state_dict loads into both.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
KEEP = 0.9  # running statistics keep 0.9 of their value

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating at its largest finite 448),
    with the gradient passed straight through."""
    q = x.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (q - x.detach())


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def bn_relu(bn: nn.BatchNorm2d, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    if bn.training:
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            bn.running_mean.mul_(KEEP).add_((1.0 - KEEP) * mean)
            bn.running_var.mul_(KEEP).add_((1.0 - KEEP) * var)
    else:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=EPS)
    return _q(quant, F.relu(y))


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, growth, 3, padding=1)

    def forward(self, x, quant: Quant = None):
        return _q(quant, self.conv(bn_relu(self.norm, x, quant)))


class DenseBlock(nn.Module):
    def __init__(self, in_channels: int, growth: int, n_layers: int,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.layers = nn.ModuleList(DenseLayer(in_channels + j * growth, growth)
                                    for j in range(n_layers))

    def forward(self, x, quant: Quant = None):
        new = []
        for layer in self.layers:
            y = layer(x, quant)
            x = torch.cat([x, y], 1)
            new.append(y)
        return torch.cat(new, 1) if self.upsample else x


class TransitionDown(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(channels)
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x, quant: Quant = None):
        return _q(quant, F.max_pool2d(self.conv(bn_relu(self.norm, x, quant)), 2))


class TransitionUp(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.convTrans = nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                                       nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, x, skip, quant: Quant = None):
        up = _q(quant, self.convTrans(x))
        h, w = skip.shape[2], skip.shape[3]
        y0, x0 = (up.shape[2] - h) // 2, (up.shape[3] - w) // 2
        return torch.cat([up[:, :, y0:y0 + h, x0:x0 + w], skip], 1)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, growth: int, n_layers: int):
        super().__init__()
        self.bottleneck = DenseBlock(in_channels, growth, n_layers, upsample=True)

    def forward(self, x, quant: Quant = None):
        return self.bottleneck(x, quant)


class FCDenseNet(nn.Module):
    """(B, 3, H, W) float32 -> (B, n_classes, H, W) nonnegative depth."""

    def __init__(self, down_blocks: Sequence[int], up_blocks: Sequence[int],
                 bottleneck_layers: int, growth_rate: int,
                 out_chans_first_conv: int, n_classes: int = 1):
        super().__init__()
        cur = out_chans_first_conv
        self.firstconv = nn.Conv2d(3, cur, 3, padding=1)
        skips = []
        self.denseBlocksDown = nn.ModuleList()
        self.transDownBlocks = nn.ModuleList()
        for n in down_blocks:
            self.denseBlocksDown.append(DenseBlock(cur, growth_rate, n))
            cur += growth_rate * n
            skips.insert(0, cur)
            self.transDownBlocks.append(TransitionDown(cur))
        self.bottleneck = Bottleneck(cur, growth_rate, bottleneck_layers)
        prev = growth_rate * bottleneck_layers
        self.transUpBlocks = nn.ModuleList()
        self.denseBlocksUp = nn.ModuleList()
        for i, n in enumerate(up_blocks):
            last = i == len(up_blocks) - 1
            self.transUpBlocks.append(TransitionUp(prev))
            cur = prev + skips[i]
            self.denseBlocksUp.append(DenseBlock(cur, growth_rate, n, upsample=not last))
            prev = growth_rate * n
            cur += prev
        self.finalConv = nn.Conv2d(cur, n_classes, 1)

    def forward(self, x, quant: Quant = None):
        out = _q(quant, self.firstconv(_q(quant, x)))
        skips = []
        for block, down in zip(self.denseBlocksDown, self.transDownBlocks):
            out = block(out, quant)
            skips.append(out)
            out = down(out, quant)
        out = self.bottleneck(out, quant)
        for up, block in zip(self.transUpBlocks, self.denseBlocksUp):
            out = block(up(out, skips.pop(), quant), quant)
        return _q(quant, self.finalConv(out)).abs()


def build(config: dict) -> FCDenseNet:
    """The reference network of a configuration file's sizes."""
    return FCDenseNet(config["down_blocks"], config["up_blocks"],
                      config["bottleneck_layers"], config["growth_rate"],
                      config["out_chans_first_conv"], config["n_classes"])
