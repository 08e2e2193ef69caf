"""Depth Anything V2 (Yang et al., NeurIPS 2024, arXiv:2406.09414), plain
PyTorch at float32: the DINOv2 ViT encoder (Oquab et al., arXiv:2304.07193)
and the DPT head as github.com/DepthAnything/Depth-Anything-V2 builds them
(``depth_anything_v2/dpt.py``, ``dinov2.py``), written out from the
equations with no kernel of any package: attention as softmax(Q K^T /
sqrt(head size)) V on whole matrices, TF32 off for matmuls and cuDNN.

It imports neither JAX nor the port, and its module names are the
upstream checkpoint's keys, so one state_dict loads into it and into the
port (which, like this file, leaves out ``pretrained.mask_token`` and
``depth_head.scratch.refinenet4.resConfUnit1``: neither takes part in the
forward). ``forward(x, quant=None)``: NCHW colors -> (B, 1, H, W) depth;
``quant``, where given, rounds every matmul's and convolution's
activation input (Q, K and V among them) through another type, as the
benchmark's control does with float8 e4m3. ``build(config)`` makes the
network from a configuration file's sizes.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

PATCH = 14
EPS = 1e-6
OFFSET = 0.1  # DINOv2's interpolate_offset

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(m: nn.Linear, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.linear(_q(quant, x), m.weight, m.bias)


def _conv(m: nn.Conv2d, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.conv2d(_q(quant, x), m.weight, m.bias, m.stride, m.padding)


def position_embedding(pos_embed: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(1, 1 + g*g, C) -> (1, 1 + rows*cols, C): the class position kept,
    the g x g grid resized bicubically at scale factors ((rows + 0.1)/g,
    (cols + 0.1)/g) without antialias, or kept where rows = cols = g."""
    grid = int(round((pos_embed.shape[1] - 1) ** 0.5))
    if rows == grid and cols == grid:
        return pos_embed
    dim = pos_embed.shape[-1]
    image = pos_embed[:, 1:].reshape(1, grid, grid, dim).permute(0, 3, 1, 2)
    image = F.interpolate(image, scale_factor=((rows + OFFSET) / grid, (cols + OFFSET) / grid),
                          mode="bicubic", antialias=False)
    assert image.shape[-2:] == (rows, cols), image.shape
    return torch.cat([pos_embed[:, :1], image.permute(0, 2, 3, 1).reshape(1, rows * cols, dim)],
                     1)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        qkv = _linear(self.qkv, x, quant).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = (_q(quant, t) for t in qkv)
        weights = torch.softmax(q @ k.transpose(-2, -1) / d ** 0.5, dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(b, n, c)
        return _linear(self.proj, out, quant)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, quant)), quant)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        x = x + self.ls1.gamma * self.attn(self.norm1(x), quant)
        return x + self.ls2.gamma * self.mlp(self.norm2(x), quant)


class Encoder(nn.Module):
    def __init__(self, img_size: int, dim: int, depth: int, heads: int, mlp_ratio: float):
        super().__init__()
        grid = img_size // PATCH
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=EPS)

    def forward(self, x: torch.Tensor, take: Sequence[int], quant: Quant):
        b, _, h, w = x.shape
        rows, cols = h // PATCH, w // PATCH
        tokens = _conv(self.patch_embed.proj, x, quant).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
        tokens = tokens + position_embedding(self.pos_embed, rows, cols)
        taken = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, quant)
            if i in take:
                taken.append(self.norm(tokens)[:, 1:])
        return taken


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        out = _conv(self.conv1, F.relu(x), quant)
        return _conv(self.conv2, F.relu(out), quant) + x


class FusionBlock(nn.Module):
    def __init__(self, features: int, skip: bool):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None, quant: Quant = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip, quant)
        x = self.resConfUnit2(x, quant)
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return _conv(self.out_conv, x, quant)


class Head(nn.Module):
    def __init__(self, dim: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        c = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(dim, ci, 1) for ci in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4), nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(), nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, ci in enumerate(c, 1):
            setattr(self.scratch, f"layer{i}_rn", nn.Conv2d(ci, features, 3, padding=1, bias=False))
        for k in (1, 2, 3, 4):
            setattr(self.scratch, f"refinenet{k}", FusionBlock(features, skip=k != 4))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU(),
            nn.Identity())

    def forward(self, feats, rows: int, cols: int, quant: Quant) -> torch.Tensor:
        s = self.scratch
        levels = []
        for i, x in enumerate(feats):
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], rows, cols)
            x = _conv(self.projects[i], x, quant)
            resize = self.resize_layers[i]
            if isinstance(resize, nn.ConvTranspose2d):
                x = F.conv_transpose2d(_q(quant, x), resize.weight, resize.bias, resize.stride)
            elif isinstance(resize, nn.Conv2d):
                x = _conv(resize, x, quant)
            levels.append(_conv(getattr(s, f"layer{i + 1}_rn"), x, quant))
        l1, l2, l3, l4 = levels
        path = s.refinenet4(l4, size=l3.shape[2:], quant=quant)
        path = s.refinenet3(path, l3, size=l2.shape[2:], quant=quant)
        path = s.refinenet2(path, l2, size=l1.shape[2:], quant=quant)
        path = s.refinenet1(path, l1, quant=quant)
        out = F.interpolate(_conv(s.output_conv1, path, quant), (rows * PATCH, cols * PATCH),
                            mode="bilinear", align_corners=True)
        out = F.relu(_conv(s.output_conv2[0], out, quant))
        return F.relu(_conv(s.output_conv2[2], out, quant))


class DepthAnythingV2(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_ratio: float,
                 layer_idx: Sequence[int], features: int, out_channels: Sequence[int],
                 img_size: int):
        super().__init__()
        self.layer_idx = tuple(layer_idx)
        self.pretrained = Encoder(img_size, embed_dim, depth, num_heads, mlp_ratio)
        self.depth_head = Head(embed_dim, features, out_channels)

    def forward(self, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = x.float()
        rows, cols = x.shape[-2] // PATCH, x.shape[-1] // PATCH
        assert rows * PATCH == x.shape[-2] and cols * PATCH == x.shape[-1], x.shape
        feats = self.pretrained(x, self.layer_idx, quant)
        return self.depth_head(feats, rows, cols, quant)


def build(config: dict) -> DepthAnythingV2:
    return DepthAnythingV2(config["embed_dim"], config["depth"], config["num_heads"],
                           config["mlp_ratio"], config["layer_idx"], config["features"],
                           config["out_channels"], config["img_size"])
