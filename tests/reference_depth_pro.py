"""Depth Pro (Bochkovskii et al., ICLR 2025, arXiv:2410.02073), plain
PyTorch at float32: the multi-scale tiled encoder, the image encoder and
the multi-resolution decoder as github.com/apple/ml-depth-pro builds them
(``src/depth_pro/depth_pro.py``, ``network/encoder.py``,
``network/decoder.py``, ``network/vit_factory.py`` preset
``dinov2l16_384``), written out from the equations with no kernel of any
package: attention as softmax(Q K^T / sqrt(head size)) V on whole
matrices, TF32 off for matmuls and cuDNN.

It imports neither JAX nor the port, and its module names are the
upstream checkpoint's keys, so one state_dict loads into it and into the
port. Departures from upstream, the port's too: no FOV head (``fov``) and
no ``decoder.fusions.4.resnet1`` (the deepest fusion block has no skip);
the output read as depth. ``forward(x, quant=None)``: NCHW colors ->
(B, 1, S, S) depth; ``quant``, where given, rounds every matmul's and
convolution's activation input (Q, K and V among them) through another
type, as the benchmark's control does with float8 e4m3. With
``checkpoint_blocks`` set, each ViT block's forward is recomputed in the
backward instead of kept (``torch.utils.checkpoint``): the same numbers,
a fraction of the memory. ``build(config)`` makes the network from a
configuration file's sizes, with ``checkpoint_blocks`` as the file's
``reference_checkpoint_blocks`` says (off where it says nothing).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

EPS = 1e-6
OVERLAPS = (0.25, 0.5)

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(m: nn.Linear, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.linear(_q(quant, x), m.weight, m.bias)


def _conv(m: nn.Module, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(_q(quant, x), m.weight, m.bias, m.stride, m.padding)
    return F.conv2d(_q(quant, x), m.weight, m.bias, m.stride, m.padding)


def split(x: torch.Tensor, tile: int, overlap: float) -> torch.Tensor:
    """Sliding-window tiles of ``tile`` pixels at a stride of tile (1 -
    overlap), row-major, concatenated on the batch axis (upstream
    ``DepthProEncoder.split``)."""
    stride = int(tile * (1 - overlap))
    steps = int(math.ceil((x.shape[-1] - tile) / stride)) + 1
    tiles = []
    for j in range(steps):
        for i in range(steps):
            tiles.append(x[..., j * stride:j * stride + tile, i * stride:i * stride + tile])
    return torch.cat(tiles, 0)


def merge(x: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """NCHW tile features back into one map, each tile's sides that face
    another tile trimmed by ``padding`` (upstream ``DepthProEncoder.merge``)."""
    steps = int(math.sqrt(x.shape[0] // batch))
    idx = 0
    rows = []
    for j in range(steps):
        row = []
        for i in range(steps):
            out = x[batch * idx:batch * (idx + 1)]
            if j != 0:
                out = out[..., padding:, :]
            if i != 0:
                out = out[..., :, padding:]
            if j != steps - 1:
                out = out[..., :-padding, :]
            if i != steps - 1:
                out = out[..., :, :-padding]
            row.append(out)
            idx += 1
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


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


class ViT(nn.Module):
    """DINOv2 ViT at ``patch`` on ``img_size`` inputs, the position
    embedding stored for that grid and not resized."""

    def __init__(self, img_size: int, patch: int, dim: int, depth: int, heads: int,
                 mlp_ratio: float):
        super().__init__()
        self.patch = patch
        grid = img_size // patch
        self.patch_embed = PatchEmbed(dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.checkpoint_blocks = False

    def forward(self, x: torch.Tensor, hooks: Sequence[int], quant: Quant):
        """(the normed output, [the raw outputs of the blocks in ``hooks``]),
        each (B, C, grid, grid) without the class token."""
        b, _, h, w = x.shape
        rows, cols = h // self.patch, w // self.patch
        assert 1 + rows * cols == self.pos_embed.shape[1], (x.shape, self.pos_embed.shape)
        tokens = _conv(self.patch_embed.proj, x, quant).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1) + self.pos_embed

        def grid(t):
            return t[:, 1:].transpose(1, 2).reshape(b, -1, rows, cols)

        raw = []
        for i, block in enumerate(self.blocks):
            if self.checkpoint_blocks and torch.is_grad_enabled():
                tokens = torch.utils.checkpoint.checkpoint(block, tokens, quant,
                                                           use_reentrant=False)
            else:
                tokens = block(tokens, quant)
            if i in hooks:
                raw.append(grid(tokens))
        return grid(self.norm(tokens)), raw


def _project_upsample(dim_in: int, dim_out: int, layers: int, dim_int: int = None):
    dim_int = dim_out if dim_int is None else dim_int
    blocks = [nn.Conv2d(dim_in, dim_int, 1, bias=False)]
    blocks += [nn.ConvTranspose2d(dim_int if i == 0 else dim_out, dim_out, 2, stride=2,
                                  bias=False) for i in range(layers)]
    return nn.Sequential(*blocks)


def _run(seq: nn.Sequential, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    for m in seq:
        x = _conv(m, x, quant)
    return x


class Encoder(nn.Module):
    def __init__(self, tile: int, patch: int, dim: int, depth: int, heads: int,
                 mlp_ratio: float, dims_encoder: Sequence[int], features: int,
                 hooks: Sequence[int]):
        super().__init__()
        self.tile, self.hooks = tile, tuple(hooks)
        self.patch_encoder = ViT(tile, patch, dim, depth, heads, mlp_ratio)
        self.image_encoder = ViT(tile, patch, dim, depth, heads, mlp_ratio)
        d = list(dims_encoder)
        self.upsample_latent0 = _project_upsample(dim, features, 3, d[0])
        self.upsample_latent1 = _project_upsample(dim, d[0], 2)
        self.upsample0 = _project_upsample(dim, d[1], 1)
        self.upsample1 = _project_upsample(dim, d[2], 1)
        self.upsample2 = _project_upsample(dim, d[3], 1)
        self.upsample_lowres = nn.ConvTranspose2d(dim, d[3], 2, stride=2)
        self.fuse_lowres = nn.Conv2d(2 * d[3], d[3], 1)

    def forward(self, x: torch.Tensor, quant: Quant) -> List[torch.Tensor]:
        b = x.shape[0]
        x0 = x
        x1 = F.interpolate(x, scale_factor=0.5, mode="bilinear", align_corners=False)
        x2 = F.interpolate(x, scale_factor=0.25, mode="bilinear", align_corners=False)
        p0 = split(x0, self.tile, OVERLAPS[0])
        p1 = split(x1, self.tile, OVERLAPS[1])
        encodings, (hook0, hook1) = self.patch_encoder(torch.cat([p0, p1, x2], 0), self.hooks,
                                                       quant)
        grid = encodings.shape[-1]
        latent0 = merge(hook0[:len(p0)], b, grid // 8)
        latent1 = merge(hook1[:len(p0)], b, grid // 8)
        e0, e1, e2 = torch.split(encodings, [len(p0), len(p1), len(x2)], 0)
        f0 = merge(e0, b, grid // 8)
        f1 = merge(e1, b, grid // 4)
        image, _ = self.image_encoder(x2, (), quant)
        f2 = _run(self.upsample2, e2, quant)
        lowres = _conv(self.upsample_lowres, image, quant)
        return [_run(self.upsample_latent0, latent0, quant),
                _run(self.upsample_latent1, latent1, quant),
                _run(self.upsample0, f0, quant), _run(self.upsample1, f1, quant),
                _conv(self.fuse_lowres, torch.cat([f2, lowres], 1), quant)]


class ResidualBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.residual = nn.Sequential(nn.ReLU(), nn.Conv2d(features, features, 3, padding=1),
                                      nn.ReLU(), nn.Conv2d(features, features, 3, padding=1))

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        delta = _conv(self.residual[1], F.relu(x), quant)
        return x + _conv(self.residual[3], F.relu(delta), quant)


class FusionBlock(nn.Module):
    def __init__(self, features: int, deconv: bool, skip: bool):
        super().__init__()
        if skip:
            self.resnet1 = ResidualBlock(features)
        self.resnet2 = ResidualBlock(features)
        if deconv:
            self.deconv = nn.ConvTranspose2d(features, features, 2, stride=2, bias=False)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, quant: Quant = None):
        if skip is not None:
            x = x + self.resnet1(skip, quant)
        x = self.resnet2(x, quant)
        if hasattr(self, "deconv"):
            x = _conv(self.deconv, x, quant)
        return _conv(self.out_conv, x, quant)


class Decoder(nn.Module):
    def __init__(self, dims: Sequence[int], features: int):
        super().__init__()
        dims = list(dims)
        self.convs = nn.ModuleList([nn.Identity()] + [
            nn.Conv2d(c, features, 3, padding=1, bias=False) for c in dims[1:]])
        self.fusions = nn.ModuleList(FusionBlock(features, i != 0, i != len(dims) - 1)
                                     for i in range(len(dims)))

    def forward(self, encodings, quant: Quant) -> torch.Tensor:
        n = len(encodings)
        f = self.fusions[-1](_conv(self.convs[-1], encodings[-1], quant), quant=quant)
        for i in range(n - 2, -1, -1):
            e = encodings[i] if i == 0 else _conv(self.convs[i], encodings[i], quant)
            f = self.fusions[i](f, e, quant=quant)
        return f


class DepthPro(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_ratio: float,
                 tile: int, patch: int, dims_encoder: Sequence[int], decoder_features: int,
                 hooks: Sequence[int]):
        super().__init__()
        assert decoder_features == dims_encoder[0], "convs[0] is the identity here"
        self.img_size = 4 * tile
        self.encoder = Encoder(tile, patch, embed_dim, depth, num_heads, mlp_ratio,
                               dims_encoder, decoder_features, hooks)
        self.decoder = Decoder([decoder_features] + list(dims_encoder), decoder_features)
        f = decoder_features
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.ConvTranspose2d(f // 2, f // 2, 2, stride=2),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    @property
    def checkpoint_blocks(self) -> bool:
        return self.encoder.patch_encoder.checkpoint_blocks

    @checkpoint_blocks.setter
    def checkpoint_blocks(self, on: bool) -> None:
        self.encoder.patch_encoder.checkpoint_blocks = on
        self.encoder.image_encoder.checkpoint_blocks = on

    def forward(self, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = x.float()
        assert x.shape[-2:] == (self.img_size, self.img_size), x.shape
        features = self.decoder(self.encoder(x, quant), quant)
        h = self.head
        y = _conv(h[1], _conv(h[0], features, quant), quant)
        y = F.relu(_conv(h[2], y, quant))
        return F.relu(_conv(h[4], y, quant))


def build(config: dict) -> DepthPro:
    model = DepthPro(config["embed_dim"], config["depth"], config["num_heads"],
                     config["mlp_ratio"], config["tile_size"], config["patch_size"],
                     config["dims_encoder"], config["decoder_features"],
                     config["hook_block_ids"])
    model.checkpoint_blocks = bool(config.get("reference_checkpoint_blocks", False))
    return model
