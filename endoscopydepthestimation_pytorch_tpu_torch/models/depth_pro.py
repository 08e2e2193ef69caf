"""Depth Pro (Bochkovskii et al., ICLR 2025, arXiv:2410.02073): two DINOv2
ViT-L/16 encoders over a tiled multi-scale image pyramid, and a
multi-resolution convolutional decoder, as the upstream code builds them
(github.com/apple/ml-depth-pro, ``src/depth_pro/depth_pro.py``
``DEFAULT_MONODEPTH_CONFIG_DICT``, ``network/encoder.py``
``DepthProEncoder``, ``network/decoder.py`` ``MultiresConvDecoder``,
``network/vit_factory.py`` preset ``dinov2l16_384``). ``DepthProLarge``
builds it; the trainer offers it as ``--architecture depth_pro``.

Encoder (``encoder``), on one 1536x1536 image:

- a pyramid: x0 the image, x1 and x2 bilinear resizes by 0.5 and 0.25
  (align_corners False), 768 and 384 pixels a side;
- ``split``: 384-pixel tiles at a stride of 384 (1 - r), r = 0.25 on x0 (5x5
  tiles) and 0.5 on x1 (3x3), row-major, and x2 as one tile; the tiles of
  all images concatenated tile-major (every image's tile 0, then tile 1):
  35 B tiles;
- ``patch_encoder``: a DINOv2 ViT-L (``depth_anything.DinoVisionTransformer``:
  1024 wide, 24 blocks, 16 heads of 64, MLP 4096, LayerScale) at patch 16,
  its position embedding stored for 24x24 and used as it is; one call
  over all 35 B tiles; the output through the final LayerNorm, and the
  raw outputs of blocks 5 and 11 of the 25 B x0 tiles (latent0, latent1);
- ``merge``: each tile of a 5x5 (3x3) grid drops ``padding`` token rows
  or columns on every side that faces another tile, and the rest is
  concatenated: x0 and both latents at padding 3 to 96x96, x1 at 6 to
  48x48 (the tile's grid over 8 and over 4);
- ``image_encoder``: a second ViT-L/16 with its own weights on x2, normed;
- project-upsample branches, a 1x1 conv without bias, then k 2x2
  stride-2 transposed convs without bias: latent0 1024 -> 256, k 3 (768);
  latent1 1024 -> 256, k 2 (384); x0 1024 -> 512, k 1 (192); x1 1024 ->
  1024, k 1 (96); x2 1024 -> 1024, k 1 (48); ``upsample_lowres`` a 2x2
  stride-2 transposed conv with bias on the image encoder's grid and
  ``fuse_lowres`` a 1x1 conv with bias, 2048 -> 1024, on cat(x2, lowres).

Decoder (``decoder``, 256 channels, no BatchNorm): ``convs[0]`` the
identity, the others 3x3 convs without bias to 256; a fusion block is
``out_conv(deconv(resnet2(x + resnet1(skip))))`` with ``resnet(y) =
conv(relu(conv(relu(y)))) + y`` (3x3 convs with bias) and ``deconv`` a 2x2
stride-2 transposed conv without bias in every block but the finest; the
deepest block takes no skip. f = fusions[4](convs[4](fused)), then
fusions[3](f, convs[3](x1)), ..., fusions[0](f, latent0): 768x768x256.
Head (``head``): 3x3 conv 256 -> 128, a 2x2 stride-2 transposed conv 128
-> 128 (1536x1536), 3x3 conv 128 -> 32, ReLU, 1x1 conv 32 -> 1, ReLU.

As Depth Anything V2's port: (B, 3, 1536, 1536) in, (B, 1, 1536, 1536)
float32 out; parameters float32, cast at each use; activations in
``dtype`` but the last 1x1 conv's, float32; attention through the shared
``Attention`` inside ``sdpa_kernel`` of the fused kernels on the card.
``LAUNCHES["tiles"]`` counts the tiles encoded (35 a frame), and
``depth_anything.LAUNCHES["attention"]`` 48 calls a forward (24 batched
over the tiles, 24 of the image encoder). Under ``torch.profiler`` the
forward opens the spans ``patch_encoder`` (split, the batched ViT,
merge), ``image_encoder`` and ``decoder`` (projections, fusion, head).

Module and parameter names are the upstream checkpoint's
(``encoder.patch_encoder.blocks.{i}.attn.qkv``, ``encoder.upsample_latent0.0``,
``decoder.fusions.{k}.resnet1.residual.1``, ``head.{j}``). Departures:

- the output is read as depth, the endoscopy objective's, where upstream
  reads it as canonical inverse depth;
- the FOV head (``fov``, a third ViT-L) is not built: upstream uses it only
  where no focal length is given, and the endoscopy data always give one;
- ``decoder.fusions.4.resnet1`` (the deepest block has no skip) takes no
  part in the forward and is not created (``UNUSED_UPSTREAM_KEYS``): a
  published checkpoint would load with those keys and the FOV head's
  left out;
- the weights are random (``models.init.init_weights``), no checkpoint;
- another ``tile`` or ``patch`` (the tests' tiny geometry) keeps the
  published ratios: the image 4 tiles a side, the paddings a tile's grid
  over 8 and over 4.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from .depth_anything import DinoVisionTransformer, _conv, refuse_fcdensenet_flags

LAUNCHES = {"tiles": 0}  # tiles through the patch encoder in this process
PATCH = 16
TILE = 384
OVERLAPS = (0.25, 0.5)  # of x0's and x1's tiles
HOOKS = (5, 11)  # the patch encoder's blocks whose raw outputs are latent0, latent1
UNUSED_UPSTREAM_KEYS = tuple(f"decoder.fusions.4.resnet1.residual.{i}.{p}"
                             for i in (1, 3) for p in ("weight", "bias"))


def tile_steps(side: int, tile: int, overlap: float) -> int:
    """Tiles a side of a ``side``-pixel image (upstream ``split``)."""
    stride = int(tile * (1 - overlap))
    return int(math.ceil((side - tile) / stride)) + 1


def split(x: torch.Tensor, tile: int, overlap: float) -> torch.Tensor:
    """(B, C, S, S) -> (steps^2 B, C, tile, tile): the sliding-window tiles,
    row-major, tile-major on the batch axis."""
    stride = int(tile * (1 - overlap))
    steps = tile_steps(x.shape[-1], tile, overlap)
    return torch.cat([x[..., j * stride:j * stride + tile, i * stride:i * stride + tile]
                      for j in range(steps) for i in range(steps)], 0)


def merge(x: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """(steps^2 B, rows, cols, C) tile grids, tile-major -> (B, R, R, C):
    each tile drops ``padding`` rows or columns on every side that faces
    another tile (upstream ``merge``, on NHWC grids)."""
    steps = int(round(math.sqrt(x.shape[0] // batch)))
    rows = []
    for j in range(steps):
        row = []
        for i in range(steps):
            t = x[batch * (j * steps + i):batch * (j * steps + i + 1)]
            t = t[:, padding if j else 0:t.shape[1] - (padding if j < steps - 1 else 0),
                  padding if i else 0:t.shape[2] - (padding if i < steps - 1 else 0)]
            row.append(t)
        rows.append(torch.cat(row, 2))
    return torch.cat(rows, 1)


def _grid(tokens: torch.Tensor, side: int) -> torch.Tensor:
    """(N, side*side, C) patch tokens -> (N, side, side, C), a view."""
    return tokens.view(tokens.shape[0], side, side, tokens.shape[-1])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW in channels_last memory, a view of a contiguous x."""
    return x.permute(0, 3, 1, 2)


def _project_upsample(dim_in: int, dim_out: int, layers: int, dim_int: int = None
                      ) -> nn.Sequential:
    """A 1x1 conv without bias, then ``layers`` 2x2 stride-2 transposed
    convs without bias (upstream ``_create_project_upsample_block``)."""
    dim_int = dim_out if dim_int is None else dim_int
    return nn.Sequential(nn.Conv2d(dim_in, dim_int, 1, bias=False), *(
        nn.ConvTranspose2d(dim_int if i == 0 else dim_out, dim_out, 2, stride=2, bias=False)
        for i in range(layers)))


def _sequential(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    for m in seq:
        x = _conv(x, m)
    return x


class DepthProEncoder(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_ratio: float,
                 tile: int, patch: int, dims_encoder: Sequence[int], decoder_features: int,
                 hooks: Sequence[int], init_values: float):
        super().__init__()
        self.tile, self.hooks = tile, tuple(hooks)
        self.grid = tile // patch
        vit = dict(img_size=tile, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                   mlp_ratio=mlp_ratio, init_values=init_values, patch=patch)
        self.patch_encoder = DinoVisionTransformer(**vit)
        self.image_encoder = DinoVisionTransformer(**vit)
        d = list(dims_encoder)
        self.upsample_latent0 = _project_upsample(embed_dim, decoder_features, 3, d[0])
        self.upsample_latent1 = _project_upsample(embed_dim, d[0], 2)
        self.upsample0 = _project_upsample(embed_dim, d[1], 1)
        self.upsample1 = _project_upsample(embed_dim, d[2], 1)
        self.upsample2 = _project_upsample(embed_dim, d[3], 1)
        self.upsample_lowres = nn.ConvTranspose2d(embed_dim, d[3], 2, stride=2)
        self.fuse_lowres = nn.Conv2d(2 * d[3], d[3], 1)

    def encode(self, x: torch.Tensor):
        """The pyramid's tokens: (latent0, latent1, x0, x1, x2, image), NHWC
        grids, the patch encoder's and the image encoder's."""
        b, g = x.shape[0], self.grid
        last = len(self.patch_encoder.blocks) - 1
        with profiling.span("patch_encoder"):
            x1 = F.interpolate(x, scale_factor=0.5, mode="bilinear", align_corners=False)
            x2 = F.interpolate(x, scale_factor=0.25, mode="bilinear", align_corners=False)
            tiles = torch.cat([split(x, self.tile, OVERLAPS[0]),
                               split(x1, self.tile, OVERLAPS[1]), x2], 0)
            LAUNCHES["tiles"] += tiles.shape[0]
            out, hook0, hook1 = self.patch_encoder(tiles, (last,), self.hooks)
            n0 = tile_steps(x.shape[-1], self.tile, OVERLAPS[0]) ** 2 * b
            n1 = tile_steps(x1.shape[-1], self.tile, OVERLAPS[1]) ** 2 * b
            out = _grid(out, g)
            latent0 = merge(_grid(hook0[:n0], g), b, g // 8)
            latent1 = merge(_grid(hook1[:n0], g), b, g // 8)
            f0 = merge(out[:n0], b, g // 8)
            f1 = merge(out[n0:n0 + n1], b, g // 4)
            f2 = out[n0 + n1:]
        with profiling.span("image_encoder"):
            image = _grid(self.image_encoder(x2, (last,))[0], g)
        return latent0, latent1, f0, f1, f2, image

    def project(self, latent0, latent1, f0, f1, f2, image) -> List[torch.Tensor]:
        """The five decoder inputs, NCHW in channels_last memory."""
        f2 = _sequential(_nchw(f2), self.upsample2)
        lowres = _conv(_nchw(image), self.upsample_lowres)
        return [_sequential(_nchw(latent0), self.upsample_latent0),
                _sequential(_nchw(latent1), self.upsample_latent1),
                _sequential(_nchw(f0), self.upsample0),
                _sequential(_nchw(f1), self.upsample1),
                _conv(torch.cat([f2, lowres], 1), self.fuse_lowres)]


class ResidualBlock(nn.Module):
    """conv(relu(conv(relu(y)))) + y, 3x3 convs with bias: Depth Anything
    V2's ``ResidualConvUnit`` under upstream Depth Pro's names
    (``residual.1``, ``residual.3`` of ReLU, conv, ReLU, conv)."""

    def __init__(self, features: int):
        super().__init__()
        self.residual = nn.Sequential(nn.ReLU(), nn.Conv2d(features, features, 3, padding=1),
                                      nn.ReLU(), nn.Conv2d(features, features, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.residual
        return _conv(F.relu(_conv(F.relu(x), r[1])), r[3]) + x


class FeatureFusionBlock2d(nn.Module):
    def __init__(self, features: int, deconv: bool, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resnet1 = ResidualBlock(features)
        self.resnet2 = ResidualBlock(features)
        if deconv:
            self.deconv = nn.ConvTranspose2d(features, features, 2, stride=2, bias=False)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resnet1(skip)
        x = self.resnet2(x)
        if hasattr(self, "deconv"):
            x = _conv(x, self.deconv)
        return _conv(x, self.out_conv)


class MultiresConvDecoder(nn.Module):
    """Inputs of ``dims`` channels, the first already at ``features``
    (``convs[0]`` the identity)."""

    def __init__(self, dims: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Identity()] + [
            nn.Conv2d(c, features, 3, padding=1, bias=False) for c in dims[1:]])
        self.fusions = nn.ModuleList(FeatureFusionBlock2d(features, i != 0, i != len(dims) - 1)
                                     for i in range(len(dims)))

    def forward(self, encodings: Sequence[torch.Tensor]) -> torch.Tensor:
        f = self.fusions[-1](_conv(encodings[-1], self.convs[-1]))
        for i in range(len(encodings) - 2, -1, -1):
            f = self.fusions[i](f, encodings[0] if i == 0 else _conv(encodings[i], self.convs[i]))
        return f


class DepthPro(nn.Module):
    """(B, 3, S, S) -> (B, 1, S, S) float32 depth, nonnegative; S = 4 tiles
    (1536 at the published 384-pixel tile)."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, tile: int = TILE, patch: int = PATCH,
                 dims_encoder: Sequence[int] = (256, 512, 1024, 1024),
                 decoder_features: int = 256, hooks: Sequence[int] = HOOKS,
                 init_values: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.img_size = 4 * tile
        self.encoder = DepthProEncoder(embed_dim, depth, num_heads, mlp_ratio, tile, patch,
                                       dims_encoder, decoder_features, hooks, init_values)
        self.decoder = MultiresConvDecoder([decoder_features] + list(dims_encoder),
                                           decoder_features)
        f = decoder_features
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.ConvTranspose2d(f // 2, f // 2, 2, stride=2),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            raise ValueError(f"Depth Pro takes {self.img_size}x{self.img_size} inputs only, "
                             f"not {x.shape[-2]}x{x.shape[-1]}")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        tokens = self.encoder.encode(x)
        with profiling.span("decoder"):
            features = self.decoder(self.encoder.project(*tokens))
            h = self.head
            y = F.relu(_conv(_conv(_conv(features, h[0]), h[1]), h[2]))
            # the last 1x1 conv (32 -> 1) in float32, as Depth Anything V2's
            depth = F.relu(_conv(y.float(), h[4]))
        return depth


def DepthProLarge(n_classes: int = 1, dtype=torch.float32, **flags) -> DepthPro:
    """``DEFAULT_MONODEPTH_CONFIG_DICT``: patch and image encoders
    ``dinov2l16_384`` (ViT-L/16 at 384: 1024 wide, 24 blocks, 16 heads),
    hooks 5 and 11, encoder dims 256, 512, 1024, 1024, decoder features
    256, no FOV head; 1536x1536 inputs. The FC-DenseNet flags are refused
    when set."""
    refuse_fcdensenet_flags("Depth Pro", n_classes, flags)
    return DepthPro(dtype=dtype)


DepthProLarge.input_size = (4 * TILE, 4 * TILE)  # the one input size it takes

