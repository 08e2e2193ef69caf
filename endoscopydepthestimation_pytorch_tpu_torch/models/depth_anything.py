"""Depth Anything V2 (Yang et al., NeurIPS 2024, arXiv:2406.09414): a
DINOv2 vision transformer (Oquab et al., arXiv:2304.07193) and a DPT head,
as the upstream code builds them (github.com/DepthAnything/Depth-Anything-V2,
``depth_anything_v2/dpt.py`` and ``dinov2.py``). ``DepthAnythingV2Large``
is its ``model_configs['vitl']``; the trainer offers it as
``--architecture depth_anything_v2_vitl``.

Encoder, DINOv2 ViT-L/14 (``pretrained``):

- a 14x14 stride-14 convolution embeds the patches, 3 -> 1024 channels, and
  a class token goes first;
- a learned 1 + 37x37 position embedding, resized to the input's grid by
  bicubic interpolation with scale factors (rows + 0.1)/37 and
  (cols + 0.1)/37, no antialias (DINOv2's ``interpolate_pos_encoding``);
  a square input of the stored grid takes it as it is;
- 24 pre-norm blocks, ``x += ls1 * attn(LN(x))``, ``x += ls2 * mlp(LN(x))``:
  LayerNorm eps 1e-6, 16 heads of 64 with qkv and proj biases,
  softmax(q k^T / 8) v, an MLP 1024 -> 4096 -> 1024 with exact GELU,
  LayerScale vectors;
- the outputs of blocks 4, 11, 17 and 23 each through the final LayerNorm,
  the class token dropped.

Head, DPT (``depth_head``; features 256, out_channels 256, 512, 1024,
1024, no BatchNorm, no class-token readout): per taken layer a 1x1
projection, then a 4x4 stride-4 transposed conv, a 2x2 stride-2
transposed conv, identity, or a 3x3 stride-2 conv; 3x3 convs to 256
channels without bias (``scratch.layer{1..4}_rn``); four fusion blocks
from the deepest up, each (skip through a pre-activation ReLU residual
unit, added), a second residual unit, bilinear resizing with
align_corners to the next level's size (the last: x2), a 1x1
``out_conv``; ``output_conv1`` (3x3, 256 -> 128), bilinear resizing to 14
times the patch grid, ``output_conv2`` (3x3 128 -> 32, ReLU, 1x1 32 -> 1,
ReLU).

As the FC-DenseNet port: (B, 3, H, W) in, (B, 1, H, W) float32 out;
parameters float32, cast at each use, activations in ``dtype`` but the
last 1x1 conv's, float32, so the depth is never rounded to ``dtype``;
LayerNorm's and softmax's statistics in float32 (PyTorch's kernels keep
them so for bfloat16 inputs); convolutions in channels_last memory. H and
W must be multiples of 14.

Attention is ``F.scaled_dot_product_attention``, on the card only inside
``sdpa_kernel([CUDNN_ATTENTION, FLASH_ATTENTION])``: a call that neither
fused kernel takes raises instead of falling back to the math path.
``LAUNCHES["attention"]`` counts its calls, one a block a forward. Under
``torch.profiler`` the forward opens the spans ``encoder`` and
``dpt_head`` (``utils.profiling``). The ViT's blocks and its DPT head
also serve VGGT (``models/vggt.py``): QK-norm and the 2-D RoPE in
``Attention``, register tokens and the antialiased offset-0 position
resize in ``DinoVisionTransformer``, each off by default.

Module and parameter names are the upstream checkpoint's keys
(``pretrained.blocks.{i}.attn.qkv``, ``depth_head.scratch.refinenet{k}``).
Departures from upstream:

- the output is read as depth, the endoscopy objective's, where upstream
  reads it as relative inverse depth;
- ``pretrained.mask_token`` (masked pretraining only) and
  ``depth_head.scratch.refinenet4.resConfUnit1`` (the deepest fusion block
  has no skip) take no part in the forward and are not created:
  ``training.train_step`` takes the gradient of every parameter, and they
  would have none. ``load_upstream_state_dict`` loads a published
  checkpoint with exactly those keys (``UNUSED_UPSTREAM_KEYS``) left out;
- the weights are random (``models.init.init_weights``), no checkpoint;
- the channel of the output is kept, (B, 1, H, W), where upstream
  squeezes it.
"""
from __future__ import annotations

import contextlib
from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils import profiling

LAUNCHES = {"attention": 0}  # scaled_dot_product_attention calls in this process
FUSED_ATTENTION = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]
PATCH = 14
LN_EPS = 1e-6
INTERPOLATE_OFFSET = 0.1
UNUSED_UPSTREAM_KEYS = ("pretrained.mask_token",) + tuple(
    f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.{p}"
    for conv in ("conv1", "conv2") for p in ("weight", "bias"))


def _linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype), m.bias.to(x.dtype),
                        m.eps)


def _conv(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    """``m`` (a Conv2d or ConvTranspose2d) at ``x``'s dtype."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    fn = F.conv_transpose2d if isinstance(m, nn.ConvTranspose2d) else F.conv2d
    return fn(x, m.weight.to(x.dtype), bias, m.stride, m.padding)


def _resize(x: torch.Tensor, size=None) -> torch.Tensor:
    """Bilinear, align_corners, to ``size`` or x2 (upstream's interpolate)."""
    return F.interpolate(x, size=size, scale_factor=None if size is not None else 2,
                         mode="bilinear", align_corners=True)


def interpolate_pos_embed(pos_embed: torch.Tensor, rows: int, cols: int,
                          antialias: bool = False,
                          offset: float = INTERPOLATE_OFFSET) -> torch.Tensor:
    """The 1 + g*g position embedding (1, 1 + g*g, C) resized to a rows x
    cols grid, float32 (DINOv2 ``interpolate_pos_encoding``): bicubic at
    the scale factors ((rows + offset)/g, (cols + offset)/g), or to the
    size (rows, cols) itself where ``offset`` is 0, with ``antialias`` as
    given; at rows = cols = g as it is."""
    grid = int(round((pos_embed.shape[1] - 1) ** 0.5))
    pos = pos_embed.float()
    if rows == cols == grid:
        return pos
    dim = pos.shape[-1]
    size = dict(size=(rows, cols)) if offset == 0 else dict(
        scale_factor=((rows + offset) / grid, (cols + offset) / grid))
    patches = F.interpolate(
        pos[:, 1:].reshape(1, grid, grid, dim).permute(0, 3, 1, 2),
        mode="bicubic", antialias=antialias, **size)
    if patches.shape[-2:] != (rows, cols):
        raise AssertionError(f"position grid {tuple(patches.shape[-2:])}, wanted {(rows, cols)}")
    return torch.cat([pos[:, :1], patches.permute(0, 2, 3, 1).reshape(1, rows * cols, dim)], 1)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.init_values = float(init_values)
        self.gamma = nn.Parameter(torch.full((dim,), self.init_values))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int = PATCH):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


def rotate_pairs(x: torch.Tensor, tables) -> torch.Tensor:
    """x (..., N, d) rotated by ``rope_tables``' (cos, sin) (N, d): each half
    of the d channels is a 1-D RoPE, x cos + rotate_half(x) sin with
    rotate_half(y) = cat(-y2, y1) over the half's two quarters; the sign
    rides in the sin table."""
    cos, sin = tables
    swapped = x.unflatten(-1, (2, 2, -1)).flip(-2).flatten(-3)
    return x * cos + swapped * sin


class Attention(nn.Module):
    """softmax(q k^T / sqrt(head size)) v over ``num_heads`` heads, with
    qkv and proj biases. ``qk_norm`` puts a LayerNorm over each head's
    channels (eps 1e-5, PyTorch's default, as VGGT's blocks) on q and on
    k; ``forward(x, rope)`` then rotates q and k by ``rope``'s tables
    (``rotate_pairs``). ``counted``: its calls add to
    ``LAUNCHES["attention"]`` (a caller that counts them itself says
    False)."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False, counted: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.counted = counted
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads)
            self.k_norm = nn.LayerNorm(dim // num_heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = _linear(x, self.qkv).view(b, n, 3, self.num_heads, c // self.num_heads
                                            ).permute(2, 0, 3, 1, 4).unbind(0)
        if hasattr(self, "q_norm"):
            q, k = _layer_norm(q, self.q_norm), _layer_norm(k, self.k_norm)
        if rope is not None:
            q, k = rotate_pairs(q, rope), rotate_pairs(k, rope)
        if self.counted:
            LAUNCHES["attention"] += 1
        out = F.scaled_dot_product_attention(q, k, v)  # scale 1/sqrt(head size)
        return _linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float,
                 qk_norm: bool = False, eps: float = LN_EPS, counted: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qk_norm, counted)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1), rope) * self.ls1.gamma.to(x.dtype)
        return x + self.mlp(_layer_norm(x, self.norm2)) * self.ls2.gamma.to(x.dtype)


class DinoVisionTransformer(nn.Module):
    """The DINOv2 encoder at ``patch`` pixels a patch, its position
    embedding stored for the img_size / patch grid; ``forward(x, take,
    raw)`` returns the normalized patch tokens (B, rows * cols, C) after
    each block in ``take``, then the raw ones (no final LayerNorm) after
    each block in ``raw``. With ``num_register_tokens`` (DINOv2 with
    registers) that many learned tokens follow the class token, inserted
    after the position embedding is added, and are dropped from the
    outputs as the class token is; ``interpolate_antialias`` and
    ``interpolate_offset`` are ``interpolate_pos_embed``'s."""

    def __init__(self, img_size: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, init_values: float = 1.0, patch: int = PATCH,
                 num_register_tokens: int = 0, interpolate_antialias: bool = False,
                 interpolate_offset: float = INTERPOLATE_OFFSET):
        super().__init__()
        self.patch = patch
        self.interpolate = dict(antialias=interpolate_antialias, offset=interpolate_offset)
        grid = img_size // patch
        self.patch_embed = PatchEmbed(embed_dim, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, embed_dim))
        self.skip = 1 + num_register_tokens  # tokens before the patches
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, init_values)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, take: Sequence[int],
                raw: Sequence[int] = ()) -> List[torch.Tensor]:
        b = x.shape[0]
        rows, cols = x.shape[-2] // self.patch, x.shape[-1] // self.patch
        patches = _conv(x, self.patch_embed.proj)            # (B, C, rows, cols)
        patches = patches.permute(0, 2, 3, 1).reshape(b, rows * cols, -1)
        tokens = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), patches], 1)
        tokens = tokens + interpolate_pos_embed(self.pos_embed, rows, cols,
                                                **self.interpolate).to(x.dtype)
        if self.skip > 1:
            tokens = torch.cat([tokens[:, :1], self.register_tokens.to(x.dtype).expand(b, -1, -1),
                                tokens[:, 1:]], 1)
        out, taps = [], []
        fused = sdpa_kernel(FUSED_ATTENTION) if x.is_cuda else contextlib.nullcontext()
        with fused:
            for i, block in enumerate(self.blocks):
                tokens = block(tokens)
                if i in take:
                    out.append(_layer_norm(tokens, self.norm)[:, self.skip:])
                if i in raw:
                    taps.append(tokens[:, self.skip:])
        return out + taps


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(F.relu(_conv(F.relu(x), self.conv1)), self.conv2) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None, size=None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return _conv(_resize(self.resConfUnit2(x), size), self.out_conv)


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in out_channels)
        c = out_channels
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4), nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(), nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, ci in enumerate(out_channels, 1):
            setattr(self.scratch, f"layer{i}_rn", nn.Conv2d(ci, features, 3, padding=1,
                                                            bias=False))
        for k in (1, 2, 3, 4):
            setattr(self.scratch, f"refinenet{k}", FeatureFusionBlock(features, k != 4))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU(), nn.Identity())

    def level(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Level i's projected map through its resize layer and
        ``scratch.layer{i + 1}_rn``."""
        resize = self.resize_layers[i]
        x = x if isinstance(resize, nn.Identity) else _conv(x, resize)
        return _conv(x, getattr(self.scratch, f"layer{i + 1}_rn"))

    def fuse(self, levels: Sequence[torch.Tensor], rows: int, cols: int) -> torch.Tensor:
        """The fusion blocks from the deepest level up, ``output_conv1`` and
        the resize to 14 times the patch grid."""
        s = self.scratch
        l1, l2, l3, l4 = levels
        path = s.refinenet4(l4, size=l3.shape[2:])
        path = s.refinenet3(path, l3, size=l2.shape[2:])
        path = s.refinenet2(path, l2, size=l1.shape[2:])
        path = s.refinenet1(path, l1)
        return _resize(_conv(path, s.output_conv1), (rows * PATCH, cols * PATCH))

    def forward(self, feats: Sequence[torch.Tensor], rows: int, cols: int) -> torch.Tensor:
        levels = []
        for i, x in enumerate(feats):
            # (B, rows*cols, C) -> NCHW in channels_last memory, a view
            x = x.view(x.shape[0], rows, cols, x.shape[-1]).permute(0, 3, 1, 2)
            levels.append(self.level(i, _conv(x, self.projects[i])))
        out = self.fuse(levels, rows, cols)
        head = self.scratch.output_conv2
        # the last 1x1 conv (32 -> 1) in float32: the depth is not rounded to
        # bfloat16, whose spacing near 3 (0.016) is a tenth of a conditioned
        # depth's spread over a frame
        return F.relu(_conv(F.relu(_conv(out, head[0])).float(), head[2]))


class DepthAnythingV2(nn.Module):
    """(B, 3, H, W) -> (B, 1, H, W) float32 depth, nonnegative; H and W
    multiples of 14."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, layer_idx: Sequence[int] = (4, 11, 17, 23),
                 features: int = 256, out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 img_size: int = 518, init_values: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer_idx = tuple(layer_idx)
        self.pretrained = DinoVisionTransformer(img_size, embed_dim, depth, num_heads,
                                                mlp_ratio, init_values)
        self.depth_head = DPTHead(embed_dim, features, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % PATCH or w % PATCH:
            raise ValueError(f"Depth Anything V2 takes inputs whose sides are multiples of "
                             f"{PATCH}, not {h}x{w} (--network_downsampling {PATCH})")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        with profiling.span("encoder"):
            feats = self.pretrained(x, self.layer_idx)
        with profiling.span("dpt_head"):
            depth = self.depth_head(feats, h // PATCH, w // PATCH)
        return depth.float()


FCDENSENET_FLAGS = ("act8", "remat", "block_engine")


def refuse_fcdensenet_flags(network: str, n_classes: int, flags) -> None:
    """A transformer builder's refusals: the FC-DenseNet flags (``act8``,
    ``remat``, ``block_engine``) when set, and more than one channel."""
    given = [f"--{f}" for f in FCDENSENET_FLAGS if flags.get(f)]
    if given:
        raise ValueError(f"{', '.join(given)} applies only to FC-DenseNet, not to "
                         f"{network}")
    if n_classes != 1:
        raise ValueError(f"{network} predicts one channel, not {n_classes}")


def DepthAnythingV2Large(n_classes: int = 1, dtype=torch.float32, **flags) -> DepthAnythingV2:
    """``model_configs['vitl']``: ViT-L/14 (1024 wide, 24 blocks, 16 heads),
    layers 4, 11, 17, 23, DPT features 256, out_channels 256, 512, 1024,
    1024. The FC-DenseNet flags (``act8``, ``remat``, ``block_engine``)
    do not apply to it and are refused when set."""
    refuse_fcdensenet_flags("Depth Anything V2", n_classes, flags)
    return DepthAnythingV2(dtype=dtype)


DepthAnythingV2Large.crop_multiple = PATCH  # the input's sides are whole patches


def load_upstream_state_dict(model: DepthAnythingV2, state_dict: Mapping[str, torch.Tensor]):
    """Load a published Depth Anything V2 checkpoint: every key but
    ``UNUSED_UPSTREAM_KEYS``, strictly."""
    missing = [k for k in UNUSED_UPSTREAM_KEYS if k not in state_dict]
    if missing:
        raise KeyError(f"not an upstream Depth Anything V2 checkpoint: no {missing}")
    return model.load_state_dict({k: v for k, v in state_dict.items()
                                  if k not in UNUSED_UPSTREAM_KEYS}, strict=True)
