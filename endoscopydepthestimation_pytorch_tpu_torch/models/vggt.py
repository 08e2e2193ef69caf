"""VGGT (Wang et al., CVPR 2025, arXiv:2503.11651): a DINOv2 patch embedder,
an aggregator of alternating frame-wise and global attention blocks over
the frames of a sequence, and a DPT depth head, as the upstream code
builds them (github.com/facebookresearch/vggt, ``vggt/models/vggt.py``,
``vggt/models/aggregator.py``, ``vggt/layers/rope.py``,
``vggt/heads/dpt_head.py``, ``vggt/heads/utils.py``). ``VGGT1B`` is the
published ``facebook/VGGT-1B`` without its camera, point and track heads;
the trainer offers it as ``--architecture vggt_1b``.

``forward(x, views)`` takes N = S B frames stacked view-major, as
``training._forward_pair`` stacks a pair (frame 1's B rows, then frame
2's): rows i, B + i, ... are one sequence of S = ``views`` frames, view 0
first. One view (``predict_step``, serving) makes every frame its own
sequence, and global attention is then frame attention.

Aggregator (``aggregator``; 1024 wide, 16 heads of 64, MLP 4096):

- ``patch_embed``: DINOv2 ViT-L/14 with 4 register tokens
  (``depth_anything.DinoVisionTransformer``: 24 blocks, LayerNorm eps
  1e-6, LayerScale), its 1 + 37x37 position embedding resized bicubic
  with antialias to the (rows, cols) grid itself (offset 0); the output is
  the final-normed patch tokens, the class and register tokens dropped;
- each frame's tokens are [camera, 4 registers, rows x cols patches]: the
  camera and register tokens are ``camera_token`` (1, 2, 1, C) and
  ``register_token`` (1, 2, 4, C), index 0 for view 0, index 1 for the
  other views (upstream ``slice_expand_and_flatten``);
- 24 pairs of blocks, ``frame_blocks[i]`` on (B S, P, C) and then
  ``global_blocks[i]`` on (B, S P, C), P = 5 + rows cols: pre-norm blocks
  (LayerNorm eps 1e-5) with qkv, proj and MLP biases, exact GELU,
  LayerScale 0.01, a LayerNorm over each head's 64 channels on q and k,
  and then the 2-D RoPE (``rope_tables``) on q and k;
- after pair i, for i in 4, 11, 17, 23, cat(frame output, global output)
  (B S, P, 2048) goes to the head (upstream keeps all 24; the head reads
  these four).

RoPE (upstream ``RotaryPositionEmbedding2D(frequency=100)`` and
``PositionGetter``): a patch token sits at (row + 1, col + 1) and the 5
special tokens at (0, 0); a head's first 32 channels turn by the row,
its last 32 by the column, each a 1-D RoPE with inv_freq = 100^(-2j/32),
j < 16, angles cat(t, t), x cos + rotate_half(x) sin. The tables depend
only on (rows, cols): built in float32 on the host, kept on the device
once per (rows, cols, device, dtype), never read back (upstream's
``int(positions.max())`` reads the device).

Head (``depth_head``, upstream ``DPTHead(dim_in=2048, output_dim=2,
activation="exp", conf_activation="expp1")``): per taken layer the patch
tokens through ``norm`` (LayerNorm 2048, eps 1e-5), then NCHW, the 1x1
``projects``, the UV code (``uv_embed``) x 0.1, the ``resize_layers``
and ``scratch.layer{k}_rn``; the fusion blocks and ``output_conv1`` of
Depth Anything V2's head (``depth_anything.DPTHead``); bilinear with
align_corners to 14 times the patch grid, the UV code again,
``output_conv2`` (3x3 128 -> 32, ReLU, 1x1 32 -> 2, the last in float32);
depth = exp(channel 0), confidence = 1 + exp(channel 1)
(``forward(..., confidence=True)``; the endoscopy objective reads the
depth only).

As Depth Anything V2's port: (N, 3, H, W) in, (N, 1, H, W) float32
depth out, H and W multiples of 14; parameters float32, cast at each use;
activations in ``dtype``; LayerNorm's and softmax's statistics in
float32; attention through ``F.scaled_dot_product_attention`` inside
``sdpa_kernel`` of the fused kernels on the card. ``LAUNCHES`` counts a
forward's frame-wise and global attention calls (24 and 24) and the
frames it sees (``views``, S B); the patch embedder's 24 calls count in
``depth_anything.LAUNCHES["attention"]``. Under ``torch.profiler`` the
forward opens the spans ``patch_embed``, ``aggregator`` and
``depth_head`` (``utils.profiling``).

Module and parameter names are the upstream checkpoint's keys
(``aggregator.frame_blocks.{i}.attn.q_norm``,
``depth_head.scratch.refinenet1.resConfUnit1.conv1``). Departures:

- the camera, point and track heads are not built: the endoscopy
  objective reads only each frame's depth, and they would get no
  gradient; nor ``aggregator.patch_embed.mask_token`` (masked
  pretraining only, ``UNUSED_UPSTREAM_KEYS``): a published checkpoint
  would load with that key and the three heads' left out;
- the input is normalized as the port's other networks' (the data path's
  ``normalize_color``), where upstream normalizes [0, 1] images by
  ResNet's mean and std;
- the weights are random (``models.init.init_weights``), no checkpoint.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from ..utils import profiling
from .depth_anything import (FUSED_ATTENTION, PATCH, Block, DinoVisionTransformer, DPTHead,
                             _conv, _layer_norm, refuse_fcdensenet_flags)

# calls of the aggregator's attention and frames through the network, in
# this process
LAUNCHES = {"frame_attention": 0, "global_attention": 0, "views": 0}
ROPE_FREQUENCY = 100.0
UV_OMEGA = 100.0
UV_RATIO = 0.1
AGGREGATOR_EPS = 1e-5  # nn.LayerNorm's default: the aggregator's blocks and the head's norm
UNUSED_UPSTREAM_KEYS = ("aggregator.patch_embed.mask_token",)
_TABLES: Dict[tuple, Tuple[torch.Tensor, ...]] = {}  # device copies, by shape, device, dtype


def rope_tables(rows: int, cols: int, special: int, head_dim: int,
                frequency: float = ROPE_FREQUENCY) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 2-D RoPE's (cos, sin) (special + rows cols, head_dim), float32 on
    the host, for ``special`` tokens at (0, 0) and then the patches at
    (row + 1, col + 1), row-major; the sin table carries rotate_half's
    sign (``depth_anything.rotate_pairs``)."""
    half = head_dim // 2
    inv_freq = 1.0 / frequency ** (torch.arange(0, half, 2, dtype=torch.float32) / half)
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij")
    pos = torch.stack([r.reshape(-1) + 1, c.reshape(-1) + 1], -1)
    pos = torch.cat([torch.zeros(special, 2, dtype=pos.dtype), pos]).float()
    angles = pos[:, :, None] * inv_freq                       # (P, 2, half / 2)
    angles = torch.cat([angles, angles], -1)                  # cat(t, t) a half
    sign = torch.ones(half)
    sign[:half // 2] = -1.0
    return angles.cos().reshape(-1, head_dim), (angles.sin() * sign).reshape(-1, head_dim)


def uv_embed(rows: int, cols: int, channels: int, aspect: float) -> torch.Tensor:
    """Upstream ``create_uv_grid(cols, rows, aspect)`` and
    ``position_grid_to_embed(., channels, omega_0=100)``, times 0.1:
    (channels, rows, cols) float32 on the host, the grid in float64. x
    spans +-aspect / sqrt(aspect^2 + 1) (cols - 1) / cols and y
    +-1 / sqrt(aspect^2 + 1) (rows - 1) / rows; each half of the channels
    is [sin(p w), cos(p w)] of one coordinate, w = 100^(-k / (channels /
    4)), k < channels / 4: x first, then y."""
    diag = math.sqrt(aspect * aspect + 1.0)
    span_x, span_y = aspect / diag, 1.0 / diag
    x = torch.linspace(-span_x * (cols - 1) / cols, span_x * (cols - 1) / cols, cols,
                       dtype=torch.float64)
    y = torch.linspace(-span_y * (rows - 1) / rows, span_y * (rows - 1) / rows, rows,
                       dtype=torch.float64)
    quarter = channels // 4
    omega = 1.0 / UV_OMEGA ** (torch.arange(quarter, dtype=torch.float64) / quarter)

    def sincos(p):
        out = p[:, None] * omega
        return torch.cat([out.sin(), out.cos()], -1)        # (n, channels / 2)

    ex = sincos(x)[None, :, :].expand(rows, -1, -1)
    ey = sincos(y)[:, None, :].expand(-1, cols, -1)
    emb = torch.cat([ex, ey], -1).float() * UV_RATIO          # (rows, cols, channels)
    return emb.permute(2, 0, 1).contiguous()


def _on(key: tuple, make, device: torch.device, dtype: torch.dtype):
    """``make()``'s host tensors on ``device`` in ``dtype``, made and copied
    once per ``key``: a step captured into a CUDA graph finds them there
    from its eager first run."""
    full = (*key, str(device), dtype)
    if full not in _TABLES:
        _TABLES[full] = tuple(t.to(device=device, dtype=dtype) for t in make())
    return _TABLES[full]


class Aggregator(nn.Module):
    def __init__(self, img_size: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, num_register_tokens: int, init_values: float,
                 patch: int = PATCH):
        super().__init__()
        self.patch = patch
        self.patch_embed = DinoVisionTransformer(
            img_size, embed_dim, depth, num_heads, mlp_ratio, 1.0, patch,
            num_register_tokens=num_register_tokens, interpolate_antialias=True,
            interpolate_offset=0.0)

        def blocks():
            return nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, init_values, qk_norm=True,
                                       eps=AGGREGATOR_EPS, counted=False)
                                 for _ in range(depth))

        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, embed_dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, num_register_tokens, embed_dim))
        self.patch_start_idx = 1 + num_register_tokens

    def forward(self, x: torch.Tensor, views: int, take: Sequence[int]):
        """x (B S, 3, H, W), sequence-major (row b S + s is view s of
        sequence b) -> [cat(frame, global) (B S, P, 2 C) after each pair
        in ``take``, in its order]."""
        n = x.shape[0]
        rows, cols = x.shape[-2] // self.patch, x.shape[-1] // self.patch
        with profiling.span("patch_embed"):
            patches = self.patch_embed(x, (len(self.patch_embed.blocks) - 1,))[0]
        c = patches.shape[-1]

        def per_frame(token):
            """(1, 2, k, C) -> (B S, k, C): index 0 for view 0, 1 for the
            others (each token's gradient then comes back dense)."""
            t = token[0].to(x.dtype)
            t = torch.cat([t[:1], t[1:].expand(views - 1, -1, -1)])
            return t.expand(n // views, -1, -1, -1).reshape(n, -1, c)

        tokens = torch.cat([per_frame(self.camera_token), per_frame(self.register_token),
                            patches], 1)                                      # (B S, P, C)
        p = tokens.shape[1]
        head_dim = c // self.frame_blocks[0].attn.num_heads
        rope = _on(("rope", rows, cols, self.patch_start_idx, head_dim),
                   lambda: rope_tables(rows, cols, self.patch_start_idx, head_dim),
                   x.device, x.dtype)
        rope_global = rope if views == 1 else _on(
            ("rope", rows, cols, self.patch_start_idx, head_dim, views),
            lambda: tuple(t.repeat(views, 1) for t in rope_tables(
                rows, cols, self.patch_start_idx, head_dim)), x.device, x.dtype)
        out = {}
        fused = sdpa_kernel(FUSED_ATTENTION) if x.is_cuda else contextlib.nullcontext()
        with profiling.span("aggregator"), fused:
            for i, (frame, glob) in enumerate(zip(self.frame_blocks, self.global_blocks)):
                LAUNCHES["frame_attention"] += 1
                tokens = frame(tokens, rope)
                frame_out = tokens
                LAUNCHES["global_attention"] += 1
                tokens = glob(tokens.view(n // views, views * p, c), rope_global).view(n, p, c)
                if i in take:
                    out[i] = torch.cat([frame_out, tokens], -1)
        return [out[i] for i in take]


class VGGTDPTHead(DPTHead):
    """Depth Anything V2's DPT head (``depth_anything.DPTHead``) as VGGT's
    depth head builds it: its own LayerNorm on the 2 C-wide taps, the UV
    code after the projections and after the final resize, and a 2-channel
    output (depth, confidence) with no ReLU."""

    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int]):
        super().__init__(in_channels, features, out_channels)
        self.norm = nn.LayerNorm(in_channels, eps=AGGREGATOR_EPS)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 2, 1))

    def _uv(self, x: torch.Tensor, aspect: float) -> torch.Tensor:
        h, w, ch = x.shape[2], x.shape[3], x.shape[1]
        emb, = _on(("uv", h, w, ch, aspect), lambda: (uv_embed(h, w, ch, aspect),),
                   x.device, x.dtype)
        return x + emb[None]

    def forward(self, feats: Sequence[torch.Tensor], rows: int, cols: int, skip: int
                ) -> torch.Tensor:
        """feats [(N, skip + rows cols, 2 C)] -> (N, 2, 14 rows, 14 cols)
        float32: the depth's and the confidence's logits."""
        aspect = cols / rows  # W / H of the input
        levels = []
        for i, x in enumerate(feats):
            x = _layer_norm(x[:, skip:], self.norm)
            x = x.view(x.shape[0], rows, cols, x.shape[-1]).permute(0, 3, 1, 2)
            levels.append(self.level(i, self._uv(_conv(x, self.projects[i]), aspect)))
        out = self._uv(self.fuse(levels, rows, cols), aspect)
        head = self.scratch.output_conv2
        # the last 1x1 conv (32 -> 2) in float32, as Depth Anything V2's
        return _conv(F.relu(_conv(out, head[0])).float(), head[2])


class VGGT(nn.Module):
    """(S B, 3, H, W) frames stacked view-major -> (S B, 1, H, W) float32
    depth, positive; H and W multiples of 14."""

    views_per_pair = 2  # ``training._forward_pair`` hands a pair as one 2-view sequence

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 4,
                 layer_idx: Sequence[int] = (4, 11, 17, 23), features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024), img_size: int = 518,
                 init_values: float = 0.01, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer_idx = tuple(layer_idx)
        self.aggregator = Aggregator(img_size, embed_dim, depth, num_heads, mlp_ratio,
                                     num_register_tokens, init_values)
        self.depth_head = VGGTDPTHead(2 * embed_dim, features, out_channels)

    def forward(self, x: torch.Tensor, views: int = 1, confidence: bool = False):
        """Depth (N, 1, H, W); with ``confidence`` also 1 + exp of the
        second channel."""
        n, _, h, w = x.shape
        if h % PATCH or w % PATCH:
            raise ValueError(f"VGGT takes inputs whose sides are multiples of {PATCH}, not "
                             f"{h}x{w} (--network_downsampling {PATCH})")
        if n % views:
            raise ValueError(f"{n} frames are no whole sequences of {views} views")
        b = n // views
        LAUNCHES["views"] += n
        # view-major (the pair's stacking) -> sequence-major, and back at the end
        x = x.to(self.dtype).view(views, b, *x.shape[1:]).transpose(0, 1).reshape(x.shape)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.aggregator(x, views, self.layer_idx)
        with profiling.span("depth_head"):
            logits = self.depth_head(feats, h // PATCH, w // PATCH,
                                     self.aggregator.patch_start_idx)
            logits = logits.view(b, views, *logits.shape[1:]).transpose(0, 1).reshape(
                logits.shape)
            depth = torch.exp(logits[:, :1])
        return (depth, 1.0 + torch.exp(logits[:, 1:])) if confidence else depth


def VGGT1B(n_classes: int = 1, dtype=torch.float32, **flags) -> VGGT:
    """``facebook/VGGT-1B``'s aggregator (DINOv2 ViT-L/14 with 4 registers,
    24 frame and 24 global blocks 1024 wide, 16 heads, QK-norm, RoPE 100,
    LayerScale 0.01) and depth head (DPT, features 256, out_channels 256,
    512, 1024, 1024, layers 4, 11, 17, 23). The FC-DenseNet flags are
    refused when set."""
    refuse_fcdensenet_flags("VGGT", n_classes, flags)
    return VGGT(dtype=dtype)


VGGT1B.crop_multiple = PATCH  # the input's sides are whole patches
