"""VGGT (Wang et al., CVPR 2025, arXiv:2503.11651), plain PyTorch at
float32: the DINOv2-with-registers patch embedder, the aggregator of
alternating frame-wise and global attention blocks with QK-norm and the
2-D RoPE, and the DPT depth head, as github.com/facebookresearch/vggt
builds them (``vggt/models/aggregator.py``, ``vggt/layers/rope.py``,
``vggt/layers/vision_transformer.py``, ``vggt/heads/dpt_head.py``,
``vggt/heads/utils.py``), written out from the equations with no kernel
of any package: attention as softmax(Q K^T / sqrt(head size)) V on whole
matrices, the RoPE from its angles, TF32 off for matmuls and cuDNN.

It imports neither JAX nor the port, and its module names are the
upstream checkpoint's keys, so one state_dict loads into it and into the
port. Departures from upstream, the port's too: no camera, point or
track head and no ``aggregator.patch_embed.mask_token``; the depth
head's residual units add their input itself (upstream's in-place ReLU
is not modelled). ``forward(x, quant=None, views=2)``: x (S B, 3, H, W)
stacked view-major, as ``reference/objective.loss`` hands a pair
(frame 1's B rows, then frame 2's): rows i, B + i, ... are one sequence,
view 0 first -> (S B, 1, H, W) depth = exp(channel 0). ``quant``, where
given, rounds every matmul's and convolution's activation input (Q, K
and V among them) through another type, as the benchmark's control does
with float8 e4m3. With ``checkpoint_blocks`` set, each transformer
block's forward is recomputed in the backward instead of kept
(``torch.utils.checkpoint``): the same numbers, a fraction of the
memory. ``build(config)`` makes the network from a configuration file's
sizes.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

PATCH = 14
VIT_EPS = 1e-6
EPS = 1e-5

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(m: nn.Linear, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return F.linear(_q(quant, x), m.weight, m.bias)


def _conv(m: nn.Module, x: torch.Tensor, quant: Quant) -> torch.Tensor:
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(_q(quant, x), m.weight, m.bias, m.stride, m.padding)
    return F.conv2d(_q(quant, x), m.weight, m.bias, m.stride, m.padding)


def rope_1d(x: torch.Tensor, pos: torch.Tensor, frequency: float) -> torch.Tensor:
    """x (B, H, N, D) turned by the integer positions pos (B, N): angles
    pos / frequency^(2j / D), j < D / 2, as cat(t, t); x cos + cat(-x2, x1)
    sin."""
    d = x.shape[-1]
    inv_freq = 1.0 / frequency ** (torch.arange(0, d, 2, device=x.device).float() / d)
    angles = pos.float()[..., None] * inv_freq                     # (B, N, D / 2)
    angles = torch.cat([angles, angles], -1)[:, None]              # (B, 1, N, D)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * angles.cos() + torch.cat([-x2, x1], -1) * angles.sin()


def rope_2d(x: torch.Tensor, pos: torch.Tensor, frequency: float = 100.0) -> torch.Tensor:
    """The first half of the head's channels turned by pos[..., 0] (the
    row), the second half by pos[..., 1] (the column)."""
    rows, cols = x.chunk(2, -1)
    return torch.cat([rope_1d(rows, pos[..., 0], frequency),
                      rope_1d(cols, pos[..., 1], frequency)], -1)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qk_norm: bool):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // heads, eps=EPS)
            self.k_norm = nn.LayerNorm(dim // heads, eps=EPS)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor], quant: Quant):
        b, n, c = x.shape
        d = c // self.heads
        q, k, v = _linear(self.qkv, x, quant).reshape(b, n, 3, self.heads, d
                                                       ).permute(2, 0, 3, 1, 4)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if pos is not None:
            q, k = rope_2d(q, pos), rope_2d(k, pos)
        q, k, v = _q(quant, q), _q(quant, k), _q(quant, v)
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
    def __init__(self, dim: int, heads: int, mlp_ratio: float, qk_norm: bool, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, qk_norm)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor], quant: Quant):
        x = x + self.ls1.gamma * self.attn(self.norm1(x), pos, quant)
        return x + self.ls2.gamma * self.mlp(self.norm2(x), quant)


def _run(block: Block, x: torch.Tensor, pos, quant: Quant, checkpoint: bool):
    if checkpoint and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, x, pos, quant, use_reentrant=False)
    return block(x, pos, quant)


class DinoV2(nn.Module):
    """DINOv2 with register tokens (``vision_transformer.py``): the class
    token, the position embedding resized bicubic with antialias to the
    input's grid, then the registers; the final-normed patch tokens out."""

    def __init__(self, img_size: int, dim: int, depth: int, heads: int, mlp_ratio: float,
                 registers: int):
        super().__init__()
        grid = img_size // PATCH
        self.patch_embed = PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, registers, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, False, VIT_EPS)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=VIT_EPS)
        self.checkpoint_blocks = False

    def position(self, rows: int, cols: int) -> torch.Tensor:
        grid = int(math.sqrt(self.pos_embed.shape[1] - 1))
        if rows == cols == grid:
            return self.pos_embed
        dim = self.pos_embed.shape[-1]
        patches = self.pos_embed[:, 1:].reshape(1, grid, grid, dim).permute(0, 3, 1, 2)
        patches = F.interpolate(patches, size=(rows, cols), mode="bicubic", antialias=True)
        return torch.cat([self.pos_embed[:, :1],
                          patches.permute(0, 2, 3, 1).reshape(1, rows * cols, dim)], 1)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        b, _, h, w = x.shape
        tokens = _conv(self.patch_embed.proj, x, quant).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
        tokens = tokens + self.position(h // PATCH, w // PATCH)
        registers = self.register_tokens.shape[1]
        tokens = torch.cat([tokens[:, :1], self.register_tokens.expand(b, -1, -1),
                            tokens[:, 1:]], 1)
        for block in self.blocks:
            tokens = _run(block, tokens, None, quant, self.checkpoint_blocks)
        return self.norm(tokens)[:, 1 + registers:]


class Aggregator(nn.Module):
    def __init__(self, img_size: int, dim: int, depth: int, heads: int, mlp_ratio: float,
                 registers: int):
        super().__init__()
        self.patch_embed = DinoV2(img_size, dim, depth, heads, mlp_ratio, registers)
        self.frame_blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, True, EPS)
                                          for _ in range(depth))
        self.global_blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, True, EPS)
                                           for _ in range(depth))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, registers, dim))
        self.patch_start_idx = 1 + registers
        self.checkpoint_blocks = False

    @staticmethod
    def _first_and_others(token: torch.Tensor, b: int, s: int) -> torch.Tensor:
        """upstream ``slice_expand_and_flatten``: index 0 for each sequence's
        first frame, index 1 for the others, (B S, k, C)."""
        first = token[:, 0:1].expand(b, 1, *token.shape[2:])
        others = token[:, 1:].expand(b, s - 1, *token.shape[2:])
        return torch.cat([first, others], 1).reshape(b * s, *token.shape[2:])

    def forward(self, images: torch.Tensor, quant: Quant) -> List[torch.Tensor]:
        """images (B, S, 3, H, W) -> [cat(frame, global) (B, S, P, 2 C) after
        each pair], as upstream returns them."""
        b, s, _, h, w = images.shape
        rows, cols = h // PATCH, w // PATCH
        patches = self.patch_embed(images.reshape(b * s, 3, h, w), quant)
        tokens = torch.cat([self._first_and_others(self.camera_token, b, s),
                            self._first_and_others(self.register_token, b, s), patches], 1)
        _, p, c = tokens.shape
        # upstream PositionGetter: (row, col) of every patch, + 1; the special
        # tokens at (0, 0)
        grid = torch.cartesian_prod(torch.arange(rows), torch.arange(cols)) + 1
        pos = torch.cat([torch.zeros(self.patch_start_idx, 2, dtype=grid.dtype), grid])
        pos = pos.to(images.device)[None].expand(b * s, -1, -1)
        keep = self.checkpoint_blocks
        out = []
        for i in range(len(self.frame_blocks)):
            tokens = _run(self.frame_blocks[i], tokens.reshape(b * s, p, c),
                          pos.reshape(b * s, p, 2), quant, keep)
            frame = tokens.reshape(b, s, p, c)
            tokens = _run(self.global_blocks[i], tokens.reshape(b, s * p, c),
                          pos.reshape(b, s * p, 2), quant, keep)
            out.append(torch.cat([frame, tokens.reshape(b, s, p, c)], -1))
        return out


def uv_grid(width: int, height: int, aspect: float, device) -> torch.Tensor:
    """upstream ``create_uv_grid``: (height, width, 2) in float64."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    x = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width,
                       dtype=torch.float64, device=device)
    y = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height,
                       dtype=torch.float64, device=device)
    uu, vv = torch.meshgrid(x, y, indexing="xy")
    return torch.stack([uu, vv], -1)


def sincos(dim: int, pos: torch.Tensor, omega_0: float = 100.0) -> torch.Tensor:
    """upstream ``make_sincos_pos_embed``: (M, dim) [sin, cos] in float64."""
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    omega = 1.0 / omega_0 ** omega
    out = pos.reshape(-1)[:, None] * omega[None]
    return torch.cat([out.sin(), out.cos()], 1)


def add_uv(x: torch.Tensor, width: int, height: int, ratio: float = 0.1) -> torch.Tensor:
    """upstream ``DPTHead._apply_pos_embed``: x (N, C, h, w) plus 0.1 times
    ``position_grid_to_embed(create_uv_grid(w, h, W / H), C)``."""
    c, h, w = x.shape[1:]
    grid = uv_grid(w, h, width / height, x.device).reshape(-1, 2)
    emb = torch.cat([sincos(c // 2, grid[:, 0]), sincos(c // 2, grid[:, 1])], -1)
    emb = emb.float().reshape(h, w, c).permute(2, 0, 1)[None] * ratio
    return x + emb


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        out = _conv(self.conv1, F.relu(x), quant)
        return x + _conv(self.conv2, F.relu(out), quant)


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None, quant: Quant = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip, quant)
        x = self.resConfUnit2(x, quant)
        x = (F.interpolate(x, size=size, mode="bilinear", align_corners=True) if size is not None
             else F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True))
        return _conv(self.out_conv, x, quant)


class DPTHead(nn.Module):
    def __init__(self, dim_in: int, features: int, out_channels: Sequence[int]):
        super().__init__()
        c = list(out_channels)
        self.norm = nn.LayerNorm(dim_in, eps=EPS)
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, oc, 1) for oc in c)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4), nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(), nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, ci in enumerate(c, 1):
            setattr(self.scratch, f"layer{i}_rn", nn.Conv2d(ci, features, 3, padding=1,
                                                            bias=False))
        for k in (1, 2, 3, 4):
            setattr(self.scratch, f"refinenet{k}", FeatureFusionBlock(features, k != 4))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 2, 1))

    def forward(self, tokens: Sequence[torch.Tensor], start: int, height: int, width: int,
                quant: Quant) -> torch.Tensor:
        """tokens [(B, S, P, 2 C)] -> (B S, 2, height, width) logits."""
        rows, cols = height // PATCH, width // PATCH
        s = self.scratch
        levels = []
        for i, t in enumerate(tokens):
            x = t[:, :, start:]
            x = self.norm(x.reshape(-1, x.shape[-2], x.shape[-1]))
            x = x.permute(0, 2, 1).reshape(x.shape[0], x.shape[-1], rows, cols)
            x = add_uv(_conv(self.projects[i], x, quant), width, height)
            resize = self.resize_layers[i]
            x = x if isinstance(resize, nn.Identity) else _conv(resize, x, quant)
            levels.append(_conv(getattr(s, f"layer{i + 1}_rn"), x, quant))
        l1, l2, l3, l4 = levels
        out = s.refinenet4(l4, size=l3.shape[2:], quant=quant)
        out = s.refinenet3(out, l3, size=l2.shape[2:], quant=quant)
        out = s.refinenet2(out, l2, size=l1.shape[2:], quant=quant)
        out = s.refinenet1(out, l1, quant=quant)
        out = _conv(s.output_conv1, out, quant)
        out = F.interpolate(out, size=(rows * PATCH, cols * PATCH), mode="bilinear",
                            align_corners=True)
        out = add_uv(out, width, height)
        head = s.output_conv2
        return _conv(head[2], F.relu(_conv(head[0], out, quant)), quant)


class VGGT(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int, mlp_ratio: float,
                 registers: int, layer_idx: Sequence[int], features: int,
                 out_channels: Sequence[int], img_size: int):
        super().__init__()
        self.layer_idx = tuple(layer_idx)
        self.aggregator = Aggregator(img_size, embed_dim, depth, num_heads, mlp_ratio, registers)
        self.depth_head = DPTHead(2 * embed_dim, features, out_channels)

    @property
    def checkpoint_blocks(self) -> bool:
        return self.aggregator.checkpoint_blocks

    @checkpoint_blocks.setter
    def checkpoint_blocks(self, on: bool) -> None:
        self.aggregator.checkpoint_blocks = on
        self.aggregator.patch_embed.checkpoint_blocks = on

    def logits(self, x: torch.Tensor, quant: Quant = None, views: int = 2) -> torch.Tensor:
        """x (S B, 3, H, W) view-major -> (S B, 2, H, W), view-major."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = x.float()
        n, _, h, w = x.shape
        b = n // views
        images = x.reshape(views, b, 3, h, w).transpose(0, 1)       # (B, S, 3, H, W)
        tokens = self.aggregator(images, quant)
        out = self.depth_head([tokens[i] for i in self.layer_idx],
                              self.aggregator.patch_start_idx, h, w, quant)
        return out.reshape(b, views, 2, h, w).transpose(0, 1).reshape(n, 2, h, w)

    def forward(self, x: torch.Tensor, quant: Quant = None, views: int = 2) -> torch.Tensor:
        return torch.exp(self.logits(x, quant, views)[:, :1])


def build(config: dict) -> VGGT:
    model = VGGT(config["embed_dim"], config["depth"], config["num_heads"], config["mlp_ratio"],
                 config["num_register_tokens"], config["intermediate_layer_idx"],
                 config["features"], config["out_channels"], config["img_size"])
    model.checkpoint_blocks = bool(config.get("reference_checkpoint_blocks", False))
    return model
