"""Operations and bytes of VGGT (``configs/vggt_1b.json``), counted from the
configuration's shapes: the DINOv2 patch embedder's and the 24 frame and
24 global blocks' matmuls and attention, and every convolution and
transposed convolution of the DPT depth head.

B pairs at H x W are S = 2 views each, 2B frames of rows x cols patches
(rows = H / 14):

- the patch embedder runs 2B sequences of 1 + 4 + rows cols tokens (the
  class token and the registers);
- a frame block runs 2B sequences and a global block B sequences of 2
  frames, P = 5 + rows cols tokens a frame (the camera token and the
  registers);
- a block does 2 N d (3 d + d + 2 x 4 d) matmul operations and 4 N^2 d of
  attention on a sequence of N tokens (2 per multiply-add);
- the head runs on every frame at its 2 d-wide taps: Depth Anything V2's
  head (``roofline_attention.head_flops``) with projections from 2 d and a
  2-channel last conv.

Elementwise work (norms, RoPE, the UV code, GELU, the residual sums) is
left out.
"""
from __future__ import annotations

from typing import Tuple

from . import roofline, roofline_attention


def tokens(config: dict, height: int, width: int) -> Tuple[int, int]:
    """(the patch embedder's tokens a frame, the aggregator's P)."""
    p = config["patch_size"]
    patches = (height // p) * (width // p)
    return 1 + config["num_register_tokens"] + patches, config["special_tokens"] + patches


def _blocks(config: dict, sequences: int, n: int) -> float:
    """A stack of ``depth`` blocks over ``sequences`` of ``n`` tokens."""
    d = config["embed_dim"]
    hidden = int(d * config["mlp_ratio"])
    return sequences * config["depth"] * (2.0 * n * d * (4 * d + 2 * hidden) + 4.0 * n * n * d)


def patch_embed_flops(config: dict, frames: int, height: int, width: int) -> float:
    p, d = config["patch_size"], config["embed_dim"]
    patches = (height // p) * (width // p)
    n, _ = tokens(config, height, width)
    return frames * 2.0 * patches * 3 * p * p * d + _blocks(config, frames, n)


def aggregator_flops(config: dict, pairs: int, height: int, width: int,
                     views: int = 2) -> float:
    """The frame blocks over every frame and the global blocks over every
    sequence of ``views`` frames."""
    _, p = tokens(config, height, width)
    return _blocks(config, pairs * views, p) + _blocks(config, pairs, views * p)


def head_flops(config: dict, frames: int, height: int, width: int) -> float:
    """Depth Anything V2's count with its embed width the taps' (2 d) and a
    last conv 32 -> 2 where Depth Anything V2's is 32 -> 1."""
    c = dict(config, embed_dim=config["dim_in"])
    extra = 2.0 * height * width * 32 * (config["output_dim"] - 1)
    return roofline_attention.head_flops(c, frames, height, width) + frames * extra


def forward_flops(config: dict, pairs: int, height: int, width: int, views: int = 2) -> float:
    frames = pairs * views
    return (patch_embed_flops(config, frames, height, width)
            + aggregator_flops(config, pairs, height, width, views)
            + head_flops(config, frames, height, width))


def step_attention_bound_s(config: dict, pairs: int, height: int, width: int, itemsize: int,
                           views: int = 2) -> float:
    """The least device time of one train step's attention: a forward and
    a backward call a block, the patch embedder's and the frame blocks'
    over every frame, the global blocks' over every sequence of ``views``
    frames."""
    n, p = tokens(config, height, width)
    frames = pairs * views
    total = 0.0
    for images, length in ((frames, n), (frames, p), (pairs, views * p)):
        counts = roofline_attention.attention_counts(images, config["num_heads"], length,
                                                     config["head_dim"], itemsize)
        total += roofline.sum_bounds_s(counts.values(), "bfloat16")
    return config["depth"] * total
