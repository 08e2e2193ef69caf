"""The tiling of the bf16 3x3 implicit-GEMM forward in ``csrc/conv3x3_mma.cuh``.

K1 (``ops/dense_conv``) and the block engine's K4 (``ops/block_engine``)
launch that one kernel body, so both wrappers must agree with it on the
256-pixel tile, the 16-channel chunks and how the chunks split across
blocks where the tiles are few. That policy lives here; each caller passes
its own split threshold, measured on an H100 at its own shapes. The bf16
K5 takes the same tile (``mma_tile``).
"""
from __future__ import annotations

from typing import Tuple

import torch

MMA_PIXELS = 256       # the tile: 256 pixels, 32, 16 or 8 wide
CHUNK = 16             # channels per chunk (the MMA's K per tap)
FORWARD_BLOCKS = 256   # split chunks across about this many blocks (an H100's SMs)
FFMA_TILE = (16, 32)   # the f32 forwards' (tile_h, tile_w), K1's and K4's


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def n_tiles(b: int, h: int, w: int, tile_h: int, tile_w: int) -> int:
    """Tiles of (tile_h, tile_w) that cover b images of h x w."""
    return b * _ceil(h, tile_h) * _ceil(w, tile_w)


def mma_tile(h: int, w: int) -> Tuple[int, int]:
    """The bf16 kernels' (tile_h, tile_w): 256 pixels in the width of 32,
    16 and 8 that pads an (h, w) image least, the widest on a tie."""
    return min(((MMA_PIXELS // tw, tw) for tw in (32, 16, 8)),
               key=lambda t: _ceil(h, t[0]) * t[0] * _ceil(w, t[1]) * t[1])


def forward_tiling(dtype: torch.dtype, b: int, h: int, w: int, c: int,
                   split_below: int) -> Tuple[int, int, int]:
    """(tile_h, tile_w, n_split) of the forward over x (b, h, w, c): in
    bf16 the tile of ``mma_tile``, and where the tiles are fewer than
    ``split_below``, the 16-channel chunks split evenly across about
    ``FORWARD_BLOCKS`` blocks, their f32 partials summed in order by a
    second pass; in f32 the FFMA kernels' 16x32 tile, no split."""
    if dtype != torch.bfloat16:
        return (*FFMA_TILE, 1)
    tile_h, tile_w = mma_tile(h, w)
    tiles = n_tiles(b, h, w, tile_h, tile_w)
    if tiles >= split_below:
        return tile_h, tile_w, 1
    return tile_h, tile_w, min(_ceil(c, CHUNK), _ceil(FORWARD_BLOCKS, tiles))
