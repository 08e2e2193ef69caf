"""FC-DenseNet's fused dense layer: y = conv3x3(relu(x*scale + shift), w) + bias.

The BatchNorm of a dense layer is folded into per-channel (scale, shift)
and applied with the ReLU inside the convolution's input pass, so the
activated tensor never reaches device memory. Counterpart of the JAX
package's ``ops/dense_conv.fused_dense_conv`` (dense_conv.py:272, math at
:261-268), with the same faces: NHWC ``x``, HWIO ``w``, NHWC ``y``. An NCHW
tensor in ``torch.channels_last`` memory becomes such an ``x`` through a
zero-copy ``permute(0, 2, 3, 1)``.

The forward is the op ``torch.ops.endodepth.fused_dense_conv``
(``dense_conv_op``: a ``torch.library`` custom op with a fake
implementation, so ``torch.export`` and AOTInductor keep it as one opaque
node; ``csrc/dense_conv_op.cpp`` registers the same schema in C++ for the
Python-free serving host). On a CUDA tensor it launches the hand-written
kernel in ``csrc/dense_conv.cu`` (built at first use, see
``ops/_build.py``) or raises: in bf16 the tensor-core implicit GEMM of
``csrc/conv3x3_mma.cuh`` (shared with the block engine's K4) in the tiles
and chunk split that ``forward_tiling`` picks from the shape (passed to
the op as ints) and the vector width ``vector_width`` picks from the
pointers; in f32 a direct convolution on FFMAs. On a CPU tensor it runs
the plain PyTorch version ``fused_dense_conv_reference``. It takes x only
as contiguous NHWC and never copies.

K1 is forward only: it runs the dense layers of an eval-mode model (the
serving path), and a train-mode dense block runs through the block
engine (``ops.block_engine``), which has its own backward. The op
registers no autograd formula, so a gradient through it raises PyTorch's
own "no autograd formula was registered" error.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build, conv3x3_mma
from ..utils import profiling

LAUNCHES = 0  # kernel launches of fused_dense_conv in this process
MAX_FEATURES = 16  # the kernel's compiled maximum of output channels
SPLIT_BELOW = 256  # bf16 K1 splits its channel chunks below this many tiles
_SOURCES = ("dense_conv.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load("dense_conv", _SOURCES)
    if lib.dense_conv_fwd.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.dense_conv_fwd.argtypes = [i] + [p] * 7 + [i] * 8 + [p]
        lib.dense_conv_fwd.restype = i
        lib.dense_conv_max_features.argtypes = []
        lib.dense_conv_max_features.restype = i
        if lib.dense_conv_max_features() != MAX_FEATURES:
            raise RuntimeError("dense_conv library and wrapper disagree on "
                               "the maximum feature count")
    return lib


def build_report() -> str:
    """Build the kernel library if needed; return ptxas's register/spill
    report for it."""
    _library()
    return _build.build_report("dense_conv", _SOURCES)


def fused_dense_conv_reference(x: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor, w: torch.Tensor,
                               bias: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The plain PyTorch version: the affine + ReLU in f32, rounded to
    ``x.dtype``, then a zero-padded 3x3 conv in ``x.dtype``.
    x (B, H, W, C), scale/shift (C,), w (3, 3, C, F), bias (F,) ->
    y (B, H, W, F)."""
    xn = x.permute(0, 3, 1, 2)
    a = torch.relu(xn.float() * scale.float()[:, None, None]
                   + shift.float()[:, None, None]).to(x.dtype)
    wt = w.permute(3, 2, 0, 1).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(a, wt, b, padding=1).permute(0, 2, 3, 1)


def fused_dense_conv_twin(x: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """The bf16 kernel's tight twin: the activation in f32 rounded to
    ``x.dtype`` as in the plain version, then the conv of those rounded
    operands and of ``w`` summed in f32, plus the f32 bias, rounded to
    ``x.dtype`` once. (The plain version convolves and adds the bias in
    ``x.dtype``, another rounding; in f32 the two agree.) Same faces as
    ``fused_dense_conv_reference``."""
    xn = x.permute(0, 3, 1, 2)
    a = torch.relu(xn.float() * scale.float()[:, None, None]
                   + shift.float()[:, None, None]).to(x.dtype).float()
    b = None if bias is None else bias.float()
    y = F.conv2d(a, w.permute(3, 2, 0, 1).float(), b, padding=1)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def forward_tiling(dtype: torch.dtype, b: int, h: int, w: int, c: int
                   ) -> Tuple[int, int, int]:
    """K1's (tile_h, tile_w, n_split) for x (b, h, w, c):
    ``conv3x3_mma.forward_tiling`` (the bf16 kernel is the block engine's
    K4 body) with K1's own split threshold ``SPLIT_BELOW``. Measured on an
    H100 at FCDenseNet-57's levels at batch 1 and 8: the split is faster
    at every level of up to 160 tiles (by 3% at 160, b8 64x80, and 2-3x
    at <= 20 tiles), so K1 splits below 256 tiles where K4, measured at
    2B = 16, splits below 132."""
    return conv3x3_mma.forward_tiling(dtype, b, h, w, c, SPLIT_BELOW)


def vector_width(dtype: torch.dtype, c: int, f: int, x_ptr: int, w_ptr: int,
                 y_ptr: int) -> int:
    """How many bf16 channels a lane of the bf16 kernel loads at once from
    x's rows: 8 (16-byte vectors) where c % 8 == 0, 4 (8-byte vectors)
    where c % 4 == 0, with x aligned to the vector, F even and w and y
    4-byte aligned (the weights and y move as channel pairs); else 1. A
    vector then never runs past c into the next pixel. 1 in f32."""
    if dtype != torch.bfloat16 or f % 2 or w_ptr % 4 or y_ptr % 4:
        return 1
    for vw in (8, 4):
        if c % vw == 0 and x_ptr % (2 * vw) == 0:
            return vw
    return 1


def _check(x, scale, shift, w, bias, tile_h: int, tile_w: int, n_split: int) -> None:
    """What the kernels take: contiguous NHWC x, the shapes and dtypes of
    ``fused_dense_conv``, one device, and a tiling some kernel has (a
    256-pixel tile in bf16; 16x32 and no split in f32; the C entry checks
    tile_w and n_split again)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    c = x.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (an NCHW tensor in "
                         "channels_last memory, permuted to NHWC)")
    if w.dim() != 4 or w.shape[:3] != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, F), got {tuple(w.shape)}")
    if w.dtype != x.dtype or not w.is_contiguous():
        raise ValueError("w must be contiguous and of x's dtype")
    f = w.shape[3]
    if f > MAX_FEATURES:
        raise ValueError(f"F = {f} exceeds the kernel's maximum "
                         f"{MAX_FEATURES}")
    vectors = [("scale", scale, c), ("shift", shift, c)]
    if bias is not None:
        vectors.append(("bias", bias, f))
    for name, t, n in vectors:
        if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({n},) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    for t in [scale, shift, w] + ([] if bias is None else [bias]):
        if t.device != x.device:
            raise ValueError(f"all inputs must lie on {x.device}, "
                             f"found one on {t.device}")
    ok = (tile_h * tile_w == conv3x3_mma.MMA_PIXELS and tile_w in (32, 16, 8)
          and n_split >= 1 if x.dtype == torch.bfloat16
          else (tile_h, tile_w, n_split) == (*conv3x3_mma.FFMA_TILE, 1))
    if not ok:
        raise ValueError(f"no {x.dtype} kernel for the tiling "
                         f"{(tile_h, tile_w, n_split)}")


# The op's schema, here and in csrc/dense_conv_op.cpp (the serving host's
# C++ registration): the tiling enters as ints, chosen in Python from the
# shape (``forward_tiling``), so an exported graph fixes it with the shape
SCHEMA = ("fused_dense_conv(Tensor x, Tensor scale, Tensor shift, Tensor w, "
          "Tensor? bias, int tile_h, int tile_w, int n_split) -> Tensor")
# Inductor must hand the op x in the strides the trace saw (contiguous
# NHWC; it may lay a cat's output out otherwise); the op raises on others
_STRIDES = getattr(torch.Tag, "needs_exact_strides", torch.Tag.needs_fixed_stride_order)


@torch.library.custom_op("endodepth::fused_dense_conv", mutates_args=(),
                         device_types="cpu", schema=SCHEMA.removeprefix("fused_dense_conv"),
                         tags=(_STRIDES,))
def dense_conv_op(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor | None, tile_h: int,
                  tile_w: int, n_split: int) -> torch.Tensor:
    """``torch.ops.endodepth.fused_dense_conv``: K1's forward as an op that
    ``torch.export`` and AOTInductor keep opaque. On the CPU the plain
    version (the tiling unused), on the card the kernel."""
    _check(x, scale, shift, w, bias, tile_h, tile_w, n_split)
    return fused_dense_conv_reference(x, scale, shift, w, bias).contiguous()


@dense_conv_op.register_fake
def _(x, scale, shift, w, bias, tile_h, tile_w, n_split):
    _check(x, scale, shift, w, bias, tile_h, tile_w, n_split)
    return x.new_empty((*x.shape[:3], w.shape[3]))


@dense_conv_op.register_kernel("cuda")
def _(x, scale, shift, w, bias, tile_h, tile_w, n_split):
    global LAUNCHES
    _check(x, scale, shift, w, bias, tile_h, tile_w, n_split)
    b, h, wd, c = x.shape
    f = w.shape[3]
    y = torch.empty((b, h, wd, f), dtype=x.dtype, device=x.device)
    vw = vector_width(x.dtype, c, f, x.data_ptr(), w.data_ptr(), y.data_ptr())
    # split chunks: the blocks' f32 partial y, summed in order by a second pass
    ypart = (torch.empty((n_split, conv3x3_mma.n_tiles(b, h, wd, tile_h, tile_w),
                          conv3x3_mma.MMA_PIXELS, MAX_FEATURES),
                         dtype=torch.float32, device=x.device)
             if n_split > 1 else None)
    with profiling.span("dense_conv"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().dense_conv_fwd(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            w.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), None if ypart is None else ypart.data_ptr(),
            b, h, wd, c, f, n_split, tile_w, vw, stream)
    if rc != 0:
        raise RuntimeError(f"dense_conv_fwd launch failed: CUDA error {rc} "
                           f"for x {tuple(x.shape)} {x.dtype}, F = {f}, "
                           f"tiling {(tile_h, tile_w, n_split)}, {vw} channels "
                           f"a lane")
    LAUNCHES += 1
    return y


def fused_dense_conv(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = conv3x3(relu(x*scale + shift), w) + bias, zeros outside the image.

    x (B, H, W, C) contiguous, float32 or bfloat16; scale, shift (C,) and
    bias (F,) float32; w (3, 3, C, F) in x's dtype with F <= MAX_FEATURES.
    Returns y (B, H, W, F) contiguous, in x's dtype. Forward only (see the
    module docstring).
    """
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    tiling = forward_tiling(x.dtype, *x.shape)
    return torch.ops.endodepth.fused_dense_conv(x, scale, shift, w, bias, *tiling)
