"""The whole-dense-block engine: a train-mode dense block, forward and
backward, with no concatenation and with the BatchNorm statistics and
gradients as kernel byproducts.

Counterpart of the JAX package's ``ops/block_engine.py``
(``block_engine_apply`` :1152, forward ``_engine_impl`` :589-635, backward
``_engine_bwd`` :1175-1310): a block of L layers ``y_j = conv3x3(relu(
bn_j([x, y_0 .. y_{j-1}])), W_j) + b_j`` with growth F, BatchNorm on the
batch statistics (biased variance, eps 1e-5), returning the block's
output ``buf = [x, y_0 .. y_{L-1}]`` and its per-channel (mean, mean of
squares), so a ``TransitionDown`` can reuse them.

Layout: one NHWC buffer. ``buf`` (B, H, W, C0 + L*F) is allocated once,
``x`` is copied into its first C0 channels, and layer j reads the channel
prefix [0, C_j), C_j = C0 + j*F, at row stride C0 + L*F and writes its F
channels at offset C_j. The backward runs on one gradient buffer of the
same shape. (The JAX engine keeps x and each layer's channels as separate
packed TPU tensors and concatenates them once; none of that layout is
carried over.)

Per layer the work is three kernels, in ``csrc/block_engine.cu``:

- K4 ``layer_forward``: y into ``buf[..., C_j:C_j+F]`` and the (sum y,
  sum y^2) of the stored y as per-tile partials, from which the layer's
  statistics come (JAX :625-628); in bf16 an implicit GEMM on the tensor
  cores, in f32 (the parity dtype) a direct convolution on FFMAs;
- K5 ``layer_dinput``: with gy_eff = g + C1 + C2*y (the lazily applied
  BN-through-statistics gradient, JAX :689-699), the transposed-tap
  cotangent of the prefix through the ReLU mask and the BN scale, added
  into the gradient buffer's prefix, and the per-channel (sum dpre*x,
  sum dpre) and sum gy_eff as per-tile partials; in bf16 an implicit GEMM
  on the tensor cores, in f32 (the parity dtype) a direct convolution on
  FFMAs;
- K6 ``layer_dweight``: the layer's weight gradient, f32; in bf16 an
  implicit GEMM on the tensor cores, in f32 (the parity dtype) a direct
  reduction on FFMAs, both as per-block partials summed in order.

Once a block, at its boundary, two memory-bound passes over the prefix
[0, C0), in the same file:

- ``block_entry``: x into ``buf[..., :C0]`` and x's per-channel (mean,
  mean of squares) (JAX :597-598), reading x once;
- ``block_exit``: the final fix-up dx = g + C1 + C2*x (JAX :1307) from
  the gradient buffer's prefix and x, into a fresh (B, H, W, C0) tensor,
  with no f32 temporary.

Between those launches the per-channel vector math (what XLA fuses between
the Pallas calls in JAX, :129-134, :625-628, :1262-1301) runs as three
more kernels of the same file, channel-local, in f32, each step rounded as
the plain PyTorch expression on the card rounds it (no FMA):

- ``glue_forward``, once a layer after K4 (and once a block before the
  first, from the entry's moments): K4's per-tile partials summed, divided
  by n, into the block's preallocated (mu, m2), then the next layer's BN
  folded into (scale, shift) and its kernel cast to HWIO in buf's dtype
  (``GlueBuffers``, one per block);
- ``glue_backward``, once a layer after K5 and K6: K5's partials summed
  into dgamma, dbeta and the bias gradient, layer j's (C1, C2) update
  applied in place, layer j - 1's fold and kernel; ``glue_backward_start``
  (the same kernel) once a block before the top layer: C1 = gmu/n, C2 =
  2*gm2/n and the top layer's fold;
- ``running_stats``, once a block: every layer's running statistics.

The partial sums spread across the SMs: each block sums a chunk of the
tiles' rows for a group of channels, and the last block of a group to
finish (a completion counter it resets itself) sums the chunks' sums in
chunk order. No float atomics: the order is fixed by the shapes alone, so
the results are bitwise repeatable, though not the plain version's
order. The counters are one per channel group and direction on the
device, so two glue launches of one direction must not overlap: every
launch goes on the current stream, as the engine's all do. The twins
(``glue_*_reference``, ``running_stats_reference``) are the expressions
the engine wrote inline before; on the CPU K4's and K5's wrappers return
their sums as one partial row, which the twins sum as the card's.

In place: K4 writes into ``buf``; the backward clones the incoming
gradient once into a fresh buffer and K5 adds into that buffer's prefix
(the JAX kernel's aliased ``gx_in``/``gseg_in``, :895-897). Nothing the
caller holds is modified.

On CUDA tensors each per-layer call launches its kernel or raises; on CPU
tensors it runs its plain PyTorch twin (``*_reference``). The
orchestration (``BlockEngine``) is the same on both, so the CPU tests
exercise the (C1, C2) bookkeeping that runs on the card. The entry
points check the shape against ``supported`` before any launch and raise
outside it.

In a process group (``parallel.distributed``) the block normalizes with
the global batch's statistics, as JAX's ``axis_name`` makes it (its
``_pmean``/``_psum``, :585-586, :1171-1172). Each collective is one
all-reduce of one packed (2, C) tensor, between the launches: in the
forward the block input's (mu, m2) and each layer's K4 sums, once divided
by the local count, are averaged over the ranks (JAX :597-598, :627-628);
in the backward the statistics' cotangent (gmu, gm2) is summed over the
ranks before C1 and C2 are formed with the global pixel count (JAX
:1184-1205), and so is each layer's (sum dpre*x, sum dpre), for the
(C1, C2) updates only (JAX :1263-1301). dgamma, dbeta, dW and the bias
gradient stay the rank's own, averaged with every other parameter
gradient after the backward (the module docstring of
``parallel.distributed``, convention 3). That is 5 + 5 all-reduces per
4-layer block and step, none at world size 1. Around each per-layer
all-reduce the glue runs as two calls of the same kernel, REDUCE (the
rank's sums) then FINISH (the rest, from every rank's); at world size 1
one call does both.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, conv3x3_mma
from ..parallel import distributed
from ..utils import profiling

# kernel launches in this process, by kernel
LAUNCHES = {"block_engine_fwd": 0, "block_engine_dinput": 0,
            "block_engine_dweight": 0, "block_engine_entry": 0, "block_engine_exit": 0,
            "block_engine_glue_fwd": 0, "block_engine_glue_bwd": 0,
            "block_engine_running_stats": 0}
# each C entry's span (``utils.profiling``)
_SPANS = {"block_engine_fwd": "engine_fwd", "block_engine_dinput": "engine_dinput",
          "block_engine_dweight": "engine_dweight", "block_engine_entry": "engine_entry",
          "block_engine_exit": "engine_exit", "block_engine_glue_fwd": "engine_glue_fwd",
          "block_engine_glue_bwd": "engine_glue_bwd",
          "block_engine_running_stats": "engine_running_stats"}
# the glue's phases, its C entries' flags: the sums of the partials, and
# the finish (statistics or (C1, C2), and the next layer's fold and kernel)
REDUCE, FINISH = 1, 2
MAX_GROWTH = 16        # the kernels' compiled maximum of F
EPS = 1e-5             # BatchNorm's, as torch's and the JAX package's
TILE_H, TILE_W = 16, 32  # f32 K4's and K5's output tile
DWEIGHT_TILE_H = 8     # f32 K6's tile is 8 x 32
CHUNK = 16             # channels per chunk
TARGET_BLOCKS = 1024   # f32 K5 and K6 split work across blocks up to about this
DWEIGHT_BLOCKS = 264   # bf16 K6: at most this many blocks, one wave at 2 an SM
SPLIT_BELOW = 132      # bf16 K4 splits its channel chunks below this many tiles
DINPUT_CHUNK = 32      # bf16 K5's prefix channels per block
_SOURCES = ("block_engine.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(b: int, h: int, w: int, n_layers: int, growth: int) -> bool:
    """The port's shape gate: what the kernels take (growth up to
    ``MAX_GROWTH``, a batch that fits the grid). The TPU engine's gate
    (JAX :91-94) exists for its packed layout and does not apply."""
    return (1 <= growth <= MAX_GROWTH and n_layers >= 1 and 1 <= b <= 65535
            and h >= 1 and w >= 1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on a loaded
    ``block_engine`` library (once); check its compiled maximum growth."""
    if lib.block_engine_fwd.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.block_engine_fwd.argtypes = [i] + [p] * 7 + [i] * 9 + [p]
        lib.block_engine_dinput.argtypes = [i] + [p] * 9 + [i] * 9 + [p]
        lib.block_engine_dweight.argtypes = [i] + [p] * 8 + [i] * 9 + [p]
        lib.block_engine_entry.argtypes = [i] + [p] * 4 + [i] * 6 + [p]
        lib.block_engine_exit.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
        lib.block_engine_boundary_layout.argtypes = [i] + [p] * 3 + [i] * 5 + [p]
        f = ctypes.c_float
        lib.block_engine_glue_layout.argtypes = [i] * 3 + [p]
        lib.block_engine_glue_fwd.argtypes = [i] + [p] * 11 + [i] * 9 + [f] + [i] * 2 + [p]
        lib.block_engine_glue_bwd.argtypes = [i] + [p] * 18 + [i] * 8 + [f] + [i] * 2 + [p]
        lib.block_engine_glue_bwd_start.argtypes = [i] + [p] * 12 + [i] * 7 + [f, p]
        lib.block_engine_running_stats.argtypes = [p] * 4 + [i] * 3 + [f] * 2 + [p]
        for fn in (lib.block_engine_fwd, lib.block_engine_dinput,
                   lib.block_engine_dweight, lib.block_engine_entry,
                   lib.block_engine_exit, lib.block_engine_boundary_layout,
                   lib.block_engine_glue_layout, lib.block_engine_glue_fwd,
                   lib.block_engine_glue_bwd, lib.block_engine_glue_bwd_start,
                   lib.block_engine_running_stats):
            fn.restype = i
        lib.block_engine_max_growth.argtypes = []
        lib.block_engine_max_growth.restype = i
        if lib.block_engine_max_growth() != MAX_GROWTH:
            raise RuntimeError("block_engine library and wrapper disagree on "
                               "the maximum growth")
    return lib


def _library() -> ctypes.CDLL:
    return bind(_build.load("block_engine", _SOURCES))


def build_report() -> str:
    """Build the kernel library if needed; return ptxas's register/spill
    report for it."""
    _library()
    return _build.build_report("block_engine", _SOURCES)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def fold(gamma, beta, mu, var):
    """Folded BN in f32 (JAX ``_fold`` :129-134): relu(v*scale + shift) ==
    relu(bn(v)) for the mean ``mu`` and the variance ``var`` (the biased
    m2 - mu^2 of batch statistics). Returns (scale, shift,
    1/sqrt(var + EPS)). The model folds every other BatchNorm with it."""
    inv = torch.rsqrt(var + EPS)
    scale = gamma.float() * inv
    return scale, beta.float() - mu * scale, inv


# -- the plain twins: per-layer functions on the whole buffers ---------------


def _activation(buf, c, scale, shift) -> torch.Tensor:
    """relu(x*scale + shift) over the prefix, in f32, rounded to buf's
    dtype, back in f32 (the kernels' a)."""
    a = torch.relu(buf[..., :c].float() * scale + shift)
    return a.to(buf.dtype).float()


def _gy_eff(grad, buf, c, f, c1, c2) -> torch.Tensor:
    """g + c1 + c2*y of the layer's channels, rounded to buf's dtype,
    back in f32 (the kernels' gy_eff)."""
    y = buf[..., c:c + f].float()
    return (grad[..., c:c + f].float() + c1 + c2 * y).to(buf.dtype).float()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def layer_forward_reference(buf, c, scale, shift, w, bias) -> torch.Tensor:
    """K4's plain version: y = conv3x3(a, w) + bias in f32, rounded, into
    ``buf[..., c:c+F]``; returns (2, F) f32: the sum and the sum of
    squares of the stored y."""
    f = w.shape[3]
    y = F.conv2d(_nchw(_activation(buf, c, scale, shift)),
                 w.float().permute(3, 2, 0, 1), bias.float(), padding=1)
    buf[..., c:c + f] = y.permute(0, 2, 3, 1).to(buf.dtype)
    yf = buf[..., c:c + f].float()
    return torch.stack([yf.sum((0, 1, 2)), yf.square().sum((0, 1, 2))])


def layer_dinput_reference(grad, buf, c, scale, shift, w, c1, c2):
    """K5's plain version: da = conv3x3^T(gy_eff, w), dpre = da*(a > 0),
    grad[..., :c] += dpre*scale (rounded, in place); returns (sum dpre*x,
    sum dpre) per prefix channel and sum gy_eff per output channel, f32."""
    f = w.shape[3]
    gy = _gy_eff(grad, buf, c, f, c1, c2)
    a = _activation(buf, c, scale, shift)
    da = torch.nn.grad.conv2d_input(
        (a.shape[0], c, a.shape[1], a.shape[2]),
        w.float().permute(3, 2, 0, 1), _nchw(gy), padding=1)
    dpre = da.permute(0, 2, 3, 1) * (a > 0)
    grad[..., :c] = (grad[..., :c].float() + dpre * scale).to(grad.dtype)
    x = buf[..., :c].float()
    return ((dpre * x).sum((0, 1, 2)), dpre.sum((0, 1, 2)),
            gy.sum((0, 1, 2)))


def layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2):
    """K6's plain version: dW[ky, kx, c, f] = sum_p a[p + (ky-1, kx-1), c]
    * gy_eff[p, f], f32 (3, 3, c, F)."""
    gy = _gy_eff(grad, buf, c, f, c1, c2)
    a = _activation(buf, c, scale, shift)
    dw = torch.nn.grad.conv2d_weight(_nchw(a), (f, c, 3, 3), _nchw(gy),
                                     padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


def block_entry_reference(x, buf) -> torch.Tensor:
    """The entry's plain version: x into ``buf[..., :C0]`` (in place);
    returns (2, C0) f32, x's per-channel mean and mean of squares."""
    buf[..., :x.shape[3]] = x
    xf = x.float()
    return torch.stack([xf.mean((0, 1, 2)), xf.square().mean((0, 1, 2))])


def block_exit_reference(grad, buf, c1, c2, c0) -> torch.Tensor:
    """The exit's plain version: dx = (g + c1) + c2*x over the prefix
    [0, c0) of grad and buf, in f32, rounded to buf's dtype; contiguous
    (B, H, W, c0)."""
    x = buf[..., :c0].float()
    return (grad[..., :c0].float() + c1[:c0] + c2[:c0] * x).to(buf.dtype).contiguous()


class GlueBuffers(NamedTuple):
    """A block's folded BatchNorm and cast kernel of the layer that runs
    next, rewritten by the glue once a layer: scale and shift (C,) f32 and
    the kernel (3, 3, C, F) flat in buf's dtype, C the block's widest
    prefix; layer j takes the first C_j channels."""
    scale: torch.Tensor
    shift: torch.Tensor
    w: torch.Tensor

    @staticmethod
    def empty(c: int, growth: int, dtype, device) -> "GlueBuffers":
        return GlueBuffers(torch.empty(c, dtype=torch.float32, device=device),
                           torch.empty(c, dtype=torch.float32, device=device),
                           torch.empty(9 * c * growth, dtype=dtype, device=device))

    def layer(self, c: int, f: int) -> tuple:
        """The (scale, shift, w) views of a layer with prefix c and growth f."""
        return self.scale[:c], self.shift[:c], self.w[:9 * c * f].view(3, 3, c, f)


def _fold_next(mu, m2, layer, out: GlueBuffers):
    """The next layer's BatchNorm folded over its prefix and its kernel cast,
    into ``out``; returns its (scale, shift, w), or None without a layer."""
    if layer is None:
        return None
    gamma, beta, kernel = layer
    c, f = kernel.shape[2], kernel.shape[3]
    scale, shift, w = out.layer(c, f)
    s, sh, _ = fold(gamma, beta, mu[:c], m2[:c] - mu[:c].square())
    scale.copy_(s)
    shift.copy_(sh)
    w.copy_(kernel)
    return scale, shift, w


def glue_forward_reference(mu, m2, c, stats, n, flags, layer, out):
    """The forward glue's plain version (``glue_forward``): the expressions
    ``engine_forward`` and K4's wrapper wrote inline."""
    if flags & REDUCE:
        stats = stats.sum(1) / n
        if not flags & FINISH:
            return stats
    k = stats.shape[1]
    mu[c:c + k] = stats[0]
    m2[c:c + k] = stats[1]
    return _fold_next(mu, m2, layer, out)


def glue_backward_reference(mu, m2, c1, c2, c, stats, n, flags, gamma, grads, layer, out):
    """The backward glue's plain version (``glue_backward``): the expressions
    ``engine_backward`` and K5's wrapper wrote inline."""
    inv = torch.rsqrt(m2[:c] - mu[:c].square() + EPS)
    if flags & REDUCE:
        part, part_bias = stats
        sums = part.sum(1)
        dsx, dss = sums[0], sums[1]
        dgamma = inv * (dsx - mu[:c] * dss)
        for t, v in zip(grads, (dgamma, dss, part_bias.sum(0))):
            t.copy_(v)
        if not flags & FINISH:
            return sums
    else:
        dsx, dss = stats[0], stats[1]
        dgamma = inv * (dsx - mu[:c] * dss)
    gamma = gamma.float()
    c2[:c] -= gamma * inv * inv * dgamma / n
    c1[:c] += gamma * inv * (inv * mu[:c] * dgamma - dss) / n
    return _fold_next(mu, m2, layer, out)


def glue_backward_start_reference(mu, m2, c1, c2, gmu, gm2, n, layer, out):
    """The backward glue's start, plain (``glue_backward_start``)."""
    c1.copy_(gmu / n)
    c2.copy_(2.0 * gm2 / n)
    return _fold_next(mu, m2, layer, out)


def running_stats_reference(pairs, mu, m2, c0: int, growth: int, momentum: float) -> None:
    """``running_stats``' plain version: ``models.fcdensenet.
    update_running_stats``' expressions, layer by layer."""
    for j, (mean, var) in enumerate(pairs):
        c = c0 + j * growth
        v = m2[:c] - mu[:c].square()
        mean.copy_(momentum * mean + (1.0 - momentum) * mu[:c])
        var.copy_(momentum * var + (1.0 - momentum) * v)


# -- the kernel wrappers -------------------------------------------------------


def _check(buf, c, f, vectors, w=None, grad=None) -> None:
    if buf.dim() != 4 or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous (B, H, W, C) tensor, got "
                         f"{tuple(buf.shape)}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"buf must be float32 or bfloat16, got {buf.dtype}")
    if not (1 <= f <= MAX_GROWTH and 1 <= c and c + f <= buf.shape[3]):
        raise ValueError(f"layer channels [0, {c}) + {f} do not fit buf "
                         f"{tuple(buf.shape)} (growth <= {MAX_GROWTH})")
    if not supported(buf.shape[0], buf.shape[1], buf.shape[2], 1, f):
        raise ValueError(f"buf {tuple(buf.shape)} is outside the engine's gate")
    tensors = list(vectors)
    if grad is not None:
        if grad.shape != buf.shape or grad.dtype != buf.dtype or \
                not grad.is_contiguous():
            raise ValueError("grad must be a contiguous tensor of buf's shape "
                             "and dtype")
        tensors.append(("grad", grad, None))
    if w is not None:
        if w.shape != (3, 3, c, f) or w.dtype != buf.dtype or \
                not w.is_contiguous():
            raise ValueError(f"w must be a contiguous (3, 3, {c}, {f}) tensor "
                             f"of buf's dtype, got {w.dtype} {tuple(w.shape)}")
        tensors.append(("w", w, None))
    for name, t, n in tensors:
        if n is not None and (t.shape != (n,) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({n},) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != buf.device:
            raise ValueError(f"all inputs must lie on {buf.device}, found "
                             f"{name} on {t.device}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no block_engine kernel for device {buf.device}")


def _n_part(b: int, h: int, w: int, tile_h: int = TILE_H,
            tile_w: int = TILE_W) -> int:
    return b * _ceil(h, tile_h) * _ceil(w, tile_w)


def forward_tiling(dtype: torch.dtype, b: int, h: int, w: int, c: int
                   ) -> Tuple[int, int, int]:
    """K4's (tile_h, tile_w, n_split) for a (b, h, w) image with prefix c:
    ``conv3x3_mma.forward_tiling`` with K4's threshold ``SPLIT_BELOW``
    (measured on an H100: the split is faster at 32x40 and below with
    2B = 16, slower at 64x80's 320 tiles)."""
    return conv3x3_mma.forward_tiling(dtype, b, h, w, c, SPLIT_BELOW)


def dinput_tiling(dtype: torch.dtype, b: int, h: int, w: int, c: int
                  ) -> Tuple[int, int, int]:
    """K5's (tile_h, tile_w, n_split) for a (b, h, w) image with prefix c:
    in bf16, the 256-pixel tile of ``conv3x3_mma.mma_tile`` and one block
    per 32 channels; in f32, 16x32 tiles and the 16-channel chunks split
    across blocks up to about ``TARGET_BLOCKS`` blocks."""
    if dtype == torch.bfloat16:
        return (*conv3x3_mma.mma_tile(h, w), _ceil(c, DINPUT_CHUNK))
    n_split = max(1, min(_ceil(c, CHUNK),
                         _ceil(TARGET_BLOCKS, _n_part(b, h, w)), 65535 // b))
    return TILE_H, TILE_W, n_split


def dweight_tiling(dtype: torch.dtype, b: int, h: int, w: int, c: int
                   ) -> Tuple[int, int, int]:
    """K6's (tile_h, tile_w, n_split) for a (b, h, w) image with prefix c:
    how many blocks share one 16-channel chunk's tiles, each taking the
    tiles split, split + n_split, ... In bf16 the 256-pixel tile of
    ``conv3x3_mma.mma_tile`` and at most ``DWEIGHT_BLOCKS`` blocks in all
    (one wave at two blocks an SM); in f32 8x32 tiles, up to about
    ``TARGET_BLOCKS`` blocks. Never more splits than tiles."""
    chunks = _ceil(c, CHUNK)
    if dtype == torch.bfloat16:
        tile_h, tile_w = conv3x3_mma.mma_tile(h, w)
        n_split = DWEIGHT_BLOCKS // chunks
    else:
        tile_h, tile_w = DWEIGHT_TILE_H, TILE_W
        n_split = _ceil(TARGET_BLOCKS, chunks)
    tiles = conv3x3_mma.n_tiles(b, h, w, tile_h, tile_w)
    return tile_h, tile_w, max(1, min(tiles, n_split, 65535))


def dweight_vector_width(dtype: torch.dtype, c: int, f: int, ld: int,
                         buf_ptr: int, grad_ptr: int) -> int:
    """How many bf16 prefix channels a lane of the bf16 K6 copies at once:
    8 (16-byte vectors, and 8-byte ones of 4 channels for g and y) where ld
    % 8 == 0, c and f are multiples of 4 and buf and grad are 16-byte
    aligned; else 1 (scalars). A prefix vector then starts at a multiple of
    8 below c and ends inside the row (ld); a g or y vector starts at c + 4k
    below c + f and ends at or before c + f. The C entry checks the same.
    1 in f32."""
    if (dtype == torch.bfloat16 and ld % 8 == 0 and c % 4 == 0 and f % 4 == 0
            and buf_ptr % 16 == 0 and grad_ptr % 16 == 0):
        return 8
    return 1


def boundary_layout(buf, c0: int, *tensors) -> dict:
    """The launch the boundary kernels take, as their C entries pick it
    from buf's shape and dtype, C0 and the bases of buf and ``tensors``
    (the entry: x; the exit: grad and dx): ``vw`` channels a lane (a
    16-byte vector where C0 and ld are multiples of it and every base is
    aligned, else 1), ``lanes`` and ``rows`` a block, ``groups`` (grid.y)
    and ``blocks`` (grid.x)."""
    b, h, w, ld = buf.shape
    bases = [t.data_ptr() for t in tensors] + [buf.data_ptr()] * (3 - len(tensors))
    out = (ctypes.c_int * 5)()
    rc = _library().block_engine_boundary_layout(_DTYPES[buf.dtype], *bases, b, h, w,
                                                 c0, ld, out)
    if rc != 0:
        raise ValueError(f"no boundary launch for buf {tuple(buf.shape)} {buf.dtype}, "
                         f"C0 {c0}")
    return dict(zip(("vw", "lanes", "rows", "groups", "blocks"), out))


def _check_boundary(buf, c0, tensors) -> None:
    if buf.dim() != 4 or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous (B, H, W, C) tensor, got "
                         f"{tuple(buf.shape)}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"buf must be float32 or bfloat16, got {buf.dtype}")
    if not 1 <= c0 <= buf.shape[3]:
        raise ValueError(f"the block input's {c0} channels do not fit buf "
                         f"{tuple(buf.shape)}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no block_engine kernel for device {buf.device}")
    for name, t, shape, dtype in tensors:
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != buf.device:
            raise ValueError(f"all inputs must lie on {buf.device}, found {name} on "
                             f"{t.device}")


def _launch(name: str, buf, tensors, ints) -> None:
    """Launch ``name`` on buf's device and its current stream with buf's
    dtype code, the tensors' pointers and the ints."""
    with profiling.span(_SPANS[name]), torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), name)(_DTYPES[buf.dtype],
                                       *(t.data_ptr() for t in tensors), *ints,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} for buf "
                           f"{tuple(buf.shape)} {buf.dtype}, ints {ints}")
    LAUNCHES[name] += 1


def layer_forward(buf, c, scale, shift, w, bias) -> torch.Tensor:
    """Layer output into ``buf[..., c:c+F]`` (in place) from the prefix
    [0, c); returns the sum and the sum of squares of the stored y as
    per-tile partials, (2, n_part, F) f32 (the glue sums them). K4 on the
    card; on the CPU ``layer_forward_reference``, whose sums are one
    partial row, (2, 1, F)."""
    f = w.shape[3]
    _check(buf, c, f, [("scale", scale, c), ("shift", shift, c),
                       ("bias", bias, f)], w=w)
    if buf.device.type == "cpu":
        return layer_forward_reference(buf, c, scale, shift, w, bias)[:, None]
    b, h, wd, ld = buf.shape
    tile_h, tile_w, n_split = forward_tiling(buf.dtype, b, h, wd, c)
    n_part = _n_part(b, h, wd, tile_h, tile_w)
    part = torch.empty((2, n_part, f), dtype=torch.float32, device=buf.device)
    # split chunks: the blocks' f32 partial y, summed in order by a second pass
    ypart = (torch.empty((n_split, n_part, conv3x3_mma.MMA_PIXELS, MAX_GROWTH),
                         dtype=torch.float32, device=buf.device)
             if n_split > 1 else part)
    _launch("block_engine_fwd", buf, (buf, scale, shift, w, bias, part, ypart),
            (b, h, wd, c, f, ld, n_part, n_split, tile_w))
    return part


def layer_dinput(grad, buf, c, scale, shift, w, c1, c2) -> tuple:
    """Adds the prefix cotangent dpre*scale into ``grad[..., :c]`` (in
    place); returns (sum dpre*x, sum dpre) per prefix channel and sum
    gy_eff per output channel as per-tile partials, (2, n_part, c) and
    (n_part, F) f32 (the glue sums them). K5 on the card; on the CPU
    ``layer_dinput_reference``, whose sums are one partial row."""
    f = w.shape[3]
    _check(buf, c, f, [("scale", scale, c), ("shift", shift, c),
                       ("c1", c1, f), ("c2", c2, f)], w=w, grad=grad)
    if buf.device.type == "cpu":
        dsx, dss, dbias = layer_dinput_reference(grad, buf, c, scale, shift, w, c1, c2)
        return torch.stack([dsx, dss])[:, None], dbias[None]
    b, h, wd, ld = buf.shape
    tile_h, tile_w, n_split = dinput_tiling(buf.dtype, b, h, wd, c)
    n_part = _n_part(b, h, wd, tile_h, tile_w)
    part = torch.empty((2, n_part, c), dtype=torch.float32, device=buf.device)
    part_bias = torch.empty((n_part, f), dtype=torch.float32, device=buf.device)
    _launch("block_engine_dinput", buf,
            (grad, buf, scale, shift, w, c1, c2, part, part_bias),
            (b, h, wd, c, f, ld, n_part, n_split, tile_w))
    return part, part_bias


def layer_dweight(grad, buf, c, f, scale, shift, c1, c2) -> torch.Tensor:
    """The layer's weight gradient (3, 3, c, F) f32 from the prefix [0, c)
    and gy_eff. K6 on the card, ``layer_dweight_reference`` on the CPU."""
    _check(buf, c, f, [("scale", scale, c), ("shift", shift, c),
                       ("c1", c1, f), ("c2", c2, f)], grad=grad)
    if buf.device.type == "cpu":
        return layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)
    b, h, wd, ld = buf.shape
    _, tile_w, n_split = dweight_tiling(buf.dtype, b, h, wd, c)
    vw = dweight_vector_width(buf.dtype, c, f, ld, buf.data_ptr(), grad.data_ptr())
    # the blocks' f32 partials, summed in split order by a second pass
    part = torch.empty((n_split, 9, c, f), dtype=torch.float32,
                       device=buf.device)
    dw = torch.empty((3, 3, c, f), dtype=torch.float32, device=buf.device)
    _launch("block_engine_dweight", buf,
            (grad, buf, scale, shift, c1, c2, part, dw),
            (b, h, wd, c, f, ld, n_split, tile_w, vw))
    return dw


def block_entry(x, buf) -> torch.Tensor:
    """The block input x (B, H, W, C0) into ``buf[..., :C0]`` (in place);
    returns (2, C0) f32, x's per-channel mean and mean of squares. One C
    call on the card (a pass over x, then the blocks' f64 partials summed
    in order), ``block_entry_reference`` on the CPU."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C0), got {tuple(x.shape)}")
    b, h, w, c0 = x.shape
    _check_boundary(buf, c0, [("x", x, (*buf.shape[:3], c0), buf.dtype)])
    if buf.device.type == "cpu":
        return block_entry_reference(x, buf)
    # the blocks' f64 partials, summed in order by the second kernel
    part = torch.empty(2 * c0 * boundary_layout(buf, c0, x)["blocks"],
                       dtype=torch.float64, device=buf.device)
    out = torch.empty((2, c0), dtype=torch.float32, device=buf.device)
    _launch("block_engine_entry", buf, (x, buf, part, out),
            (b, h, w, c0, buf.shape[3], part.numel()))
    return out


def block_exit(grad, buf, c1, c2, c0: int) -> torch.Tensor:
    """dx = (g + c1) + c2*x over the prefix [0, c0) of the gradient
    buffer and of buf, rounded to buf's dtype: a fresh contiguous (B, H,
    W, c0) tensor; c1, c2 the block's (C0 + L*F,) f32 coefficients. One
    launch on the card, bitwise ``block_exit_reference``, which runs on the
    CPU."""
    _check_boundary(buf, c0, [("grad", grad, buf.shape, buf.dtype),
                              ("c1", c1, buf.shape[-1:], torch.float32),
                              ("c2", c2, buf.shape[-1:], torch.float32)])
    if buf.device.type == "cpu":
        return block_exit_reference(grad, buf, c1, c2, c0)
    b, h, w, ld = buf.shape
    dx = torch.empty((b, h, w, c0), dtype=buf.dtype, device=buf.device)
    _launch("block_engine_exit", buf, (grad, buf, c1, c2, dx), (b, h, w, c0, ld))
    return dx


@functools.lru_cache(maxsize=None)
def glue_layout(n_part: int, nc: int, nb: int) -> dict:
    """How the glue's C entries spread a sum of per-tile partials (n_part
    rows of nc channels in each of two planes, and nb bias columns) across
    blocks: ``groups`` of ``width`` channels, ``segments``, ``chunks`` of
    ``rows`` rows, and the f32 ``scratch`` elements that takes."""
    out = (ctypes.c_int * 6)()
    if _library().block_engine_glue_layout(n_part, nc, nb, out) != 0:
        raise ValueError(f"no glue layout for {n_part} rows of {nc} + {nb} columns")
    return dict(zip(("groups", "width", "segments", "chunks", "rows", "scratch"), out))


def _check_glue(dtype, tensors) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"the block's dtype must be float32 or bfloat16, got {dtype}")
    device = tensors[0][1].device
    for name, t, numel in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() < numel:
            raise ValueError(f"{name} must be a contiguous float32 tensor of at least "
                             f"{numel} elements, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"all inputs must lie on {device}, found {name} on {t.device}")


def _fold_args(layer, out: GlueBuffers) -> tuple:
    """The next layer's pointers (gamma, beta, kernel, scale, shift, w) and
    ints (c, F, the kernel's four strides) for a glue C entry; nulls and
    zeros without a layer."""
    if layer is None:
        return (None,) * 6, (0,) * 6
    gamma, beta, kernel = layer
    if kernel.dim() != 4 or kernel.shape[:2] != (3, 3) or kernel.dtype != torch.float32:
        raise ValueError(f"the kernel must be a float32 (3, 3, C, F) tensor, got "
                         f"{kernel.dtype} {tuple(kernel.shape)}")
    c, f = kernel.shape[2], kernel.shape[3]
    _check_glue(out.w.dtype, [("gamma", gamma, c), ("beta", beta, c), ("scale", out.scale, c),
                              ("shift", out.shift, c)])
    if out.w.numel() < 9 * c * f or kernel.device != gamma.device:
        raise ValueError(f"the kernel (3, 3, {c}, {f}) does not fit the glue's buffers")
    scale, shift, w = out.layer(c, f)
    return (gamma, beta, kernel, scale, shift, w), (c, f, *kernel.stride())


def _glue_launch(name, dtype, tensors, ints, n, tail=(), entry=None) -> None:
    """Launch the glue C entry ``entry`` (by default ``name``; counted and
    spanned as ``name``) on the current stream: dtype code, the tensors'
    pointers (None: null), the ints, 1/n as PyTorch's CUDA division of an
    f32 tensor by n computes it (the f32 reciprocal of the f32 n), the
    ``tail`` ints (the flags and the scratch's elements), the stream.

    A reduction's completion counters are the device's, one set a
    direction, and its last block resets them: two glue launches of one
    direction on one device must not overlap. The engine issues all of its
    launches on one stream; a caller that runs a block's engine on a
    second stream while another runs must wait for it first."""
    device = next(t for t in tensors if t is not None).device
    inv_n = float(np.float32(1.0) / np.float32(n))
    with profiling.span(_SPANS[name]), torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), entry or name)(
            _DTYPES[dtype], *(None if t is None else t.data_ptr() for t in tensors), *ints,
            inv_n, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{entry or name} launch failed: CUDA error {rc}, ints {ints}, "
                           f"{tail}")
    LAUNCHES[name] += 1


def glue_forward(mu, m2, c: int, stats, n: int, flags: int, layer, out: GlueBuffers):
    """The forward's per-channel math around K4, for the k channels
    [c, c + k) of the block's statistics mu, m2 (C_tot,) f32. REDUCE:
    ``stats`` are K4's partials (2, n_part, k), summed and divided by the
    pixel count n; alone, returns those (2, k) moments (a process group
    averages them, then calls FINISH). FINISH: the moments (from the sums,
    else ``stats`` (2, k)) into mu, m2 [c, c + k), then ``layer`` (the next
    layer's gamma, beta and f32 (3, 3, c + k, F) kernel, or None) folded and
    cast into ``out``; returns its (scale, shift, w) views, or None. One
    launch on the card (the partials summed across blocks in a fixed
    order), ``glue_forward_reference`` on the CPU."""
    if mu.device.type == "cpu":
        return glue_forward_reference(mu, m2, c, stats, n, flags, layer, out)
    k = stats.shape[-1]
    reduce = bool(flags & REDUCE)
    layout = glue_layout(stats.shape[1], k, 0) if reduce else None
    moments = (torch.empty((2, k), dtype=torch.float32, device=mu.device)
               if flags == REDUCE else stats if not reduce else None)
    tensors, ints = _fold_args(layer, out)
    _check_glue(out.w.dtype, [("mu", mu, c + k), ("m2", m2, c + k)]
                + ([("part", stats, 2 * k)] if reduce else [("moments", moments, 2 * k)]))
    scratch = (torch.empty(layout["scratch"], dtype=torch.float32, device=mu.device)
               if reduce else None)
    _glue_launch("block_engine_glue_fwd", out.w.dtype,
                 (stats if reduce else None, moments, mu, m2, scratch, *tensors),
                 (stats.shape[1] if reduce else 0, k, c, *ints), n,
                 (flags, 0 if scratch is None else scratch.numel()))
    if flags == REDUCE:
        return moments
    return None if layer is None else out.layer(ints[0], ints[1])


def glue_backward(mu, m2, c1, c2, c: int, stats, n: int, flags: int, gamma, grads, layer,
                  out: GlueBuffers):
    """The backward's per-channel math after layer j's K5 and K6, over its
    prefix [0, c). REDUCE: ``stats`` are K5's partials (2, n_part, c) and
    (n_part, F), summed into this rank's gradients ``grads`` (dgamma,
    dbeta (c,), dbias (F,)); alone, returns the (2, c) (sum dpre*x, sum
    dpre) (a process group sums them, then calls FINISH). FINISH: with every
    rank's sums (from the partials, else ``stats`` (2, c)), layer j's
    BN-through-statistics gradient into the block's C1, C2 [0, c) in place,
    then ``layer`` (layer j - 1's gamma, beta, kernel, or None) folded and
    cast into ``out``; returns its views, or None. One launch on the card,
    ``glue_backward_reference`` on the CPU."""
    if mu.device.type == "cpu":
        return glue_backward_reference(mu, m2, c1, c2, c, stats, n, flags, gamma, grads,
                                       layer, out)
    reduce = bool(flags & REDUCE)
    part, part_bias = stats if reduce else (None, None)
    f = part_bias.shape[1] if reduce else layer[2].shape[3] if layer is not None else 1
    layout = glue_layout(part.shape[1], c, f) if reduce else None
    sums = (torch.empty((2, c), dtype=torch.float32, device=mu.device)
            if flags == REDUCE else None if reduce else stats)
    dgamma, dbeta, dbias = grads if reduce else (None,) * 3
    tensors, ints = _fold_args(layer, out)
    checked = [("mu", mu, c), ("m2", m2, c), ("c1", c1, c), ("c2", c2, c), ("gamma", gamma, c)]
    if reduce:
        checked += [("part", part, 2 * c * part.shape[1]),
                    ("part_bias", part_bias, part.shape[1] * f), ("dgamma", dgamma, c),
                    ("dbeta", dbeta, c), ("dbias", dbias, f)]
    if sums is not None:
        checked.append(("sums", sums, 2 * c))
    _check_glue(out.w.dtype, checked)
    scratch = (torch.empty(layout["scratch"], dtype=torch.float32, device=mu.device)
               if reduce else None)
    _glue_launch("block_engine_glue_bwd", out.w.dtype,
                 (part, part_bias, sums, mu, m2, c1, c2, gamma, dgamma, dbeta, dbias, scratch,
                  *tensors),
                 (part.shape[1] if reduce else 0, c, f, ints[0], *ints[2:]), n,
                 (flags, 0 if scratch is None else scratch.numel()))
    if flags == REDUCE:
        return sums
    return None if layer is None else out.layer(ints[0], ints[1])


def glue_backward_start(mu, m2, c1, c2, gmu, gm2, n: int, layer, out: GlueBuffers):
    """Before a block's top layer: C1 = gmu/n and C2 = 2*gm2/n into c1, c2
    (C_tot,) f32 (every rank's cotangent, the global pixel count n), and
    ``layer`` (the top layer's gamma, beta, kernel) folded and cast into
    ``out``; returns its views. One launch of the backward's glue kernel
    on the card (counted as ``block_engine_glue_bwd``),
    ``glue_backward_start_reference`` on the CPU."""
    if mu.device.type == "cpu":
        return glue_backward_start_reference(mu, m2, c1, c2, gmu, gm2, n, layer, out)
    ctot = mu.shape[0]
    tensors, ints = _fold_args(layer, out)
    _check_glue(out.w.dtype, [(name, t, ctot) for name, t in
                              (("mu", mu), ("m2", m2), ("c1", c1), ("c2", c2), ("gmu", gmu),
                               ("gm2", gm2))])
    _glue_launch("block_engine_glue_bwd", out.w.dtype, (gmu, gm2, mu, m2, c1, c2, *tensors),
                 (ctot, *ints), n, entry="block_engine_glue_bwd_start")
    return out.layer(ints[0], ints[1])


def running_stats(pairs: Sequence[tuple], mu, m2, c0: int, growth: int,
                  momentum: float) -> None:
    """Every layer j's running statistics of a block, ``pairs[j]`` =
    (running mean, running variance) (c0 + j*growth,) f32, moved in place
    to momentum*r + (1 - momentum)*stat with the biased variance, from the
    block's (mu, m2). One launch a block on the card (which takes up to 32
    layers), ``running_stats_reference`` on the CPU."""
    mu, m2 = mu.detach(), m2.detach()
    if mu.device.type == "cpu":
        with torch.no_grad():
            return running_stats_reference(pairs, mu, m2, c0, growth, momentum)
    _check_glue(torch.float32, [("mu", mu, 0), ("m2", m2, 0)]
                + [(f"running statistic {j}", t, c0 + j * growth)
                   for j, pair in enumerate(pairs) for t in pair])
    means = (ctypes.c_void_p * len(pairs))(*(p[0].data_ptr() for p in pairs))
    variances = (ctypes.c_void_p * len(pairs))(*(p[1].data_ptr() for p in pairs))
    with profiling.span(_SPANS["block_engine_running_stats"]), torch.cuda.device(mu.device):
        rc = _library().block_engine_running_stats(
            means, variances, mu.data_ptr(), m2.data_ptr(), c0, growth, len(pairs), momentum,
            1.0 - momentum, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_engine_running_stats refused {len(pairs)} layers "
                           f"(at most 32) or failed: CUDA error {rc}")
    LAUNCHES["block_engine_running_stats"] += 1


# -- the block -----------------------------------------------------------------


def _split(params, n_layers: int):
    return [params[i * n_layers:(i + 1) * n_layers] for i in range(4)]


def engine_forward(x: torch.Tensor, n_layers: int, params
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block's forward (JAX ``_engine_impl``): (buf, mu, m2) from the
    NHWC block input and the flat parameter list (gammas, betas, kernels,
    biases). The entry once; the glue once before the first layer (the
    entry's moments, layer 0's fold and kernel) and K4 and the glue once
    per layer (its statistics into mu, m2; the next layer's fold and
    kernel). In a process group the statistics are the global batch's: the
    glue runs as two calls around each all-reduce."""
    gammas, betas, kernels, biases = _split(params, n_layers)
    b, h, w, c0 = x.shape
    growth = biases[0].shape[0]
    n = b * h * w
    ctot = c0 + n_layers * growth
    buf = torch.empty((b, h, w, ctot), dtype=x.dtype, device=x.device)
    mu, m2 = (torch.empty(ctot, dtype=torch.float32, device=x.device) for _ in range(2))
    out = GlueBuffers.empty(ctot - growth, growth, x.dtype, x.device)
    grouped = distributed.group() is not None
    layer = glue_forward(mu, m2, 0, distributed.all_mean_(block_entry(x, buf)), n, FINISH,
                         (gammas[0], betas[0], kernels[0]), out)
    for j in range(n_layers):
        c = c0 + j * growth
        part = layer_forward(buf, c, *layer, biases[j].float().contiguous())
        nxt = (gammas[j + 1], betas[j + 1], kernels[j + 1]) if j + 1 < n_layers else None
        if grouped:
            moments = distributed.all_mean_(glue_forward(mu, m2, c, part, n, REDUCE, None, out))
            layer = glue_forward(mu, m2, c, moments, n, FINISH, nxt, out)
        else:
            layer = glue_forward(mu, m2, c, part, n, REDUCE | FINISH, nxt, out)
    return buf, mu, m2


def engine_backward(buf, mu, m2, n_layers: int, params, gbuf, gmu, gm2) -> tuple:
    """The block's backward (JAX ``_engine_bwd``) at the block output
    ``buf`` and its statistics (mu, m2): the gradients of x and of every
    parameter, in ``params``' order, from the cotangents of (buf, mu,
    m2). The glue once before the top layer, K6, K5 and the glue once per
    layer (two glue calls around the all-reduce in a process group), then
    the exit."""
    gammas, betas, kernels, biases = _split(params, n_layers)
    b, h, w, ctot = buf.shape
    growth = biases[0].shape[0]
    c0 = ctot - n_layers * growth
    n = b * h * w * distributed.world()  # the global pixel count
    grad = torch.empty_like(buf)  # K5 accumulates into it in place
    grad.copy_(gbuf)
    # the statistics' cotangent, d buf += gmu/n + 2*buf*gm2/n, is affine
    # in buf: kept as per-channel coefficients (C1, C2) and applied
    # lazily (JAX :1195-1205); in a process group gmu and gm2 are the
    # sums of every rank's
    gmu, gm2 = gmu.float().contiguous(), gm2.float().contiguous()
    grouped = distributed.group() is not None
    if grouped:
        gmu, gm2 = distributed.all_sum_(torch.stack([gmu, gm2]))
    c1, c2 = (torch.empty(ctot, dtype=torch.float32, device=buf.device) for _ in range(2))
    out = GlueBuffers.empty(ctot - growth, growth, buf.dtype, buf.device)
    top = n_layers - 1
    layer = glue_backward_start(mu, m2, c1, c2, gmu, gm2, n,
                                (gammas[top], betas[top], kernels[top]), out)
    dgammas, dbetas, dkernels, dbiases = ([None] * n_layers for _ in range(4))
    for j in reversed(range(n_layers)):
        c = c0 + j * growth
        scale, shift, wj = layer
        c1j, c2j = c1[c:c + growth], c2[c:c + growth]
        # K6 reads the layer's own gradient channels, K5 rewrites the prefix's:
        # K6 first, so that K5's partials live only until the glue sums them
        dkernels[j] = layer_dweight(grad, buf, c, growth, scale, shift, c1j, c2j)
        part = layer_dinput(grad, buf, c, scale, shift, wj, c1j, c2j)
        # dgamma, dbeta, and layer j's BN-through-statistics gradient
        # folded into the prefix's (C1, C2) (JAX :1262-1301); the
        # updates take every rank's sums, the gradients this rank's
        grads = tuple(torch.empty(k, dtype=torch.float32, device=buf.device)
                      for k in (c, c, growth))
        dgammas[j], dbetas[j], dbiases[j] = grads
        nxt = (gammas[j - 1], betas[j - 1], kernels[j - 1]) if j > 0 else None
        if grouped:
            sums = distributed.all_sum_(glue_backward(mu, m2, c1, c2, c, part, n, REDUCE,
                                                      gammas[j], grads, None, out))
            layer = glue_backward(mu, m2, c1, c2, c, sums, n, FINISH, gammas[j], None, nxt,
                                  out)
        else:
            layer = glue_backward(mu, m2, c1, c2, c, part, n, REDUCE | FINISH, gammas[j],
                                  grads, nxt, out)
        del part  # freed before the next layer's K5 and the exit allocate
    dx = block_exit(grad, buf, c1, c2, c0)
    return (dx, *dgammas, *dbetas, *dkernels, *dbiases)


class BlockEngine(torch.autograd.Function):
    """The block's forward (``engine_forward``) and backward
    (``engine_backward``) over the per-layer calls. Saves only ``buf`` and
    the statistics (and the parameters)."""

    @staticmethod
    def forward(ctx, x, n_layers, *params):
        buf, mu, m2 = engine_forward(x, n_layers, params)
        ctx.save_for_backward(buf, mu, m2, *params)
        ctx.n_layers = n_layers
        return buf, mu, m2

    @staticmethod
    def backward(ctx, gbuf, gmu, gm2):
        buf, mu, m2, *params = ctx.saved_tensors
        dx, *dparams = engine_backward(buf, mu, m2, ctx.n_layers, params,
                                       gbuf, gmu, gm2)
        return (dx, None, *dparams)


def block_engine_apply(x: torch.Tensor, gammas: Sequence[torch.Tensor],
                       betas: Sequence[torch.Tensor],
                       kernels: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode dense block (JAX ``block_engine_apply``).

    x (B, H, W, C0) NHWC in float32 or bfloat16; per layer j, BN
    ``gammas[j]``, ``betas[j]`` (C0 + j*F,) and conv ``kernels[j]`` (3, 3,
    C0 + j*F, F) HWIO and ``biases[j]`` (F,), all float32. Returns
    (buf (B, H, W, C0 + L*F) in x's dtype, mu, m2 (C0 + L*F,) float32): the
    block output [x, y_0 .. y_{L-1}] and its per-channel mean and mean of
    squares. Differentiable in x and every parameter, through mu and m2
    too. Raises ``ValueError`` outside ``supported``.
    """
    n_layers = len(kernels)
    if not (len(gammas) == len(betas) == len(biases) == n_layers):
        raise ValueError("need one gamma, beta, kernel and bias per layer")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, _ = x.shape
    if not supported(b, h, w, n_layers, biases[0].shape[0]):
        raise ValueError(f"x {tuple(x.shape)} with growth "
                         f"{biases[0].shape[0]} is outside the engine's gate")
    return BlockEngine.apply(x.contiguous(), n_layers, *gammas, *betas, *kernels,
                             *biases)
