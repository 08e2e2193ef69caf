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
  sum y^2) of the stored y, from which the layer's statistics come
  (JAX :625-628); in bf16 an implicit GEMM on the tensor cores, in f32
  (the parity dtype) a direct convolution on FFMAs;
- K5 ``layer_dinput``: with gy_eff = g + C1 + C2*y (the lazily applied
  BN-through-statistics gradient, JAX :689-699), the transposed-tap
  cotangent of the prefix through the ReLU mask and the BN scale, added
  into the gradient buffer's prefix, and the per-channel (sum dpre*x,
  sum dpre) and sum gy_eff; in bf16 an implicit GEMM on the tensor cores,
  in f32 (the parity dtype) a direct convolution on FFMAs;
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

Between the launches plain PyTorch does only per-channel vector math, as
XLA does in JAX: the BN folds, the (C1, C2) updates, and summing K4's and
K5's per-block partials.

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
4-layer block and step, none at world size 1.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, conv3x3_mma
from ..parallel import distributed
from ..utils import profiling

# kernel launches in this process, by kernel
LAUNCHES = {"block_engine_fwd": 0, "block_engine_dinput": 0,
            "block_engine_dweight": 0, "block_engine_entry": 0, "block_engine_exit": 0}
# each C entry's span (``utils.profiling``)
_SPANS = {"block_engine_fwd": "engine_fwd", "block_engine_dinput": "engine_dinput",
          "block_engine_dweight": "engine_dweight", "block_engine_entry": "engine_entry",
          "block_engine_exit": "engine_exit"}
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
        for fn in (lib.block_engine_fwd, lib.block_engine_dinput,
                   lib.block_engine_dweight, lib.block_engine_entry,
                   lib.block_engine_exit, lib.block_engine_boundary_layout):
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
    [0, c); returns (2, F) f32, the sum and the sum of squares of the
    stored y. K4 on the card, ``layer_forward_reference`` on the CPU."""
    f = w.shape[3]
    _check(buf, c, f, [("scale", scale, c), ("shift", shift, c),
                       ("bias", bias, f)], w=w)
    if buf.device.type == "cpu":
        return layer_forward_reference(buf, c, scale, shift, w, bias)
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
    return part.sum(1)


def layer_dinput(grad, buf, c, scale, shift, w, c1, c2):
    """Adds the prefix cotangent dpre*scale into ``grad[..., :c]`` (in
    place); returns (sum dpre*x, sum dpre) per prefix channel and
    sum gy_eff per output channel, f32. K5 on the card,
    ``layer_dinput_reference`` on the CPU."""
    f = w.shape[3]
    _check(buf, c, f, [("scale", scale, c), ("shift", shift, c),
                       ("c1", c1, f), ("c2", c2, f)], w=w, grad=grad)
    if buf.device.type == "cpu":
        return layer_dinput_reference(grad, buf, c, scale, shift, w, c1, c2)
    b, h, wd, ld = buf.shape
    tile_h, tile_w, n_split = dinput_tiling(buf.dtype, b, h, wd, c)
    n_part = _n_part(b, h, wd, tile_h, tile_w)
    part = torch.empty((2, n_part, c), dtype=torch.float32, device=buf.device)
    part_bias = torch.empty((n_part, f), dtype=torch.float32, device=buf.device)
    _launch("block_engine_dinput", buf,
            (grad, buf, scale, shift, w, c1, c2, part, part_bias),
            (b, h, wd, c, f, ld, n_part, n_split, tile_w))
    sums = part.sum(1)
    return sums[0], sums[1], part_bias.sum(0)


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


# -- the block -----------------------------------------------------------------


def _split(params, n_layers: int):
    return [params[i * n_layers:(i + 1) * n_layers] for i in range(4)]


def engine_forward(x: torch.Tensor, n_layers: int, params
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block's forward (JAX ``_engine_impl``): (buf, mu, m2) from the
    NHWC block input and the flat parameter list (gammas, betas, kernels,
    biases). The entry once, K4 once per layer; in a process group the
    statistics are the global batch's."""
    gammas, betas, kernels, biases = _split(params, n_layers)
    b, h, w, c0 = x.shape
    growth = biases[0].shape[0]
    n = b * h * w
    buf = torch.empty((b, h, w, c0 + n_layers * growth), dtype=x.dtype,
                      device=x.device)
    mu_x, m2_x = distributed.all_mean_(block_entry(x, buf))
    mus, m2s = [mu_x], [m2_x]
    for j in range(n_layers):
        mu, m2 = torch.cat(mus), torch.cat(m2s)
        scale, shift, _ = fold(gammas[j], betas[j], mu, m2 - mu.square())
        sums = layer_forward(buf, c0 + j * growth, scale, shift,
                             kernels[j].to(x.dtype).contiguous(),
                             biases[j].float().contiguous())
        stats = distributed.all_mean_(sums / n)
        mus.append(stats[0])
        m2s.append(stats[1])
    return buf, torch.cat(mus), torch.cat(m2s)


def engine_backward(buf, mu, m2, n_layers: int, params, gbuf, gmu, gm2) -> tuple:
    """The block's backward (JAX ``_engine_bwd``) at the block output
    ``buf`` and its statistics (mu, m2): the gradients of x and of every
    parameter, in ``params``' order, from the cotangents of (buf, mu,
    m2). K5 and K6 once per layer, then the exit."""
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
    gmu, gm2 = gmu.float(), gm2.float()
    if distributed.group() is not None:
        gmu, gm2 = distributed.all_sum_(torch.stack([gmu, gm2]))
    c1 = gmu / n
    c2 = 2.0 * gm2 / n
    dgammas, dbetas, dkernels, dbiases = ([None] * n_layers for _ in range(4))
    for j in reversed(range(n_layers)):
        c = c0 + j * growth
        scale, shift, inv = fold(gammas[j], betas[j], mu[:c], m2[:c] - mu[:c].square())
        c1j = c1[c:c + growth].contiguous()
        c2j = c2[c:c + growth].contiguous()
        dsx, dss, dbiases[j] = layer_dinput(
            grad, buf, c, scale, shift, kernels[j].to(buf.dtype).contiguous(),
            c1j, c2j)
        dkernels[j] = layer_dweight(grad, buf, c, growth, scale, shift,
                                    c1j, c2j)
        # dgamma, dbeta, and layer j's BN-through-statistics gradient
        # folded into the prefix's (C1, C2) (JAX :1262-1301); the
        # updates take every rank's sums, the gradients this rank's
        dgamma = inv * (dsx - mu[:c] * dss)
        dgammas[j], dbetas[j] = dgamma, dss
        if distributed.group() is not None:
            dsx, dss = distributed.all_sum_(torch.stack([dsx, dss]))
            dgamma = inv * (dsx - mu[:c] * dss)
        gamma = gammas[j].float()
        c2[:c] -= gamma * inv * inv * dgamma / n
        c1[:c] += gamma * inv * (inv * mu[:c] * dgamma - dss) / n
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
