"""Bilinear warp sampler: sample an NHWC image at per-pixel coordinates.

Counterpart of the JAX package's ``ops/warp_pallas.py``
(``sample_bilinear_pallas`` :201 and ``sample_bilinear_pallas_grad_first``
:268): ``image`` (B, H, W, C) float32 sampled at pixel coordinates
``px``, ``py`` (B, Hq, Wq), zeros outside the image, -> (B, Hq, Wq, C).
The coordinates are already in the sampler's convention (shifted by
``ops/gridsample.grid_sample`` and clamped to [-2, size+1]).

On a CUDA tensor the ``autograd.Function`` ``SampleBilinear`` launches
the hand-written kernels in ``csrc/warp_sample.cu`` (K2 forward, K3
backward; built at first use, see ``ops/_build.py``) or raises. On a CPU
tensor it runs the plain forward ``sample_bilinear_reference`` and a
plain PyTorch rendering of the kernel's backward arithmetic
(``_backward_plain``), so the CPU tests hold that arithmetic against the
JAX package.

K3's dimg is an order-free fixed-point scatter: each tap's f32 product d
is added to its texel as round(d * 2^S) in int64, S = 62 - h - e, where
e is ``frexp(max finite |g|)``'s exponent and h = ceil(log2(Hq*Wq))
(``fixed_point_shift``). A texel takes at most one tap of each query of
its image, so no sum reaches 2^62, and integer sums give the same bits
in any order: dimg is bitwise repeatable, and the kernel's dimg equals
``_backward_plain``'s bit for bit. One contribution rounds by at most
max|g| * 2^(h-62). A non-finite product marks its texel, whose dimg is
NaN. The kernel's scratch (``warp_sample_bwd_scratch_bytes``: 9 bytes a
texel and gradient channel) comes from the caching allocator.

``sample_bilinear(..., grad_first_only=True)`` passes a gradient to image
channel 0 only and returns zeros for the others (their consumers are not
differentiable, as in ``geometry.warp_depth``); its dpx and dpy come from
channel 0 alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..utils import profiling

# kernel launches in this process, by kernel
LAUNCHES = {"warp_sample_fwd": 0, "warp_sample_bwd": 0}
MAX_CHANNELS = 2  # the kernels' compiled maximum of image channels
_SOURCES = ("warp_sample.cu",)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on a loaded
    ``warp_sample`` library (once); check its compiled maximum channels."""
    if lib.warp_sample_fwd.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.warp_sample_fwd.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.warp_sample_fwd.restype = i
        lib.warp_sample_bwd.argtypes = [p] * 8 + [ctypes.c_longlong] + [i] * 7 + [p]
        lib.warp_sample_bwd.restype = i
        lib.warp_sample_bwd_scratch_bytes.argtypes = [i] * 4
        lib.warp_sample_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.warp_sample_max_channels.argtypes = []
        lib.warp_sample_max_channels.restype = i
        if lib.warp_sample_max_channels() != MAX_CHANNELS:
            raise RuntimeError("warp_sample library and wrapper disagree on "
                               "the maximum channel count")
    return lib


def _library() -> ctypes.CDLL:
    return bind(_build.load("warp_sample", _SOURCES))


def build_report() -> str:
    """Build the kernel library if needed; return ptxas's register/spill
    report for it."""
    _library()
    return _build.build_report("warp_sample", _SOURCES)


def _taps(image: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The four taps of every query, in the kernel's order 00, 01, 10, 11
    (row, column): values (B, Hq, Wq, C), zero outside the image, and
    flat indices into (B, H*W) clamped inside it; plus validity and the
    fractions wx, wy (B, Hq, Wq, 1)."""
    b, h, w, c = image.shape
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0f)[..., None], (py - y0f)[..., None]
    # NaN -> an arbitrary index; its NaN weight still poisons the sample
    x0 = torch.nan_to_num(x0f).long()
    y0 = torch.nan_to_num(y0f).long()
    flat = image.reshape(b, h * w, c)
    values, indices, valid = [], [], []
    for yi, xi in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        values.append(v.reshape(*px.shape, c) * ok[..., None])
        indices.append(idx)
        valid.append(ok)
    return values, indices, valid, wx, wy


def sample_bilinear_reference(image: torch.Tensor, px: torch.Tensor,
                              py: torch.Tensor) -> torch.Tensor:
    """The plain version: four gathers and the bilinear mix, as the JAX
    package's ``gridsample.grid_sample_nhwc`` (:35-76) forms it. Its
    backward is PyTorch autograd."""
    (v00, v01, v10, v11), _, _, wx, wy = _taps(image, px, py)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def fixed_point_shift(g: torch.Tensor, queries: int) -> int:
    """S of K3's fixed-point sums for a cotangent ``g`` (its gradient
    channels only) and ``queries`` = Hq*Wq per image: 62 - h - e, with
    h = ceil(log2(queries)) and e the exponent of ``frexp(m)``, m the
    largest finite |g| (0, and e = 0, when there is none)."""
    m = torch.where(torch.isfinite(g), g.abs(), 0.0).amax()
    return 62 - (queries - 1).bit_length() - int(torch.frexp(m).exponent)


def _backward_plain(image, px, py, g, grad_channels: int):
    """The kernel's backward arithmetic in PyTorch: dpx and dpy from the
    tap differences; dimg as the int64 scatter-add of each valid tap's f32
    product g*(row weight)*(column weight) rounded to 2^-S, converted back
    to f32, NaN where a product is non-finite. Only the first
    ``grad_channels`` channels are read and scattered."""
    b, h, w, c = image.shape
    cg = grad_channels
    values, indices, valid, wx, wy = _taps(image[..., :cg], px, py)
    v00, v01, v10, v11 = values
    g = g[..., :cg]
    dpx = (g * ((1.0 - wy) * (v01 - v00) + wy * (v11 - v10))).sum(-1)
    dpy = (g * ((1.0 - wx) * (v10 - v00) + wx * (v11 - v01))).sum(-1)
    shift = fixed_point_shift(g, px.shape[1] * px.shape[2])
    gt, gb = g * (1.0 - wy), g * wy
    weights = (gt * (1.0 - wx), gt * wx, gb * (1.0 - wx), gb * wx)
    sums = torch.zeros(b, h * w, cg, dtype=torch.int64, device=image.device)
    marks = torch.zeros_like(sums)
    for d, idx, ok in zip(weights, indices, valid):
        d, ok = d.reshape(b, -1, cg), ok.reshape(b, -1, 1)
        idx = idx[..., None].expand(-1, -1, cg)
        finite = torch.isfinite(d)
        fixed = torch.where(ok & finite, d, 0.0).double() * 2.0 ** shift
        sums.scatter_add_(1, idx, torch.round(fixed).long())
        marks.scatter_add_(1, idx, (ok & ~finite).long())
    dimg = (sums.double() * 2.0 ** -shift).float()
    dimg = torch.where(marks > 0, float("nan"), dimg)
    dimg = torch.nn.functional.pad(dimg, (0, c - cg))  # zeros past channel cg
    return dimg.reshape(b, h, w, c), dpx, dpy


def _check(image, px, py) -> None:
    if image.dim() != 4 or px.dim() != 3 or px.shape != py.shape:
        raise ValueError(f"need image (B, H, W, C) and px, py (B, Hq, Wq); got "
                         f"{tuple(image.shape)}, {tuple(px.shape)}, "
                         f"{tuple(py.shape)}")
    if px.shape[0] != image.shape[0]:
        raise ValueError("image and coordinates disagree on the batch")
    if not 1 <= image.shape[3] <= MAX_CHANNELS:
        raise ValueError(f"C = {image.shape[3]} is outside the kernel's "
                         f"1..{MAX_CHANNELS}")
    for name, t in (("image", image), ("px", px), ("py", py)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
        if t.device != image.device:
            raise ValueError(f"all inputs must lie on {image.device}, "
                             f"found {name} on {t.device}")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no warp_sample kernel for device {image.device}")


# each C entry's span (``utils.profiling``)
_SPANS = {"warp_sample_fwd": "warp_fwd", "warp_sample_bwd": "warp_bwd"}


def _cuda_call(fn: str, tensors, ints, shape) -> None:
    for t in tensors:
        if t.data_ptr() % 8:  # a texel's two channels are one 8-byte load
            raise ValueError("warp_sample's CUDA tensors must be 8-byte aligned")
    with profiling.span(_SPANS[fn]), torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), fn)(*(t.data_ptr() for t in tensors), *ints,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} for "
                           f"image {shape}")


def _forward(image, px, py) -> torch.Tensor:
    if image.device.type == "cpu":
        return sample_bilinear_reference(image, px, py)
    b, h, w, c = image.shape
    hq, wq = px.shape[1:]
    out = torch.empty((b, hq, wq, c), dtype=image.dtype, device=image.device)
    _cuda_call("warp_sample_fwd", (image, px, py, out), (b, h, w, c, hq, wq),
               tuple(image.shape))
    LAUNCHES["warp_sample_fwd"] += 1
    return out


# K3's tile of queries (csrc/warp_sample.cu TILE_H x TILE_W)
TILE = (16, 64)


def _backward_cuda(image, px, py, g, grad_channels: int):
    """K3 on CUDA tensors: dimg, dpx, dpy and a 0-d int64 tensor on the
    card, the count of query tiles whose taps were summed in shared memory
    (of ``b * ceil(Hq/16) * ceil(Wq/64)``, ``TILE``)."""
    g = g.contiguous()
    b, h, w, c = image.shape
    hq, wq = px.shape[1:]
    lib = _library()
    # the int64 sums, the marks, the tile count and max|g|'s bits
    scratch = torch.empty(lib.warp_sample_bwd_scratch_bytes(b, h, w, grad_channels),
                          dtype=torch.uint8, device=image.device)
    dimg = torch.empty_like(image)
    dpx, dpy = torch.empty_like(px), torch.empty_like(py)
    _cuda_call("warp_sample_bwd", (image, px, py, g, dpx, dpy, dimg, scratch),
               (scratch.numel(), b, h, w, c, grad_channels, hq, wq), tuple(image.shape))
    LAUNCHES["warp_sample_bwd"] += 1
    return dimg, dpx, dpy, scratch[-16:-8].view(torch.int64)[0]


def _backward(image, px, py, g, grad_channels: int):
    if image.device.type == "cpu":
        return _backward_plain(image, px, py, g, grad_channels)
    return _backward_cuda(image, px, py, g, grad_channels)[:3]


class SampleBilinear(torch.autograd.Function):
    """Bilinear sample with gradients to both coordinates and to the first
    ``grad_channels`` image channels (all of them, or 1 for grad-first);
    the other channels' cotangents are treated as zero."""

    @staticmethod
    def forward(ctx, image, px, py, grad_channels: int):
        _check(image, px, py)
        ctx.save_for_backward(image, px, py)
        ctx.grad_channels = grad_channels
        return _forward(image, px, py)

    @staticmethod
    def backward(ctx, g):
        image, px, py = ctx.saved_tensors
        return (*_backward(image, px, py, g, ctx.grad_channels), None)


def sample_bilinear(image: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    grad_first_only: bool = False) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) f32 at (px, py) (B, Hq, Wq) f32, zeros
    padding -> (B, Hq, Wq, C). ``grad_first_only`` passes a gradient to
    image channel 0 only."""
    return SampleBilinear.apply(image, px, py,
                                1 if grad_first_only else image.shape[3])
