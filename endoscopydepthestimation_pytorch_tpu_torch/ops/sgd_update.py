"""The train step's optimizer over every parameter tensor at once: clip by
global norm, momentum SGD, and the non-finite gates (``training.sgd_update``
states the rules).

On CUDA tensors ``update`` makes one C call into ``csrc/sgd_update.cu``
(built at first use, see ``ops/_build.py``): three launches, whatever the
number of tensors up to 448 (two more for each 448 beyond), in place of the
plain loop's ~21 a tensor; or it raises. On CPU tensors it runs
``_sgd_update_plain``, the loop the kernel replaces, which the card tests
compare the kernel against. The kernel replaces no TPU kernel: the JAX
package leaves the optimizer to optax, which XLA fuses.

The kernel reads p, b and g as flat storage. Each momentum buffer must lie
as its parameter does (``create_train_state``'s ``zeros_like`` does), and
every parameter must be dense. A gradient laid out otherwise (the block
engine's weight gradients are (3, 3, C, F) in memory, cuDNN's channels_last,
the parameters (F, C, 3, 3)) is read through its strides when it is a dense
permutation of its parameter's dimensions; any other gradient is copied
into its parameter's layout first, and counted in ``RESTRIDED``.
"""
from __future__ import annotations

import array
import ctypes
import functools
import weakref
from typing import List, Tuple

import torch

from . import _build
from ..utils import profiling

LAUNCHES = {"sgd_update": 0}  # C calls in this process
RESTRIDED = 0  # gradients copied into their parameter's layout first
MAX_DIMS = 4  # dimensions of size > 1 of a gradient read through its strides
MAX_ELEMENTS = 1 << 30  # elements a call (the kernels' int offsets)
_SOURCES = ("sgd_update.cu",)
_COPY = "copy"


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on a loaded
    ``sgd_update`` library (once); check its compiled dimension count."""
    if lib.sgd_update.argtypes is None:
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.sgd_update.argtypes = [p] * 3 + [i, i, p, p, f, f] + [p] * 5 + [
            ctypes.c_longlong, p]
        lib.sgd_update.restype = i
        lib.sgd_update_scratch_bytes.argtypes = [i]
        lib.sgd_update_scratch_bytes.restype = ctypes.c_longlong
        lib.sgd_update_max_dims.argtypes = []
        lib.sgd_update_max_dims.restype = i
        if lib.sgd_update_max_dims() != MAX_DIMS:
            raise RuntimeError("sgd_update library and wrapper disagree on the "
                               "dimensions of a permuted gradient")
    return lib


def _library() -> ctypes.CDLL:
    return bind(_build.load("sgd_update", _SOURCES))


def build_report() -> str:
    """Build the kernel library if needed; return ptxas's register/spill
    report for it."""
    _library()
    return _build.build_report("sgd_update", _SOURCES)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros((), device=tensors[0].device)))


def _sgd_update_plain(params, momentum, grads, loss, lr, count, step,
                      clip: float, momentum_coef: float):
    """The optimizer in eager PyTorch ops, tensor by tensor: the CPU path
    and the kernel's twin. Returns (isfinite(loss), the global norm)."""
    finite = torch.isfinite(loss)
    nan = torch.full((), float("nan"), device=loss.device)
    grads = [torch.where(finite, g, nan) for g in grads]
    grad_norm = global_norm(grads)
    # optax's gate: every element of every gradient finite
    all_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    for p, b, g in zip(params, momentum, grads):
        u = torch.where(grad_norm < clip, g, g / grad_norm * clip)
        new_b = u + momentum_coef * b
        b.copy_(torch.where(all_finite, new_b, b))
        p.copy_(torch.where(all_finite, p - lr * new_b, p))
    count += all_finite.to(torch.int32)
    step += finite.to(torch.int32)
    return finite, grad_norm


def _dims(shape, stride) -> List[Tuple[int, int, int]]:
    """(stride, size, dim) of the dimensions of size > 1, outermost first
    in memory."""
    return sorted(((s, n, d) for d, (n, s) in enumerate(zip(shape, stride)) if n != 1),
                  reverse=True)


def _dense_dims(dims) -> bool:
    want = 1
    for s, n, _ in reversed(dims):
        if s != want:
            return False
        want *= n
    return True


@functools.lru_cache(maxsize=4096)
def _dense(shape: tuple, stride: tuple) -> bool:
    """Whether a tensor of this shape and stride covers its storage span
    once (non-overlapping and dense)."""
    return _dense_dims(_dims(shape, stride))


@functools.lru_cache(maxsize=4096)
def _layout(shape: tuple, pstride: tuple, gstride: tuple):
    """How the kernel reads a gradient of strides ``gstride`` beside its
    dense parameter: None where it lies as the parameter (the strides
    differ only along dimensions of size 1), the kernel's row (nd, p's
    sizes and g's strides along p's dimensions of size > 1 in p's memory
    order, each padded to ``MAX_DIMS``) where it is a dense permutation of
    them, else ``_COPY``."""
    pdims = _dims(shape, pstride)
    if all(pstride[d] == gstride[d] for _, _, d in pdims):
        return None
    gdims = _dims(shape, gstride)
    if len(pdims) > MAX_DIMS or not _dense_dims(gdims):
        return _COPY
    pad = [0] * (MAX_DIMS - len(pdims))
    return (len(pdims), *(n for _, n, _ in pdims), *pad,
            *(gstride[d] for _, _, d in pdims), *pad)


# the parameters and momentum buffers last checked: (weak references to
# them, their data pointers, the parameters' shapes and strides)
_checked = None


def _check_pair(params, momentum, ptrs: list):
    """Raise ``ValueError`` unless ``params`` and ``momentum`` are float32
    on one CUDA device, each parameter dense and each buffer of its
    parameter's shape and strides; return the parameters' shapes and
    strides. The same tensors at the same ``ptrs`` (their data pointers)
    as the last call's are not checked again: a change of dtype, device or
    layout moves the storage. (An in-place view op that keeps the storage
    address, say ``p.t_()`` under ``no_grad``, is not seen.)"""
    global _checked
    last = _checked
    tensors = (*params, *momentum)
    if last is not None and last[1] == ptrs and all(
            r() is t for r, t in zip(last[0], tensors)):
        return last[2], last[3]
    if {t.dtype for t in tensors} != {torch.float32}:
        raise ValueError("sgd_update's kernel takes float32 parameters, momentum "
                         "buffers and gradients")
    if not all(t.is_cuda for t in tensors) or len(set(map(torch.Tensor.get_device,
                                                          tensors))) != 1:
        raise ValueError(f"sgd_update's kernel takes tensors on one CUDA device; got "
                         f"{ {str(t.device) for t in tensors} }")
    shapes = [p.shape for p in params]
    if [b.shape for b in momentum] != shapes:
        raise ValueError("each momentum buffer must have its parameter's shape")
    strides = list(map(torch.Tensor.stride, params))
    if list(map(torch.Tensor.stride, momentum)) != strides:
        raise ValueError("each momentum buffer must lie in memory as its parameter does")
    for p, shape, stride in zip(params, shapes, strides):
        if not (p.is_contiguous() or _dense(tuple(shape), stride)):
            raise ValueError(f"a parameter of shape {tuple(shape)} and strides {stride} "
                             f"is not dense")
    _checked = ([weakref.ref(t) for t in tensors], ptrs, shapes, strides)
    return shapes, strides


def _check(params, momentum, grads, loss, lr, count, step) -> Tuple[list, list]:
    """Raise ``ValueError`` on what the kernel does not take; return the
    data pointers of the parameters, the momentum buffers and the
    gradients, and the kernel's rows for the gradients laid out otherwise
    than their parameters, replacing in ``grads`` those it must copy."""
    global RESTRIDED
    n = len(params)
    if n == 0 or len(momentum) != n or len(grads) != n:
        raise ValueError(f"need one momentum buffer and one gradient for each of one or "
                         f"more parameters; got lengths {n}, {len(momentum)}, {len(grads)}")
    if {g.dtype for g in grads} != {torch.float32}:
        raise ValueError("sgd_update's kernel takes float32 parameters, momentum "
                         "buffers and gradients")
    ptrs = [*map(torch.Tensor.data_ptr, params), *map(torch.Tensor.data_ptr, momentum)]
    shapes, strides = _check_pair(params, momentum, ptrs)
    scalars = (loss, lr, count, step)
    for name, t, dtype in zip(("loss", "lr", "count", "step"), scalars,
                              (torch.float32, torch.float32, torch.int32, torch.int32)):
        if t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be a {dtype} scalar tensor")
    index = params[0].get_device()
    if not all(t.is_cuda for t in (*grads, *scalars)) or set(
            map(torch.Tensor.get_device, (*grads, *scalars))) != {index}:
        raise ValueError(f"sgd_update's kernel takes tensors on one CUDA device; got "
                         f"{ {str(t.device) for t in (*params, *grads, *scalars)} }")
    if [g.shape for g in grads] != shapes:
        raise ValueError("each gradient must have its parameter's shape")
    perm = []
    for k, (gstride, stride) in enumerate(zip(map(torch.Tensor.stride, grads), strides)):
        if gstride == stride:
            continue
        row = _layout(tuple(shapes[k]), stride, gstride)
        if row is _COPY:
            grads[k] = torch.empty_like(params[k]).copy_(grads[k])
            RESTRIDED += 1
        elif row is not None:
            perm += (k, *row)
    return ptrs + list(map(torch.Tensor.data_ptr, grads)), perm


def _sgd_update_cuda(params, momentum, grads, loss, lr, count, step,
                     clip: float, momentum_coef: float):
    """One C call: the kernel's three launches on the current stream."""
    grads = list(grads)
    ptrs, perm = _check(params, momentum, grads, loss, lr, count, step)
    numel = list(map(torch.Tensor.numel, params))
    if sum(numel) > MAX_ELEMENTS:
        raise ValueError(f"{sum(numel)} elements, over the kernel's {MAX_ELEMENTS}")
    n = len(params)
    lib = _library()
    device = params[0].device
    grad_norm = torch.empty((), dtype=torch.float32, device=device)
    finite = torch.empty((), dtype=torch.bool, device=device)
    scratch = torch.empty(lib.sgd_update_scratch_bytes(n), dtype=torch.uint8,
                          device=device)
    # host arrays for the C call (array.array: cheaper to fill than ctypes')
    ptrs, numels, rows = (array.array("Q", ptrs), array.array("q", numel),
                          array.array("i", perm))
    with profiling.span("sgd_update"), torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sgd_update(ptrs.buffer_info()[0], numels.buffer_info()[0],
                            rows.buffer_info()[0], len(perm) // (2 + 2 * MAX_DIMS),
                            n, loss.data_ptr(), lr.data_ptr(), clip, momentum_coef,
                            grad_norm.data_ptr(), finite.data_ptr(), count.data_ptr(),
                            step.data_ptr(), scratch.data_ptr(), scratch.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"sgd_update launch failed: CUDA error {rc} for {n} tensors")
    LAUNCHES["sgd_update"] += 1
    return finite, grad_norm


def update(params, momentum, grads, loss: torch.Tensor, lr: torch.Tensor,
           count: torch.Tensor, step: torch.Tensor, clip: float, momentum_coef: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip ``grads`` by their global norm ``clip`` and take one momentum
    SGD step at rate ``lr`` (a scalar tensor) on ``params`` and their
    ``momentum`` buffers, in place, behind the loss and all-finite gates;
    advance ``count`` and ``step`` (int32 scalar tensors). Returns
    (isfinite(loss), the global norm), 0-d tensors on the device. The
    kernel on CUDA tensors, ``_sgd_update_plain`` on CPU tensors."""
    if params[0].device.type == "cpu":
        return _sgd_update_plain(params, momentum, grads, loss, lr, count, step,
                                 clip, momentum_coef)
    return _sgd_update_cuda(params, momentum, grads, loss, lr, count, step,
                            clip, momentum_coef)
