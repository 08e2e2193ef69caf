"""fp8 (e4m3) activation store for the backward, and the dense-block
replay it shares with ``--remat`` (JAX package ``ops/act8.py``).

A train-mode dense block keeps its forward exact: it is the block
engine's forward (K4 per layer, ``block_engine.engine_forward``), so the
loss, the BatchNorm statistics and inference are those of the engine
route bit for bit. Only what crosses from the forward to the backward
shrinks (``ReplayBlock``):

- ``BWD_MODE = "replay"`` (JAX's default): the block saves an e4m3 copy
  of its input with a per-channel scale, and the parameters. Its
  backward dequantizes the copy, replays the engine's forward from it
  (K4 again) to rebuild the buffer and its statistics, and runs the
  engine's backward (K5, K6) on them: JAX's ``jax.vjp(_mat_impl)`` at
  the dequantized input (its ``act8.py:262-268``). The quantization error
  stays inside the block: every block's input is the previous block's
  exact output.
- ``"saved_buf"``: the block saves an e4m3 copy of its whole output
  buffer, the exact statistics and the parameters; its backward runs the
  engine's backward at the dequantized buffer (JAX :255-261).
- ``--remat`` (no quantization): the block saves its exact input and
  replays from it, so its gradients and statistics are the engine
  route's bit for bit (K4 is bitwise repeatable).

The replay runs inside the autograd Function's backward, below the
module: the model advances the BN running statistics once, in the
forward, from the statistics the Function returns. ``--act8
--block_engine`` keeps the dense blocks exact: they skip ``ReplayBlock``
and run ``block_engine.block_engine_apply``.

``compressed_call(fn, x, *args)`` is the same store for any other
function: ``fn`` runs exactly in the forward, an e4m3 copy of ``x`` and
the small ``args`` are saved, and the backward replays ``fn`` from the
copy under autograd. Under ``act8`` the model runs its transitions and
final conv through it (``td_apply``, ``tu_apply``, ``conv1x1_apply``),
and calls the same bodies directly otherwise, so the forwards are the
same ops either way; no dense block goes through it.

Scales target +-240, IEEE e4m3's maximum, not e4m3fn's 448, as in JAX
(whose docstring says why: a round trip through an IEEE e4m3 format maps
(240, 448] to inf); the bytes equal JAX's. JAX's ``_store_dense``,
``_load_dense``, ``_shape_token`` and its ``optimization_barrier``
(:77-107) are left out: they keep a TPU's tile padding and XLA's
simplifier from undoing the saving, and a float8 tensor on the card is
already dense. Quantizing is not a kernel: JAX computes it in XLA outside
any ``pallas_call``, and here it is plain PyTorch (``amax``, a divide, a
cast).

In a process group the replay's forward all-reduces its statistics again
(5 collectives a 4-layer block, issued from the backward in the autograd
graph's order, the same on every rank); in ``replay`` mode those
statistics are the dequantized input's, as JAX's ``_stats`` under
``axis_name``. Each rank quantizes with its own scale, as JAX's
``quantize8`` takes no ``pmean``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import block_engine as engine

F8 = torch.float8_e4m3fn
# IEEE e4m3's maximum (not e4m3fn's 448); see the module docstring
_F8_MAX = 240.0
# the dense block's backward in act8: "replay" or "saved_buf" (read at the
# forward, which stores it for its backward)
BWD_MODE = "replay"
_MODES = ("replay", "saved_buf")


def _channel_view(s: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[dim] = -1
    return s.view(shape)


def quantize8(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel dynamic-scale e4m3: (q, s) with |x / s| <= 240, ``s``
    f32 of shape (C,), C = x.shape[dim]; the amax runs over every other
    axis. ``dim`` is -1 for the engine's NHWC tensors and 1 for the
    model's NCHW ones."""
    dim = dim % x.dim()
    # |x| and its max are exact in x's dtype: no f32 copy for the amax
    amax = x.abs().amax(tuple(d for d in range(x.dim()) if d != dim)).float()
    s = torch.clamp_min(amax / _F8_MAX, 1e-12)
    return (x.float() / _channel_view(s, x.dim(), dim)).to(F8), s


def dequantize8(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype,
                dim: int = -1) -> torch.Tensor:
    """q * s in f32, cast to ``dtype``."""
    return (q.float() * _channel_view(s, q.dim(), dim % q.dim())).to(dtype)


class _CompressedCall(torch.autograd.Function):
    """``fn(x, *args)`` exactly; the backward replays ``fn`` from an e4m3
    copy of the NCHW ``x`` (JAX ``compressed_call``, :126-152)."""

    @staticmethod
    def forward(ctx, fn, x, *args):
        q, s = quantize8(x, dim=1)
        ctx.save_for_backward(q, s, *args)
        ctx.fn, ctx.dtype = fn, x.dtype
        return fn(x, *args)

    @staticmethod
    def backward(ctx, *cots):
        q, s, *args = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xt = dequantize8(q, s, ctx.dtype, dim=1).requires_grad_(needs[0])
            args = [a.detach().requires_grad_(n) for a, n in zip(args, needs[1:])]
            out = ctx.fn(xt, *args)
            outs = out if isinstance(out, tuple) else (out,)
            leaves = [t for t, n in zip([xt, *args], needs) if n]
            grads = iter(torch.autograd.grad(outs, leaves, cots, allow_unused=True))
        return (None, *(next(grads) if n else None for n in needs))


def compressed_call(fn: Callable, x: torch.Tensor, *args: torch.Tensor):
    """``fn(x, *args)``, differentiable in ``x`` and ``args``, with the
    NCHW ``x`` saved as e4m3 (a scale per channel, axis 1) and ``fn``
    replayed from it in the backward. ``fn`` must have no side effects."""
    return _CompressedCall.apply(fn, x, *args)


# -- the transitions' and the final conv's bodies (exact and act8 routes) ------


def td_apply(x, scale, shift, weight, bias) -> torch.Tensor:
    """TransitionDown's body (reference models.py:56-67): the folded BN
    affine (``scale``, ``shift`` f32 (C,)), ReLU, the 1x1 conv, the 2x2
    max-pool; NCHW."""
    dt = x.dtype
    y = torch.relu(x * scale.to(dt)[:, None, None] + shift.to(dt)[:, None, None])
    return F.max_pool2d(F.conv2d(y, weight.to(dt), bias.to(dt)), 2)


def tu_apply(x, weight, bias) -> torch.Tensor:
    """TransitionUp's upsample and conv (reference models.py:70-80): the
    nearest x2 upsample as one copy in NHWC, channels_last by
    construction (torch's upsample takes a 1x1 map, whose strides fit NCHW
    and channels_last alike, to NCHW, where a torch.export trace expects
    channels_last), then the 3x3 conv; NCHW."""
    n, c, h, w = x.shape
    up = (x.permute(0, 2, 3, 1)[:, :, None, :, None]
          .expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c).permute(0, 3, 1, 2))
    return F.conv2d(up, weight.to(x.dtype), bias.to(x.dtype), padding=1)


def conv1x1_apply(x, weight, bias) -> torch.Tensor:
    """The final 1x1 conv (reference models.py:131, 186); NCHW."""
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype))


# -- the dense block -----------------------------------------------------------


class ReplayBlock(torch.autograd.Function):
    """The engine's dense block whose backward replays its forward
    (``store`` "act8": per ``BWD_MODE``; "remat": from the exact input).
    The forward is ``engine_forward``, the backward ``engine_backward``."""

    @staticmethod
    def forward(ctx, x, n_layers, store, *params):
        buf, mu, m2 = engine.engine_forward(x, n_layers, params)
        mode = "exact" if store == "remat" else BWD_MODE
        if mode == "saved_buf":
            q, s = quantize8(buf)
            ctx.save_for_backward(q, s, mu, m2, *params)
        elif mode == "replay":
            q, s = quantize8(x)
            ctx.save_for_backward(q, s, *params)
        elif mode == "exact":
            ctx.save_for_backward(x, *params)
        else:
            raise ValueError(f"act8.BWD_MODE must be one of {_MODES}, got {mode!r}")
        ctx.mode, ctx.n_layers, ctx.dtype = mode, n_layers, x.dtype
        return buf, mu, m2

    @staticmethod
    def backward(ctx, gbuf, gmu, gm2):
        saved = ctx.saved_tensors
        n = ctx.n_layers
        if ctx.mode == "saved_buf":
            q, s, mu, m2, *params = saved
            buf = dequantize8(q, s, ctx.dtype)
        else:
            if ctx.mode == "replay":
                q, s, *params = saved
                x = dequantize8(q, s, ctx.dtype)
            else:
                x, *params = saved
            buf, mu, m2 = engine.engine_forward(x, n, params)
        dx, *dparams = engine.engine_backward(buf, mu, m2, n, params, gbuf, gmu, gm2)
        return (dx, None, None, *dparams)


def replay_block_apply(x: torch.Tensor, gammas: Sequence[torch.Tensor],
                       betas: Sequence[torch.Tensor],
                       kernels: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], store: str = "act8"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``block_engine.block_engine_apply`` with the backward replayed:
    ``store="act8"`` (JAX ``act8_block_apply``, per ``BWD_MODE``) or
    ``"remat"``. The same arguments, gate and results."""
    if store not in ("act8", "remat"):
        raise ValueError(f"store must be 'act8' or 'remat', got {store!r}")
    n_layers = len(kernels)
    if not (len(gammas) == len(betas) == len(biases) == n_layers):
        raise ValueError("need one gamma, beta, kernel and bias per layer")
    b, h, w, _ = x.shape
    if not engine.supported(b, h, w, n_layers, biases[0].shape[0]):
        raise ValueError(f"x {tuple(x.shape)} with growth "
                         f"{biases[0].shape[0]} is outside the engine's gate")
    return ReplayBlock.apply(x.contiguous(), n_layers, store, *gammas, *betas,
                             *kernels, *biases)
