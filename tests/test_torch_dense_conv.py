"""The port's fused dense-layer op against the JAX package's, on the CPU.

On CPU tensors the port's ``fused_dense_conv`` runs its plain PyTorch
version; the JAX side runs the Pallas kernel in interpret mode (as
tests/test_dense_conv.py does) or, at shapes its TPU gate refuses, the XLA
conv of the activated input. Same seeded numpy inputs to both, in f32 with
TF32 off.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.ops import dense_conv as jax_dense_conv
from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jax_dense_conv.INTERPRET
    jax_dense_conv.INTERPRET = True
    yield
    jax_dense_conv.INTERPRET = old


def _inputs(b, h, w, c, f, seed=0, shift_offset=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    wk = (rng.randn(3, 3, c, f) * 0.2).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = (rng.randn(c) * 0.3 + shift_offset).astype(np.float32)
    return x, scale, shift, wk


def _port(x, scale, shift, wk, bias=None):
    t = [torch.from_numpy(a) for a in (x, scale, shift, wk)]
    b = None if bias is None else torch.from_numpy(bias)
    before = dense_conv.LAUNCHES
    y = dense_conv.fused_dense_conv(*t, b)
    assert dense_conv.LAUNCHES == before  # CPU tensors: the plain version
    return y.numpy()


def _xla_layer(x, scale, shift, wk):
    a = jnp.maximum(x * scale + shift, 0.0)
    return jax.lax.conv_general_dilated(
        a, wk, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("b,h,w,c,f", [
    (8, 16, 32, 20, 12),
    (8, 32, 40, 150, 12),
    (16, 8, 16, 7, 5),
])
def test_matches_pallas_kernel(b, h, w, c, f):
    x, scale, shift, wk = _inputs(b, h, w, c, f)
    ref = jax_dense_conv.fused_dense_conv(*map(jnp.asarray, (x, scale, shift, wk)))
    np.testing.assert_allclose(_port(x, scale, shift, wk), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,c,f", [
    (1, 16, 20, 48, 12),   # batch 1 and W = 20: both refused by the TPU gate
    (3, 8, 10, 37, 12),
])
def test_matches_xla_where_tpu_gate_refuses(b, h, w, c, f):
    x, scale, shift, wk = _inputs(b, h, w, c, f, seed=1)
    ref = _xla_layer(*map(jnp.asarray, (x, scale, shift, wk)))
    np.testing.assert_allclose(_port(x, scale, shift, wk), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_border_pads_zero_after_activation():
    """shift > 0: padding with relu(shift) instead of 0 would fail here."""
    x, scale, shift, wk = _inputs(8, 16, 32, 20, 12, seed=2, shift_offset=2.0)
    assert (shift > 0).all()
    ref = jax_dense_conv.fused_dense_conv(*map(jnp.asarray, (x, scale, shift, wk)))
    np.testing.assert_allclose(_port(x, scale, shift, wk), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_bias_is_added():
    x, scale, shift, wk = _inputs(2, 6, 7, 5, 12, seed=3)
    bias = np.linspace(-1, 1, 12).astype(np.float32)
    ref = np.asarray(_xla_layer(*map(jnp.asarray, (x, scale, shift, wk)))) + bias
    np.testing.assert_allclose(_port(x, scale, shift, wk, bias), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["nchw_memory", "too_many_features",
                                  "wrong_weight_dtype", "wrong_scale_shape"])
def test_refuses_what_the_kernel_does_not_take(case):
    x, scale, shift, wk = map(torch.from_numpy, _inputs(1, 4, 5, 6, 12))
    if case == "nchw_memory":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case == "too_many_features":
        wk = torch.zeros(3, 3, 6, dense_conv.MAX_FEATURES + 1)
    elif case == "wrong_weight_dtype":
        wk = wk.to(torch.bfloat16)
    else:
        scale = scale[:5]
    with pytest.raises(ValueError):
        dense_conv.fused_dense_conv(x, scale, shift, wk)


def _jax_vjp(x, scale, shift, wk, gy):
    _, vjp = jax.vjp(jax_dense_conv.fused_dense_conv,
                     *map(jnp.asarray, (x, scale, shift, wk)))
    return [np.asarray(g) for g in vjp(jnp.asarray(gy))]


@pytest.mark.parametrize("b,h,w,c,f", [(8, 16, 32, 20, 12), (8, 32, 40, 150, 12)])
def test_backward_matches_jax_fused_bwd(b, h, w, c, f):
    """FusedDenseConv's backward against jax.vjp of the JAX op (Pallas
    forward in interpret mode, ``_fused_bwd``): dx, dscale, dshift, dw,
    and dbias against sum(gy). f32; the dscale/dshift/dw sums run over up
    to 10k positions, hence the relative 1e-4."""
    x, scale, shift, wk = _inputs(b, h, w, c, f, seed=9)
    rng = np.random.RandomState(10)
    gy = rng.randn(b, h, w, f).astype(np.float32)
    bias = rng.randn(f).astype(np.float32)
    want = _jax_vjp(x, scale, shift, wk, gy)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, scale, shift, wk, bias)]
    y = dense_conv.fused_dense_conv(*leaves)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    for name, a, r in zip(("dx", "dscale", "dshift", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), gy.sum((0, 1, 2)), rtol=1e-5,
                               atol=1e-4)


def test_backward_keeps_nhwc_and_masks_dead_units():
    """dx comes back as a contiguous NHWC tensor (no NCHW copy from
    autograd), and units with relu(x*scale+shift) == 0 get no gradient."""
    x, scale, shift, wk = _inputs(2, 6, 9, 5, 12, seed=11)
    shift[0] = -100.0  # channel 0 is dead everywhere
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, scale, shift, wk)]
    y = dense_conv.fused_dense_conv(*leaves)
    dx, dscale, dshift, _ = torch.autograd.grad(y.sum(), leaves)
    assert dx.is_contiguous() and dx.shape == (2, 6, 9, 5)
    assert (dx[..., 0] == 0).all() and dscale[0] == 0 and dshift[0] == 0


def test_port_imports_no_jax():
    code = ("import sys, endoscopydepthestimation_pytorch_tpu_torch\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.serving\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.training\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.losses\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.schedule\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.geometry\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.gridsample\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.warp_sample\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.block_engine\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'triton')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
