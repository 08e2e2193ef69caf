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
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, conv3x3_mma,
                                                          dense_conv)

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


# FCDenseNet-57's dense layers by level at 256x320: (h, w) -> (the bf16
# tile, the first and last layer's C); the bottleneck runs at 8x10
LEVELS = {(256, 320): ((8, 32), 48, 180), (128, 160): ((8, 32), 96, 228),
          (64, 80): ((16, 16), 144, 276), (32, 40): ((32, 8), 192, 324),
          (16, 20): ((8, 32), 240, 372), (8, 10): ((8, 32), 288, 324)}
# the wrapper's split of each level's first and last layer, by batch
SPLITS = {1: {(256, 320): (1, 1), (128, 160): (4, 4), (64, 80): (9, 13),
              (32, 40): (12, 21), (16, 20): (15, 24), (8, 10): (18, 21)},
          8: {(256, 320): (1, 1), (128, 160): (1, 1), (64, 80): (2, 2),
              (32, 40): (7, 7), (16, 20): (15, 16), (8, 10): (18, 21)},
          16: {(256, 320): (1, 1), (128, 160): (1, 1), (64, 80): (1, 1),
               (32, 40): (4, 4), (16, 20): (8, 8), (8, 10): (16, 16)}}


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_forward_tiling(batch):
    """The bf16 K1's tile, chunk split and halo vector width at every one of
    FCDenseNet-57's 44 layer shapes (256x320): the 256-pixel tile of the
    block engine's kernel; below SPLIT_BELOW tiles the 16-channel chunks
    split across ~FORWARD_BLOCKS blocks; 16-byte vectors where C % 8 == 0
    and 8-byte vectors where C = 4 mod 8 (22 of the 44 layers), on aligned
    tensors. In f32, 16x32 tiles, no split, scalar loads."""
    import chip_smoke
    shapes = chip_smoke.dense_layer_shapes(256, 320)
    widths = []
    for h, w, c in shapes:
        tile_h, tile_w, n_split = dense_conv.forward_tiling(torch.bfloat16, batch, h, w, c)
        tile, c_first, c_last = LEVELS[(h, w)]
        assert (tile_h, tile_w) == tile
        n_tiles = batch * -(-h // tile_h) * -(-w // tile_w)
        assert n_split == (1 if n_tiles >= dense_conv.SPLIT_BELOW else min(
            -(-c // 16), -(-conv3x3_mma.FORWARD_BLOCKS // n_tiles)))
        if c in (c_first, c_last):
            assert n_split == SPLITS[batch][(h, w)][c == c_last], (h, w, c)
        assert 1 <= n_split <= -(-c // 16)
        widths.append(dense_conv.vector_width(torch.bfloat16, c, 12, 512, 256, 1024))
        assert widths[-1] == (8 if c % 8 == 0 else 4)
        assert dense_conv.forward_tiling(torch.float32, batch, h, w, c) == (16, 32, 1)
        assert dense_conv.vector_width(torch.float32, c, 12, 512, 256, 1024) == 1
    assert widths.count(4) == 22 and widths.count(8) == 22


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_k1_and_k4_share_one_tiling_with_their_own_thresholds(batch):
    """K1 and the block engine's K4 launch one bf16 body, so both take
    their tiles from ``conv3x3_mma.forward_tiling``, each with the split
    threshold measured for it: at b8 64x80 (160 tiles) K1 splits and K4
    does not."""
    import chip_smoke
    for h, w, c in chip_smoke.dense_layer_shapes(256, 320):
        for dtype in (torch.bfloat16, torch.float32):
            for op in (dense_conv, block_engine):
                assert op.forward_tiling(dtype, batch, h, w, c) == \
                    conv3x3_mma.forward_tiling(dtype, batch, h, w, c, op.SPLIT_BELOW)
    if batch == 8:
        assert dense_conv.forward_tiling(torch.bfloat16, 8, 64, 80, 144) == (16, 16, 2)
        assert block_engine.forward_tiling(torch.bfloat16, 8, 64, 80, 144) == (16, 16, 1)


@pytest.mark.parametrize("case,want", [
    ("aligned_c8", 8), ("aligned_c4", 4), ("odd_c", 1), ("c_2_mod_4", 1),
    ("odd_f", 1), ("x_8_byte_aligned_c8", 4), ("x_2_byte_aligned", 1),
    ("w_misaligned", 1), ("y_misaligned", 1)])
def test_vector_width(case, want):
    """The bf16 halo's vector width: a vector of vw channels needs C a
    multiple of vw (so that it never runs past C into the next pixel) and
    x aligned to 2*vw bytes; the channel-pair weights and y need F even
    and 4-byte alignment. Anything else takes scalar loads."""
    c, f, x, w, y = {"aligned_c8": (96, 12, 0, 0, 0), "aligned_c4": (60, 12, 0, 0, 0),
                     "odd_c": (37, 12, 0, 0, 0), "c_2_mod_4": (50, 12, 0, 0, 0),
                     "odd_f": (96, 5, 0, 0, 0), "x_8_byte_aligned_c8": (96, 12, 8, 0, 0),
                     "x_2_byte_aligned": (96, 12, 2, 0, 0),
                     "w_misaligned": (96, 12, 0, 2, 0), "y_misaligned": (96, 12, 0, 0, 2)}[case]
    assert dense_conv.vector_width(torch.bfloat16, c, f, 4096 + x, 8192 + w, 16384 + y) == want


@pytest.mark.parametrize("b,h,w,c,f,bias", [
    (8, 16, 32, 20, 12, True),
    (8, 32, 40, 60, 12, False),
    (16, 8, 16, 7, 5, True),
])
def test_twin_matches_pallas_kernel(b, h, w, c, f, bias):
    """The bf16 kernel's tight twin computes the op: in f32 it matches
    JAX's fused_dense_conv (the Pallas kernel in interpret mode), plus the
    bias; in bf16 it is that f32 result of the rounded operands, rounded
    once."""
    x, scale, shift, wk = _inputs(b, h, w, c, f, seed=12)
    bv = np.linspace(-1, 1, f).astype(np.float32) if bias else None
    ref = np.asarray(jax_dense_conv.fused_dense_conv(*map(jnp.asarray, (x, scale, shift, wk))))
    t = [torch.from_numpy(a) for a in (x, scale, shift, wk)]
    tb = None if bv is None else torch.from_numpy(bv)
    got = dense_conv.fused_dense_conv_twin(*t, tb)
    np.testing.assert_allclose(got.numpy(), ref + (0 if bv is None else bv),
                               rtol=1e-5, atol=1e-5)
    x16, w16 = t[0].bfloat16(), t[3].bfloat16()
    got16 = dense_conv.fused_dense_conv_twin(x16, t[1], t[2], w16, tb)
    a = torch.relu(x16.float() * t[1] + t[2]).bfloat16().float()
    want = dense_conv.fused_dense_conv_twin(a, torch.ones(c), torch.zeros(c), w16.float(), tb)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, want.bfloat16())


def test_forward_without_grad_skips_the_autograd_node():
    """K1 is forward only. Where no gradient is wanted (serving, under
    inference_mode or no_grad) the op's output carries no autograd node;
    where one is, the values are the same and asking for the gradient
    raises."""
    x, scale, shift, wk = map(torch.from_numpy, _inputs(2, 6, 7, 20, 12, seed=13))
    bias = torch.linspace(-1, 1, 12)
    with torch.inference_mode():
        served = dense_conv.fused_dense_conv(x, scale, shift, wk, bias)
    assert served.grad_fn is None
    leaf = wk.clone().requires_grad_()
    with torch.no_grad():
        quiet = dense_conv.fused_dense_conv(x, scale, shift, leaf, bias)
    assert quiet.grad_fn is None and torch.equal(served, quiet)
    trained = dense_conv.fused_dense_conv(x, scale, shift, leaf, bias)
    assert torch.equal(served, trained.detach())
    with pytest.raises(RuntimeError, match="autograd"):
        torch.autograd.grad(trained.sum(), leaf)


def test_port_imports_no_jax():
    code = ("import sys, endoscopydepthestimation_pytorch_tpu_torch\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.serving\n"
            "from endoscopydepthestimation_pytorch_tpu_torch.serving import (\n"
            "    build_native_host, load_exported)\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.dense_conv\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops._libtorch_build\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.training\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.losses\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.schedule\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.geometry\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.gridsample\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.warp_sample\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.ops.block_engine\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.train\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.evaluate\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.models.unet\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.tracker\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.parallel.mesh\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.utils.pointcloud\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.readers\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.preprocess\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.rasterizer\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.native\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.augment\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.data.dataset\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.parallel.prefetch\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.utils.checkpoint\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.utils.plyio\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.utils.profiling\n"
            "import endoscopydepthestimation_pytorch_tpu_torch.utils.visualization\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'triton',\n"
            "                   'endoscopydepthestimation_pytorch_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
