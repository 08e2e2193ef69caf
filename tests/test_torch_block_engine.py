"""The port's whole-dense-block engine (ops/block_engine.py) against the
JAX package's engine and against a plain layer-by-layer dense block under
autograd, on the CPU in f32 (TF32 off).

On CPU tensors the engine's per-layer calls run their plain twins, so
these tests hold the orchestration that the card runs around K4, K5 and
K6: the folds, the one buffer per block, the gradient buffer updated in
place, and the lazily applied (C1, C2) BN-through-statistics gradient.
JAX's engine runs its Pallas kernels in interpret mode.

Tolerances: outputs at rtol 1e-5 (f32 sums in another order); gradients at
rtol/atol 2e-4, the JAX package's own engine-vs-materialized tolerance
(tests/test_block_engine.py); the twins against autograd of
``fused_dense_conv_reference`` at 1e-5 of the reference's size.
"""
import copy
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.ops import block_engine as jax_engine
from endoscopydepthestimation_pytorch_tpu_torch.models.fcdensenet import DenseBlock
from endoscopydepthestimation_pytorch_tpu_torch.ops import block_engine, conv3x3_mma, dense_conv

import torch_port_cases  # noqa: F401  (TF32 off, two threads)


def _block_inputs(b, h, w, c0, growth, n_layers, seed):
    """x, the per-layer (gammas, betas, kernels, biases) and cotangents of
    (buf, mu, m2), as numpy f32."""
    rng = np.random.RandomState(seed)
    cs = [c0 + j * growth for j in range(n_layers)]
    x = rng.randn(b, h, w, c0).astype(np.float32)
    params = ([(rng.rand(c) + 0.5).astype(np.float32) for c in cs],
              [(rng.randn(c) * 0.1).astype(np.float32) for c in cs],
              [(rng.randn(3, 3, c, growth) * (2.0 / (9 * c)) ** 0.5)
               .astype(np.float32) for c in cs],
              [(rng.randn(growth) * 0.1).astype(np.float32) for _ in cs])
    ctot = c0 + n_layers * growth
    cots = (rng.randn(b, h, w, ctot).astype(np.float32),
            rng.randn(ctot).astype(np.float32), rng.randn(ctot).astype(np.float32))
    return x, params, cots


@pytest.mark.parametrize("b,h,w,c0,growth,n_layers", [
    (8, 8, 16, 6, 4, 3),
    (8, 8, 16, 6, 12, 4),  # FCDenseNet-57's block: growth 12, 4 layers
])
def test_block_engine_apply_matches_jax(monkeypatch, b, h, w, c0, growth,
                                        n_layers):
    """Outputs (buf, mu, m2) and the gradients of all inputs for a
    cotangent on all three outputs, so the statistics' cotangent path is
    covered too."""
    monkeypatch.setattr(jax_engine, "INTERPRET", True)
    x, params, cots = _block_inputs(b, h, w, c0, growth, n_layers, seed=0)

    def jax_run(x, params):
        out, vjp = jax.vjp(lambda *a: jax_engine.block_engine_apply(
            (growth, n_layers, 1e-5, None), *a), x, *params)
        return out, vjp(tuple(jnp.asarray(c) for c in cots))

    jparams = tuple(tuple(jnp.asarray(p) for p in group) for group in params)
    jout, jgrads = jax.jit(jax_run)(jnp.asarray(x), jparams)

    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for group in params for p in group]
    groups = [leaves[1 + i * n_layers:1 + (i + 1) * n_layers] for i in range(4)]
    out = block_engine.block_engine_apply(leaves[0], *groups)
    grads = torch.autograd.grad(out, leaves, [torch.from_numpy(c) for c in cots])

    for name, got, want in zip(("buf", "mu", "m2"), out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    want_grads = jax.tree.leaves(jgrads)
    assert len(want_grads) == len(grads)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=str(i))


def _seeded_block(c0, growth, n_layers, upsample, seed):
    rng = np.random.RandomState(seed)
    block = DenseBlock(c0, growth, n_layers, upsample=upsample)
    with torch.no_grad():
        for layer in block.layers:
            n = layer.norm.num_features
            layer.norm.weight.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5))
            layer.norm.bias.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
            layer.conv.bias.copy_(torch.from_numpy(
                rng.randn(growth).astype(np.float32) * 0.1))
    return block.train()


def _plain_block(block, x):
    """A train-mode dense block layer by layer from ``block``'s parameters,
    in plain PyTorch under autograd: BN on the batch statistics of the
    growing concatenation (biased variance, eps 1e-5, the gradient through
    them), then K1's plain version; the running statistics advanced once a
    layer. Returns (the output, the whole block's (mean, mean of
    squares))."""
    c0 = x.shape[1]
    for layer in block.layers:
        mu = x.mean((0, 2, 3))
        var = x.square().mean((0, 2, 3)) - mu.square()
        with torch.no_grad():
            layer.norm.running_mean.mul_(0.9).add_(0.1 * mu)
            layer.norm.running_var.mul_(0.9).add_(0.1 * var)
        scale = layer.norm.weight * torch.rsqrt(var + 1e-5)
        shift = layer.norm.bias - mu * scale
        y = dense_conv.fused_dense_conv_reference(
            x.permute(0, 2, 3, 1), scale, shift, layer.conv.weight.permute(2, 3, 1, 0),
            layer.conv.bias).permute(0, 3, 1, 2)
        x = torch.cat([x, y], 1)
    stats = (x.mean((0, 2, 3)), x.square().mean((0, 2, 3)))
    return (x[:, c0:] if block.upsample else x), stats


@pytest.mark.parametrize("upsample,with_stats,growth,n_layers", [
    (False, False, 12, 4), (True, False, 12, 4), (False, True, 12, 4), (True, True, 12, 4),
    (False, True, 16, 5),  # FCDenseNet-67's and -103's growth
])
def test_engine_block_matches_plain_autograd(monkeypatch, upsample, with_stats, growth,
                                             n_layers):
    """The port's train-mode ``DenseBlock`` (the engine) against a plain
    layer-by-layer block (``_plain_block``) at a shape the TPU engine's
    gate rejects (B = 2, 5x7): output, its statistics when asked for,
    every gradient, and the running statistics."""
    calls = []
    original = block_engine.layer_forward  # K4's wrapper, as the engine calls it

    def counting(*args):
        calls.append(args[1])
        return original(*args)

    monkeypatch.setattr(block_engine, "layer_forward", counting)
    rng = np.random.RandomState(1)
    c0 = 20
    x = torch.from_numpy(rng.randn(2, c0, 5, 7).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    eng_block = _seeded_block(c0, growth, n_layers, upsample, seed=2)
    ref_block = copy.deepcopy(eng_block)
    c_out = n_layers * growth + (0 if upsample else c0)
    cot = torch.from_numpy(rng.randn(2, c_out, 5, 7).astype(np.float32))
    results = []
    for block, run in ((ref_block, lambda leaf: _plain_block(ref_block, leaf)),
                       (eng_block, lambda leaf: eng_block(leaf, with_stats=True))):
        leaf = x.clone().requires_grad_()
        out, stats = run(leaf)
        loss = (out * cot).sum()
        if with_stats:
            loss = loss + torch.cos(3 * stats[0]).sum() + torch.sin(2 * stats[1]).sum()
        grads = torch.autograd.grad(loss, [leaf] + list(block.parameters()))
        results.append((out.detach(), [s.detach() for s in stats], grads,
                        copy.deepcopy(block.state_dict())))
    assert calls == [c0 + j * growth for j in range(n_layers)]  # the engine, a layer once
    (out0, st0, g0, sd0), (out1, st1, g1, sd1) = results
    assert out1.shape == (2, c_out, 5, 7)
    np.testing.assert_allclose(out1.numpy(), out0.numpy(), rtol=1e-5, atol=1e-5)
    for a, r in zip(st1, st0):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)
    for i, (a, r) in enumerate(zip(g1, g0)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=str(i))
    for k, v in sd0.items():
        np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("b,h,w,c,growth,extra", [(2, 6, 9, 10, 12, 5),
                                                  (1, 4, 4, 3, 4, 0)])
def test_twins_match_autograd_of_the_dense_layer(b, h, w, c, growth, extra):
    """K4's, K5's and K6's plain versions against autograd of
    ``fused_dense_conv_reference`` for one layer reading the prefix
    [0, c) of a buffer, with the cotangent gy_eff = g + c1 + c2*y."""
    rng = np.random.RandomState(3)
    ld = c + growth + extra
    buf = torch.from_numpy(rng.randn(b, h, w, ld).astype(np.float32))
    grad = torch.from_numpy(rng.randn(b, h, w, ld).astype(np.float32))
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3)
    wk = torch.from_numpy(rng.randn(3, 3, c, growth).astype(np.float32) * 0.3)
    bias = torch.from_numpy(rng.randn(growth).astype(np.float32) * 0.1)
    c1 = torch.from_numpy(rng.randn(growth).astype(np.float32) * 0.1)
    c2 = torch.from_numpy(rng.randn(growth).astype(np.float32) * 0.1)

    leaves = [t.clone().requires_grad_() for t in
              (buf[..., :c].contiguous(), scale, shift, wk, bias)]
    y = dense_conv.fused_dense_conv_reference(*leaves)
    fwd = buf.clone()
    sums = block_engine.layer_forward_reference(fwd, c, scale, shift, wk, bias)
    torch.testing.assert_close(fwd[..., c:c + growth], y.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sums, torch.stack([y.sum((0, 1, 2)), y.square().sum((0, 1, 2))]).detach(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(fwd[..., :c], buf[..., :c])
    assert torch.equal(fwd[..., c + growth:], buf[..., c + growth:])

    # the layer's output is buf's y; its cotangent gy_eff
    gy = grad[..., c:c + growth] + c1 + c2 * buf[..., c:c + growth]
    want = torch.autograd.grad(y, leaves, gy)
    new_grad = grad.clone()
    dsx, dss, dbias = block_engine.layer_dinput_reference(
        new_grad, buf, c, scale, shift, wk, c1, c2)
    for got, ref in ((new_grad[..., :c] - grad[..., :c], want[0]), (dsx, want[1]),
                     (dss, want[2]), (dbias, want[4])):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max())
    assert torch.equal(new_grad[..., c:], grad[..., c:])
    dw = block_engine.layer_dweight_reference(grad, buf, c, growth, scale, shift,
                                              c1, c2)
    torch.testing.assert_close(dw, want[3], rtol=1e-5, atol=1e-5 * want[3].abs().max())


def test_gate_is_the_ports_own():
    """Every FCDenseNet-57 block at 256x320, 128x160 and 512x576 passes,
    and so do shapes the TPU gate rejects; growth above the kernels'
    maximum does not."""
    for height, width in ((256, 320), (128, 160), (512, 576)):
        for level in range(6):
            assert block_engine.supported(16, height >> level, width >> level, 4, 12)
    assert block_engine.supported(2, 5, 7, 4, 12)
    assert not jax_engine.supported(2, 5, 7, 4)
    assert not block_engine.supported(2, 8, 8, 4, block_engine.MAX_GROWTH + 1)


def test_dinput_tiling():
    """K5's tiles: in bf16, 256 pixels in the width that pads the image
    least (the widest on a tie), one block per 32 channels; in f32, 16x32
    tiles with the 16-channel chunks split up to ~TARGET_BLOCKS blocks."""
    want = {(256, 320): (8, 32), (128, 160): (8, 32), (64, 80): (16, 16),
            (32, 40): (32, 8), (16, 20): (8, 32), (8, 10): (8, 32),
            (20, 44): (8, 32)}
    for (h, w), tile in want.items():  # C = 60: two 32-channel chunks
        assert block_engine.dinput_tiling(torch.bfloat16, 16, h, w, 60) == (*tile, 2)
    assert block_engine.dinput_tiling(torch.bfloat16, 2, 17, 33, 7) == (32, 8, 1)
    # the card tests' odd-C shapes that reach the scalar path's wider tiles
    assert block_engine.dinput_tiling(torch.bfloat16, 2, 16, 20, 7) == (8, 32, 1)
    assert block_engine.dinput_tiling(torch.bfloat16, 2, 64, 80, 7) == (16, 16, 1)
    assert block_engine.dinput_tiling(torch.float32, 16, 256, 320, 48) == (16, 32, 1)
    # 16 * 1 * 1 tiles at 8x10: every one of the 24 chunks of 372 channels
    assert block_engine.dinput_tiling(torch.float32, 16, 8, 10, 372) == (16, 32, 24)


def test_forward_tiling():
    """K4's tiles: in bf16, K5's 256-pixel tile, and below SPLIT_BELOW
    tiles the 16-channel chunks split across ~FORWARD_BLOCKS blocks; in
    f32, 16x32 tiles and no split. Pinned for FCDenseNet-57's 44 layers at
    2B = 16, 256x320 (by level, first and last prefix) and for the card
    tests' shapes."""
    levels = {(256, 320): ((8, 32), 48, 1, 180, 1), (128, 160): ((8, 32), 96, 1, 228, 1),
              (64, 80): ((16, 16), 144, 1, 276, 1), (32, 40): ((32, 8), 192, 4, 324, 4),
              (16, 20): ((8, 32), 240, 8, 372, 8), (8, 10): ((8, 32), 288, 16, 324, 16)}
    for (h, w), (tile, c_first, s_first, c_last, s_last) in levels.items():
        assert block_engine.forward_tiling(torch.bfloat16, 16, h, w, c_first) == (
            *tile, s_first)
        assert block_engine.forward_tiling(torch.bfloat16, 16, h, w, c_last) == (
            *tile, s_last)
        assert block_engine.forward_tiling(torch.float32, 16, h, w, c_last) == (16, 32, 1)
    # every bf16 tile width, with and without the split
    cards = {(8, 64, 80, 180): (16, 16, 1), (2, 17, 33, 7): (32, 8, 1),
             (4, 8, 10, 324): (8, 32, 21), (4, 32, 64, 60): (8, 32, 4),
             (2, 20, 44, 36): (8, 32, 3), (2, 16, 20, 7): (8, 32, 1),
             (2, 64, 80, 7): (16, 16, 1), (2, 32, 40, 16): (32, 8, 1)}
    for (b, h, w, c), want in cards.items():
        assert block_engine.forward_tiling(torch.bfloat16, b, h, w, c) == want


def test_cpu_engine_launches_no_kernel():
    before = dict(block_engine.LAUNCHES)
    x, params, cots = _block_inputs(1, 3, 4, 5, 4, 2, seed=4)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for group in params for p in group]
    out = block_engine.block_engine_apply(leaves[0], *(leaves[1 + 2 * i:3 + 2 * i]
                                                       for i in range(4)))
    torch.autograd.grad(out, leaves, [torch.from_numpy(c) for c in cots])
    assert block_engine.LAUNCHES == before


def _engine_layers(height=256, width=320):
    """(H, W, C, ld) of FCDenseNet-57's 44 engine layers: 11 blocks of four
    growth-12 layers, each block's buffer ld = C0 + 48."""
    import chip_smoke
    return [(h, w, c0 + 12 * j, c0 + 48)
            for h, w, c0 in chip_smoke.dense_block_shapes(height, width) for j in range(4)]


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_dweight_tiling(batch):
    """K6's tiles at the 44 layers: in bf16 the 256-pixel tile of
    ``conv3x3_mma.mma_tile``; every split gets at least one tile; the grid
    (chunks, n_split) fits CUDA's limits and at most DWEIGHT_BLOCKS blocks;
    the scratch (n_split, 9, C, F) f32 stays within 1 MB a 16-channel chunk.
    In f32, 8x32 tiles up to ~TARGET_BLOCKS blocks."""
    for h, w, c, _ in _engine_layers():
        chunks = -(-c // block_engine.CHUNK)
        tile_h, tile_w, n_split = block_engine.dweight_tiling(torch.bfloat16, batch, h, w, c)
        assert (tile_h, tile_w) == conv3x3_mma.mma_tile(h, w)
        n_tiles = conv3x3_mma.n_tiles(batch, h, w, tile_h, tile_w)
        assert 1 <= n_split <= min(n_tiles, 65535), (h, w, c)
        assert chunks * n_split <= block_engine.DWEIGHT_BLOCKS
        assert n_split == min(n_tiles, block_engine.DWEIGHT_BLOCKS // chunks)
        assert n_split * 9 * c * 12 * 4 <= chunks * 2 ** 20
        tile_h, tile_w, n_split = block_engine.dweight_tiling(torch.float32, batch, h, w, c)
        assert (tile_h, tile_w) == (block_engine.DWEIGHT_TILE_H, block_engine.TILE_W)
        assert 1 <= n_split <= conv3x3_mma.n_tiles(batch, h, w, tile_h, tile_w)
    # one tile: one split; a single chunk at 320 tiles: the most blocks
    assert block_engine.dweight_tiling(torch.bfloat16, 1, 8, 10, 48)[2] == 1
    assert block_engine.dweight_tiling(torch.bfloat16, 16, 64, 80, 16) == (
        16, 16, block_engine.DWEIGHT_BLOCKS)


def test_dweight_vector_width():
    """bf16 K6's loads at the 44 layers on 16-byte aligned buffers: every
    layer takes 16-byte prefix vectors (ld % 8 == 0) and 8-byte g and y
    vectors (C % 4 == 0); C % 8 == 4 in 22 layers, where a 16-byte g or y
    vector would be misaligned. No prefix vector that starts below C ends
    past ld; no g or y vector ends past C + F; each starts on a multiple of
    its own size in bytes. Anything else takes scalars."""
    f, c4 = 12, 0
    for _, _, c, ld in _engine_layers():
        assert block_engine.dweight_vector_width(torch.bfloat16, c, f, ld, 4096, 8192) == 8
        pixel = 7 * ld  # any pixel's row start, in elements
        for start in range(0, c, 8):
            assert start + 8 <= ld and 2 * (pixel + start) % 16 == 0
        for start in range(c, c + f, 4):
            assert start + 4 <= c + f and 2 * (pixel + start) % 8 == 0
        c4 += c % 8 == 4
        assert (2 * (pixel + c) % 16 == 0) == (c % 8 == 0)
        assert block_engine.dweight_vector_width(torch.float32, c, f, ld, 4096, 8192) == 1
    assert c4 == 22
    for c, f, ld, buf, grad in ((37, 12, 56, 0, 0), (36, 5, 48, 0, 0), (36, 12, 52, 0, 0),
                                (36, 12, 48, 8, 0), (36, 12, 48, 0, 2), (50, 12, 64, 0, 0)):
        assert block_engine.dweight_vector_width(torch.bfloat16, c, f, ld, 4096 + buf,
                                                 8192 + grad) == 1


def _dweight_by_tiles(grad, buf, c, f, scale, shift, c1, c2):
    """K6's coverage on the CPU: per tile of ``dweight_tiling``, the
    product of the tile's halo of a (zero outside the image) and its gy_eff
    (zero outside the image), summed per split over the tiles t = split,
    split + S, ... in the kernel's order (t -> image t // tiles_img, row
    (t % tiles_img) // tiles_w, column t % tiles_w), then over the splits
    in order."""
    b, h, w, _ = buf.shape
    tile_h, tile_w, n_split = block_engine.dweight_tiling(torch.bfloat16, b, h, w, c)
    rows, cols = -(-h // tile_h), -(-w // tile_w)
    hp, wp = rows * tile_h, cols * tile_w
    a = torch.zeros(b, hp + 2, wp + 2, c)
    a[:, 1:h + 1, 1:w + 1] = block_engine._activation(buf, c, scale, shift)
    gy = torch.zeros(b, hp, wp, f)
    gy[:, :h, :w] = block_engine._gy_eff(grad, buf, c, f, c1, c2)
    parts = []
    for split in range(n_split):
        part = torch.zeros(3, 3, c, f)
        for t in range(split, b * rows * cols, n_split):
            img, ti = divmod(t, rows * cols)
            h0, w0 = (ti // cols) * tile_h, (ti % cols) * tile_w
            g_t = gy[img, h0:h0 + tile_h, w0:w0 + tile_w].reshape(-1, f)
            for ky in range(3):
                for kx in range(3):
                    a_t = a[img, h0 + ky:h0 + ky + tile_h, w0 + kx:w0 + kx + tile_w]
                    part[ky, kx] += a_t.reshape(-1, c).T @ g_t
        parts.append(part)
    return torch.stack(parts).sum(0), n_split


@pytest.mark.parametrize("b,h,w,c,f,extra", [(2, 17, 33, 7, 5, 3), (3, 9, 21, 20, 12, 0),
                                             (1, 8, 10, 36, 16, 4), (2, 40, 24, 5, 1, 2)])
def test_dweight_tiles_cover_each_pixel_once(b, h, w, c, f, extra):
    """The bf16 K6's (tile, split) assignment, emulated in f32, gives the
    plain version's dW: every pixel of every image is counted exactly once,
    in ragged tiles too."""
    rng = np.random.RandomState(5)
    ld = c + f + extra
    buf = torch.from_numpy(rng.randn(b, h, w, ld).astype(np.float32))
    grad = torch.from_numpy(rng.randn(b, h, w, ld).astype(np.float32))
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3)
    c1 = torch.from_numpy(rng.randn(f).astype(np.float32) * 0.1)
    c2 = torch.from_numpy(rng.randn(f).astype(np.float32) * 0.1)
    got, n_split = _dweight_by_tiles(grad, buf, c, f, scale, shift, c1, c2)
    assert n_split > 1 or b * h * w <= 256
    ref = block_engine.layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max())


# -- the block's boundary: the entry (x into buf, its moments) and the exit (dx)

# (B, H, W, C0, ld): FCDenseNet-57's last up block, FC-DenseNet-103's, and
# a C0 that is not a multiple of 8 (the kernels' scalar path), at few pixels
BOUNDARY_SHAPES = [(2, 8, 10, 144, 192), (2, 8, 10, 192, 256), (3, 5, 7, 37, 61)]


def _boundary_inputs(b, h, w, c0, ld, dtype, seed=11):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, h, w, c0, generator=g) + 1).to(dtype)
    buf = torch.randn(b, h, w, ld, generator=g).to(dtype)
    grad = torch.randn(b, h, w, ld, generator=g).to(dtype)
    c1, c2 = torch.randn(ld, generator=g) * 0.1, torch.randn(ld, generator=g) * 0.1
    return x, buf, grad, c1, c2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c0,ld", BOUNDARY_SHAPES)
def test_boundary_twins_are_the_expressions_they_replace(b, h, w, c0, ld, dtype):
    """``block_entry_reference`` and ``block_exit_reference`` bitwise the
    expressions ``engine_forward`` and ``engine_backward`` wrote inline, and
    the wrappers on CPU tensors bitwise the twins. dx is also the kernel's
    arithmetic emulated in numpy f32: (g + c1) + c2*x, each step rounded,
    no fused multiply-add, then rounded to the dtype."""
    x, buf, grad, c1, c2 = _boundary_inputs(b, h, w, c0, ld, dtype)
    got_buf, want_buf = buf.clone(), buf.clone()
    stats = block_engine.block_entry_reference(x, got_buf)
    want_buf[..., :c0] = x
    xf = x.float()
    assert torch.equal(got_buf, want_buf)
    assert stats.dtype == torch.float32 and torch.equal(
        stats, torch.stack([xf.mean((0, 1, 2)), xf.square().mean((0, 1, 2))]))
    dx = block_engine.block_exit_reference(grad, buf, c1, c2, c0)
    x0 = buf[..., :c0].float()
    want = (grad[..., :c0].float() + c1[:c0] + c2[:c0] * x0).to(dtype)
    assert dx.is_contiguous() and dx.dtype == dtype and torch.equal(dx, want)
    g32, x32 = grad[..., :c0].float().numpy(), x0.numpy()
    emulated = (g32 + c1[:c0].numpy()) + c2[:c0].numpy() * x32
    assert emulated.dtype == np.float32
    assert torch.equal(dx, torch.from_numpy(emulated).to(dtype))
    entry_buf = buf.clone()
    assert torch.equal(block_engine.block_entry(x, entry_buf), stats)
    assert torch.equal(entry_buf, got_buf)
    assert torch.equal(block_engine.block_exit(grad, buf, c1, c2, c0), dx)


def _bad_boundary_calls():
    bf16 = torch.bfloat16
    x, buf = torch.zeros(2, 4, 5, 16, dtype=bf16), torch.zeros(2, 4, 5, 24, dtype=bf16)
    grad, c = torch.zeros_like(buf), torch.zeros(24)
    wide = torch.zeros(2, 4, 5, 32, dtype=bf16)
    entry, exit_ = block_engine.block_entry, block_engine.block_exit
    return {
        "entry x not contiguous": lambda: entry(wide[..., ::2], buf),
        "entry x of another dtype": lambda: entry(x.float(), buf),
        "entry buf of a dtype without kernels": lambda: entry(x.half(), buf.half()),
        "entry buf not contiguous": lambda: entry(x, wide[..., :24]),
        "entry c0 > ctot": lambda: entry(wide, buf),
        "entry another image size": lambda: entry(x[:, :3].contiguous(), buf),
        "exit c0 > ctot": lambda: exit_(grad, buf, c, c, 25),
        "exit c0 = 0": lambda: exit_(grad, buf, c, c, 0),
        "exit grad of another dtype": lambda: exit_(grad.float(), buf, c, c, 16),
        "exit grad not contiguous": lambda: exit_(torch.zeros(2, 4, 5, 48, dtype=bf16)[..., ::2],
                                                   buf, c, c, 16),
        "exit c1 of another length": lambda: exit_(grad, buf, c[:16], c, 16),
        "exit c2 not float32": lambda: exit_(grad, buf, c, c.double(), 16),
    }


@pytest.mark.parametrize("case", list(_bad_boundary_calls()))
def test_boundary_wrappers_refuse_what_the_kernels_do_not_take(case):
    """Checked before the CPU twin or any launch, so the CPU sees what the
    card would refuse."""
    with pytest.raises((ValueError, TypeError)):
        _bad_boundary_calls()[case]()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_boundary_on_the_cpu_is_the_old_inline_code(monkeypatch, dtype):
    """``engine_forward`` and ``engine_backward`` on CPU tensors give the
    same tensors, bitwise, as with the boundary's old inline expressions
    put back in the place of ``block_entry`` and ``block_exit``."""
    x, params, cots = _block_inputs(2, 5, 7, 10, 4, 3, seed=6)
    x = torch.from_numpy(x).to(dtype)
    params = [torch.from_numpy(p) for group in params for p in group]
    gbuf, gmu, gm2 = (torch.from_numpy(cots[0]).to(dtype), torch.from_numpy(cots[1]),
                      torch.from_numpy(cots[2]))

    def run():
        buf, mu, m2 = block_engine.engine_forward(x, 3, params)
        return (buf, mu, m2, *block_engine.engine_backward(buf, mu, m2, 3, params, gbuf,
                                                           gmu, gm2))

    got = run()

    def old_entry(x, buf):
        c0 = x.shape[3]
        buf[..., :c0] = x
        xf = x.float()
        return torch.stack([xf.mean((0, 1, 2)), xf.square().mean((0, 1, 2))])

    def old_exit(grad, buf, c1, c2, c0):
        x = buf[..., :c0].float()
        dx = (grad[..., :c0].float() + c1[:c0] + c2[:c0] * x).to(buf.dtype)
        return dx.contiguous()

    monkeypatch.setattr(block_engine, "block_entry", old_entry)
    monkeypatch.setattr(block_engine, "block_exit", old_exit)
    want = run()
    assert len(got) == len(want) == 3 + 1 + 4 * 3
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.dtype == r.dtype and torch.equal(a, r), i


def _engine_boundaries(net: str) -> list:
    """(C0, ld) of the 11 engine blocks of FCDenseNet-57 or FC-DenseNet-103,
    in forward order."""
    import chip_smoke
    if net == "fcdensenet57":
        blocks, kwargs = (4,) * 11, {}
    else:
        down, up = (4, 5, 7, 10, 12), (12, 10, 7, 5, 4)
        blocks, kwargs = down + (15,) + up, dict(down=down, up=up, bottleneck=15, growth=16)
    layers = chip_smoke.dense_layer_shapes(256, 320, **kwargs)
    growth = kwargs.get("growth", 12)
    starts = np.cumsum((0,) + blocks[:-1])
    return [(layers[s][2], layers[s][2] + n * growth) for s, n in zip(starts, blocks)]


def _cu_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/block_engine.cu``, the one place the
    boundary kernels' launch is decided."""
    source = (Path(block_engine.__file__).resolve().parents[1] / "csrc"
              / "block_engine.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _boundary_grid(pixels: int, c0: int, vw: int) -> tuple:
    """(lanes, rows, groups, blocks) of the C entries' ``boundary_layout``
    at vector width vw, emulated with the file's ``NTB`` and
    ``BOUNDARY_BLOCKS``: lanes channel vectors a row, rows a block, groups
    of lanes side by side (grid.y), blocks striding over the pixels (grid.x)."""
    threads, cap = _cu_constant("NTB"), _cu_constant("BOUNDARY_BLOCKS")
    lanes = min(c0 // vw, threads)
    rows, groups = threads // lanes, -(-(c0 // vw) // lanes)
    return lanes, rows, groups, max(1, min(-(-pixels // rows), cap // groups))


def _boundary_vector_width(dtype, c0: int, ld: int, *bases: int) -> int:
    """The C entries' vector width, emulated: a 16-byte vector of channels
    where C0 and ld are multiples of it and every base is aligned, else 1."""
    vw = 16 // dtype.itemsize
    return vw if c0 % vw == 0 and ld % vw == 0 and all(p % 16 == 0 for p in bases) else 1


def _boundary_coverage(pixels: int, c0: int, vw: int) -> np.ndarray:
    """How often the boundary kernels' threads take each (pixel, channel):
    the C launch's layout and each thread's pixel stride, emulated."""
    lanes, rows, groups, n_blocks = _boundary_grid(pixels, c0, vw)
    count = np.zeros((pixels, c0), np.int64)
    for by in range(groups):
        first = (by * lanes + np.arange(lanes)) * vw
        channels = (first[first < c0, None] + np.arange(vw)).ravel()
        for bx in range(n_blocks):
            for row in range(rows):
                p = np.arange(bx * rows + row, pixels, n_blocks * rows)
                count[np.ix_(p, channels)] += 1
    return count


@pytest.mark.parametrize("net", ["fcdensenet57", "fcdensenet103"])
def test_boundary_vectors_and_grid_at_every_block(net):
    """Every block of FCDenseNet-57 and FC-DenseNet-103 takes 16-byte
    vectors on aligned buffers (8 bf16 or 4 f32 channels: C0 and ld are
    multiples of 8); a misaligned base or a C0 or ld off the vector takes
    scalars. The grid stays within ``BOUNDARY_BLOCKS`` of the C file, at
    2B = 16 256x320 and at 2B = 2 8x10, and fills a wave at 256x320."""
    boundaries = _engine_boundaries(net)
    assert len(boundaries) == 11
    cap = _cu_constant("BOUNDARY_BLOCKS")
    for c0, ld in boundaries:
        for dtype, vw in ((torch.bfloat16, 8), (torch.float32, 4)):
            assert _boundary_vector_width(dtype, c0, ld, 4096, 8192) == vw
            assert _boundary_vector_width(dtype, c0, ld, 4096, 8200) == 1
            for pixels in (16 * 256 * 320, 2 * 8 * 10):
                _, _, groups, blocks = _boundary_grid(pixels, c0, vw)
                assert 1 <= blocks * groups <= cap
            _, _, groups, blocks = _boundary_grid(16 * 256 * 320, c0, vw)
            assert blocks * groups > cap - groups
    assert _boundary_vector_width(torch.bfloat16, 36, 48, 0, 0) == 1
    assert _boundary_vector_width(torch.bfloat16, 48, 52, 0, 0) == 1
    assert _boundary_vector_width(torch.float32, 36, 52, 0, 0) == 4


@pytest.mark.parametrize("pixels,c0,vw", [(70, 37, 1), (70, 301, 1), (81920, 48, 8),
                                          (80, 656, 8), (40, 2056, 8), (1280, 64, 4)])
def test_boundary_threads_take_each_element_once(pixels, c0, vw):
    """The boundary kernels' (block, thread) -> (pixels, channel vector)
    assignment covers every element of the prefix exactly once: ragged
    rows, a row wider than a block (C0 / vw > 256: groups of lanes), the
    grid at its cap, scalars and vectors."""
    assert (_boundary_coverage(pixels, c0, vw) == 1).all()


# -- the glue: the per-channel math between the launches -----------------------


def _old_engine_forward(x, n_layers, params):
    """``engine_forward`` as it was with the glue written inline."""
    gammas, betas, kernels, biases = block_engine._split(params, n_layers)
    b, h, w, c0 = x.shape
    growth = biases[0].shape[0]
    n = b * h * w
    buf = torch.empty((b, h, w, c0 + n_layers * growth), dtype=x.dtype)
    mu_x, m2_x = block_engine.block_entry(x, buf)
    mus, m2s = [mu_x], [m2_x]
    for j in range(n_layers):
        mu, m2 = torch.cat(mus), torch.cat(m2s)
        scale, shift, _ = block_engine.fold(gammas[j], betas[j], mu, m2 - mu.square())
        sums = block_engine.layer_forward(buf, c0 + j * growth, scale, shift,
                                          kernels[j].to(x.dtype).contiguous(),
                                          biases[j].float().contiguous()).sum(1)
        stats = sums / n
        mus.append(stats[0])
        m2s.append(stats[1])
    return buf, torch.cat(mus), torch.cat(m2s)


def _old_engine_backward(buf, mu, m2, n_layers, params, gbuf, gmu, gm2):
    """``engine_backward`` as it was with the glue written inline."""
    gammas, betas, kernels, biases = block_engine._split(params, n_layers)
    b, h, w, ctot = buf.shape
    growth = biases[0].shape[0]
    c0 = ctot - n_layers * growth
    n = b * h * w
    grad = torch.empty_like(buf)
    grad.copy_(gbuf)
    gmu, gm2 = gmu.float(), gm2.float()
    c1 = gmu / n
    c2 = 2.0 * gm2 / n
    dgammas, dbetas, dkernels, dbiases = ([None] * n_layers for _ in range(4))
    for j in reversed(range(n_layers)):
        c = c0 + j * growth
        scale, shift, inv = block_engine.fold(gammas[j], betas[j], mu[:c],
                                              m2[:c] - mu[:c].square())
        c1j = c1[c:c + growth].contiguous()
        c2j = c2[c:c + growth].contiguous()
        part, part_bias = block_engine.layer_dinput(
            grad, buf, c, scale, shift, kernels[j].to(buf.dtype).contiguous(), c1j, c2j)
        (dsx, dss), dbiases[j] = part.sum(1), part_bias.sum(0)
        dkernels[j] = block_engine.layer_dweight(grad, buf, c, growth, scale, shift, c1j, c2j)
        dgamma = inv * (dsx - mu[:c] * dss)
        dgammas[j], dbetas[j] = dgamma, dss
        gamma = gammas[j].float()
        c2[:c] -= gamma * inv * inv * dgamma / n
        c1[:c] += gamma * inv * (inv * mu[:c] * dgamma - dss) / n
    dx = block_engine.block_exit(grad, buf, c1, c2, c0)
    return (dx, *dgammas, *dbetas, *dkernels, *dbiases)


@pytest.mark.parametrize("split", [False, True], ids=["one-call", "two-calls"])
@pytest.mark.parametrize("layout", ["hwio", "oihw-view"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_glue_on_the_cpu_is_the_old_inline_code(monkeypatch, dtype, layout, split):
    """``engine_forward`` and ``engine_backward`` on CPU tensors, where the
    glue runs its twins, give the same tensors, bitwise, as the engine with
    the glue written inline as before: the statistics, the folds, the
    kernels cast, dgamma, dbeta, the bias gradient and (C1, C2) through dx.
    With the kernels as the model passes them (HWIO views of OIHW
    parameters) too, and with the glue split into its two calls around
    each collective, as a process group runs it (``split``: a group whose
    collectives change nothing)."""
    x, params, cots = _block_inputs(2, 5, 7, 10, 4, 3, seed=7)
    x = torch.from_numpy(x).to(dtype)
    params = [torch.from_numpy(p) for group in params for p in group]
    if layout == "oihw-view":
        params[6:9] = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
                       for k in params[6:9]]
        assert not params[6].is_contiguous()
    gbuf, gmu, gm2 = (torch.from_numpy(cots[0]).to(dtype), torch.from_numpy(cots[1]),
                      torch.from_numpy(cots[2]))

    def run(forward, backward):
        buf, mu, m2 = forward(x, 3, params)
        return (buf, mu, m2, *backward(buf, mu, m2, 3, params, gbuf, gmu, gm2))

    want = run(_old_engine_forward, _old_engine_backward)
    calls = []

    def record(name, flags_at):
        original = getattr(block_engine, name)

        def call(*args):
            calls.append((name, None if flags_at is None else args[flags_at]))
            return original(*args)

        monkeypatch.setattr(block_engine, name, call)

    for name, flags_at in (("glue_forward", 5), ("glue_backward", 7),
                           ("glue_backward_start", None)):
        record(name, flags_at)
    if split:
        monkeypatch.setattr(block_engine.distributed, "group", lambda: object())
    got = run(block_engine.engine_forward, block_engine.engine_backward)
    assert len(got) == len(want) == 3 + 1 + 4 * 3
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.dtype == r.dtype and a.shape == r.shape and torch.equal(a, r), i
    per_layer = ([REDUCE, FINISH] if split else [REDUCE | FINISH]) * 3
    assert calls == ([("glue_forward", FINISH)] + [("glue_forward", f) for f in per_layer]
                     + [("glue_backward_start", None)]
                     + [("glue_backward", f) for f in per_layer])


REDUCE, FINISH = block_engine.REDUCE, block_engine.FINISH


def test_running_stats_twin_is_the_update_running_stats_loop():
    """``block_engine.running_stats`` on CPU tensors (its twin, which the
    card's one launch a block replaces) moves every layer's running mean
    and variance bitwise as ``update_running_stats`` called layer by layer
    on the block's prefix statistics did."""
    from endoscopydepthestimation_pytorch_tpu_torch.models import fcdensenet
    g = torch.Generator().manual_seed(5)
    c0, growth, n_layers = 20, 12, 5
    ctot = c0 + n_layers * growth
    mu = torch.randn(ctot, generator=g)
    m2 = mu.square() + torch.rand(ctot, generator=g) + 0.1
    norms = []
    for j in range(n_layers):
        bn = torch.nn.BatchNorm2d(c0 + j * growth)
        bn.running_mean.copy_(torch.randn(bn.num_features, generator=g))
        bn.running_var.copy_(torch.rand(bn.num_features, generator=g) + 0.5)
        norms.append(bn)
    want = copy.deepcopy(norms)
    for j, bn in enumerate(want):
        c = c0 + j * growth
        fcdensenet.update_running_stats(bn, mu[:c], m2[:c])
    block_engine.running_stats([(bn.running_mean, bn.running_var) for bn in norms],
                               mu.requires_grad_(), m2, c0, growth, fcdensenet.MOMENTUM)
    for bn, ref in zip(norms, want):
        assert torch.equal(bn.running_mean, ref.running_mean)
        assert torch.equal(bn.running_var, ref.running_var)
        assert not bn.running_mean.requires_grad


def _load_metric(name: str):
    """A per-layer metric reader of the benchmark, loaded by its path."""
    import importlib.util
    root = Path(block_engine.__file__).resolve().parents[2] / "h100bench"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  root / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_glue_kernels_count_as_pytorch_kernels_not_the_engines(monkeypatch):
    """The glue kernels take the place of PyTorch kernels: their names, as
    a device trace shows a function of ``csrc/block_engine.cu`` (with or
    without template arguments), match neither the port's kernels of
    ``torch_ops_ms_per_step.train`` nor the engine's of
    ``engine_roofline``, so the first counts them where it counted the
    glue and the second measures K4-K6 alone (as the boundary's); every
    other kernel of the file, K4-K6's, matches both."""
    monkeypatch.syspath_prepend(str(Path(block_engine.__file__).resolve().parents[2]
                                    / "h100bench"))
    port = _load_metric("torch_ops_ms_per_step.train").PORT_KERNELS
    engine = _load_metric("engine_roofline").ENGINE
    source = (Path(block_engine.__file__).resolve().parents[1] / "csrc"
              / "block_engine.cu").read_text()
    names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                           source))
    glue = {"glue_forward_kernel", "glue_backward_kernel", "glue_running_stats_kernel"}
    boundary = {"boundary_entry_kernel", "boundary_entry_finish_kernel", "boundary_exit_kernel"}
    assert glue | boundary <= names and len(names) == 12
    for name in names:
        traced = [f"void (anonymous namespace)::{name}{t}((anonymous namespace)::Args)"
                  for t in ("", "<float>", "<__nv_bfloat16>", "<float, 4>")]
        if name in glue | boundary:
            assert not any(port(t) or engine(t) for t in traced), name
        else:
            assert any(port(t) for t in traced) and any(engine(t) for t in traced), name


def _glue_layout(n_part: int, nc: int, nb: int) -> tuple:
    """(groups, width, segments, chunks, rows) of the glue's reduction, as
    the C entries' ``glue_layout`` picks them, emulated with the file's
    constants; the entries refuse more than ``GLUE_CHANNELS`` channels."""
    assert nc <= (_cu_constant("GLUE_GROUPS") - 1) * _cu_constant("GLUE_WIDTH")
    width = -(-nc // -(-nc // _cu_constant("GLUE_WIDTH")))
    groups = -(-nc // width)
    segments = 2 * groups + (nb > 0)
    chunks = min(-(-n_part // _cu_constant("GLUE_ROWS")),
                 max(1, _cu_constant("GLUE_BLOCKS") // segments))
    rows = -(-n_part // chunks)
    return groups, width, segments, -(-n_part // rows), rows


@pytest.mark.parametrize("n_part,nc,nb", [
    (5120, 16, 0), (5120, 12, 0), (5120, 240, 16), (1280, 372, 12), (16, 1072, 16),
    (80, 880, 16), (7, 5, 3), (1, 1, 1), (3, 4032, 16), (33, 300, 0)])
def test_glue_blocks_sum_each_partial_once(n_part, nc, nb):
    """The glue's reduction, emulated block by block and thread by thread:
    every partial (plane, row, column) is summed by exactly one lane of
    one block, every (chunk, column) of the scratch is written once and
    read once by its group's last block, each group counts the blocks it
    waits for (2 chunks' worth a channel group, 1 the bias's), and the grid
    stays near ``GLUE_BLOCKS``. Shapes: K4's (F 16, 12) and K5's (c, F)
    partials at 256x320 and at the deep levels at 2B = 16, the widest a
    reduction takes (63 groups of 64), ragged."""
    threads = _cu_constant("NTG")
    groups, width, segments, chunks, rows = _glue_layout(n_part, nc, nb)
    assert groups <= _cu_constant("GLUE_GROUPS") - 1 and (chunks - 1) * rows < n_part
    assert chunks * segments <= max(_cu_constant("GLUE_BLOCKS"), segments)
    counts = [np.zeros((n_part, nc), np.int64) for _ in range(2)] + [np.zeros((n_part, nb),
                                                                           np.int64)]
    stride = 2 * nc + nb
    written = np.zeros((chunks, stride), np.int64)
    waits = {}
    for chunk in range(chunks):
        for seg in range(segments):
            bias = seg == 2 * groups
            grp, plane = (groups, 2) if bias else (seg % groups, seg // groups)
            col0 = 0 if bias else grp * width
            w = nb if bias else min(width, nc - col0)
            r0, r1 = chunk * rows, min(chunk * rows + rows, n_part)
            for c0 in range(0, w, threads):
                wc = min(w - c0, threads)
                for lane in range(threads // wc):
                    counts[plane][r0 + lane:r1:threads // wc, col0 + c0:col0 + c0 + wc] += 1
                written[chunk, plane * nc + col0 + c0:plane * nc + col0 + c0 + wc] += 1
            waits[grp] = waits.get(grp, 0) + 1
    assert all((c == 1).all() for c in counts)
    assert (written == 1).all()
    assert waits == {**{g: 2 * chunks for g in range(groups)}, **({groups: chunks} if nb else {})}
