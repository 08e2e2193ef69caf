"""The port's fp8 activation store (``ops/act8.py``) against the JAX
package's, on the CPU in f32: twins of tests/test_act8.py.

The quantizer's bytes equal JAX's (random data, ties between neighbours
in every e4m3 binade, the subnormal range, JAX's 240-max case). The act8
block's forward is the engine's, equal to JAX's ``act8_block_apply`` at
rtol 1e-5. Its ``replay`` gradients match JAX's from the same x: both
dequantize the same bytes and differentiate the same block there. In
``saved_buf`` mode the port's backward is held at JAX's own quantized
buffer (its bytes and scale passed in) against JAX's ``_block_bwd``; end
to end, where each package quantizes its own buffer, an f32 ulp may move
an element into the next e4m3 bucket, so there the gradient's cosine is
held. What the block saves for its backward is read with
``saved_tensors_hooks``. The model runs FCDenseNet-57 at 32x32 b8 from
conditioned weights (tests/test_torch_training.py's ``_conditioned``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.ops import act8 as jact8
from endoscopydepthestimation_pytorch_tpu.ops.dense_block import _block_bwd
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch.ops import act8, block_engine

from test_torch_training import (CONFIG, DCL, _conditioned, _jax_loss, _named_jax,
                                 _port_model, _to_jax, _to_torch)
from test_training import _synthetic_batch
from torch_port_cases import seeded_jax_state


def _bytes(q) -> np.ndarray:
    return np.asarray(q).view(np.uint8)


def _tie_values() -> np.ndarray:
    """With amax 240 (scale 1): ties halfway between neighbouring e4m3
    values in every binade, both signs, values in the subnormal range and
    below half the smallest subnormal, as (64, C) with 240 in row 0."""
    ties = [(1.0 + (k + 0.5) / 8.0) * 2.0 ** e for e in range(-6, 8) for k in range(8)]
    sub = [(k + 0.5) * 2.0 ** -9 for k in range(8)] + [2.0 ** -11, 3 * 2.0 ** -12]
    vals = np.array([v for v in ties + sub if v < 240.0], np.float32)
    vals = np.concatenate([vals, -vals, np.nextafter(vals, np.float32(0))])
    cols = -(-vals.size // 63)
    out = np.zeros((64, cols), np.float32)
    out[0] = 240.0
    flat = np.zeros(63 * cols, np.float32)
    flat[:vals.size] = vals
    out[1:] = flat.reshape(cols, 63).T
    return out


CASES = {
    "random": lambda: np.random.RandomState(0).randn(4, 8, 16, 12).astype(np.float32) * 3.0,
    "ties_and_subnormals": _tie_values,
    "ieee_240_max": lambda: np.array([[300.0, -448.0, 1e-4, 447.9]], np.float32),
    "tiny_scale": lambda: (np.random.RandomState(1).randn(2, 5, 7, 3) * 1e-30).astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize8_bytes_equal_jax(case):
    """The e4m3 bytes and the f32 scale equal JAX's exactly (round to
    nearest even, subnormals kept), along the last axis and along axis 1
    of the same data laid out NCHW."""
    x = CASES[case]()
    jq, js = jact8.quantize8(jnp.asarray(x))
    q, s = act8.quantize8(torch.from_numpy(x))
    assert q.dtype == torch.float8_e4m3fn and s.shape == (x.shape[-1],)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(), _bytes(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if x.ndim == 4:
        qc, sc = act8.quantize8(torch.from_numpy(x).permute(0, 3, 1, 2), dim=1)
        np.testing.assert_array_equal(qc.permute(0, 2, 3, 1).view(torch.uint8).numpy(),
                                      _bytes(jq))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    back = act8.dequantize8(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jact8.dequantize8(jq, js, jnp.float32)))


def test_quantize8_scale_respects_ieee_e4m3_240_max():
    """|x / s| <= 240 and the round trip is finite, with 300 and 447.9 in
    the data (tests/test_act8.py's case)."""
    y = torch.tensor([[300.0, -448.0, 1e-4, 447.9]])
    q, s = act8.quantize8(y)
    assert float((y / s).abs().max()) <= 240.0 + 1e-3
    assert torch.isfinite(act8.dequantize8(q, s, torch.float32)).all()
    assert torch.isfinite(q.float()).all()


def _block_args(seed=2, c0=6, growth=4, n_layers=3, shape=(4, 8, 16)):
    rng = np.random.RandomState(seed)
    b, h, w = shape
    x = rng.randn(b, h, w, c0).astype(np.float32)
    cs = [c0 + j * growth for j in range(n_layers)]
    gammas = [(1.0 + 0.1 * rng.randn(c)).astype(np.float32) for c in cs]
    betas = [(0.1 * rng.randn(c)).astype(np.float32) for c in cs]
    kernels = [(0.2 * rng.randn(3, 3, c, growth)).astype(np.float32) for c in cs]
    biases = [(0.1 * rng.randn(growth)).astype(np.float32) for _ in cs]
    return (growth, n_layers, 1e-5, None), x, gammas, betas, kernels, biases


def _jax_block(fn, dims, x, g, b, k, bi):
    return fn(dims, jnp.asarray(x), *(tuple(map(jnp.asarray, v)) for v in (g, b, k, bi)))


def _port_leaves(x, g, b, k, bi):
    return [torch.from_numpy(v).requires_grad_() for v in [x, *g, *b, *k, *bi]]


def _port_block(leaves, n_layers, store="act8"):
    x, rest = leaves[0], leaves[1:]
    groups = [rest[i * n_layers:(i + 1) * n_layers] for i in range(4)]
    if store is None:
        return block_engine.block_engine_apply(x, *groups)
    return act8.replay_block_apply(x, *groups, store=store)


def _loss(buf, mu, m2):
    return (buf.float() ** 2).mean() + mu.sum() * 0.1 + m2.sum() * 0.01


def _jax_grads(fn, dims, x, g, b, k, bi):
    def loss(args):
        buf, mu, m2 = fn(dims, *args)
        return jnp.mean(buf.astype(jnp.float32) ** 2) + jnp.sum(mu) * 0.1 + jnp.sum(m2) * 0.01
    grads = jax.grad(loss)((jnp.asarray(x),) + tuple(tuple(map(jnp.asarray, v))
                                                     for v in (g, b, k, bi)))
    return [np.asarray(grads[0])] + [np.asarray(t) for group in grads[1:] for t in group]


def _port_grads(args, store):
    dims, *arrays = args
    leaves = _port_leaves(*arrays)
    return [t.numpy() for t in
            torch.autograd.grad(_loss(*_port_block(leaves, dims[1], store)), leaves)]


def _flat(grads) -> np.ndarray:
    return np.concatenate([np.asarray(g, np.float64).ravel() for g in grads])


def _cos(a, b) -> float:
    a, b = _flat(a), _flat(b)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_block_forward_matches_jax():
    """The act8 block's (buf, mu, m2), the engine's forward, against JAX
    ``act8_block_apply`` (its materialized ``_mat_impl``)."""
    dims, *arrays = _block_args()
    want = _jax_block(jact8.act8_block_apply, dims, *arrays)
    got = _port_block(_port_leaves(*arrays), dims[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_replay_gradients_match_jax(monkeypatch):
    """``replay``: both packages quantize the same x to the same bytes and
    differentiate the block at the dequantized copy."""
    monkeypatch.setattr(act8, "BWD_MODE", "replay")
    monkeypatch.setattr(jact8, "BWD_MODE", "replay")
    args = _block_args()
    want = _jax_grads(jact8.act8_block_apply, *args)
    got = _port_grads(args, "act8")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_saved_buf_backward_at_jax_buffer_matches_jax():
    """``saved_buf``: the port's backward (``engine_backward``) at JAX's
    quantized buffer, its bytes and scale passed in, against JAX's
    ``_block_bwd`` at the same buffer and cotangents."""
    dims, x, g, b, k, bi = _block_args()
    rng = np.random.RandomState(3)
    buf, mu, m2 = _jax_block(jact8._mat_impl, dims, x, g, b, k, bi)
    jq, js = jact8.quantize8(buf)
    buft = jact8.dequantize8(jq, js, jnp.float32)
    cot = (rng.randn(*buf.shape).astype(np.float32) * 1e-2,
           rng.randn(*mu.shape).astype(np.float32) * 1e-2,
           rng.randn(*m2.shape).astype(np.float32) * 1e-2)
    jdx, *jparams = _block_bwd(dims, (buft, mu, m2) + tuple(
        tuple(map(jnp.asarray, v)) for v in (g, b, k, bi)), tuple(map(jnp.asarray, cot)))
    want = [np.asarray(jdx)] + [np.asarray(t) for group in jparams for t in group]

    q = torch.from_numpy(_bytes(jq).copy()).view(torch.float8_e4m3fn)
    got = block_engine.engine_backward(
        act8.dequantize8(q, torch.tensor(np.asarray(js)), torch.float32),
        torch.tensor(np.asarray(mu)), torch.tensor(np.asarray(m2)), dims[1],
        [torch.from_numpy(v) for v in [*g, *b, *k, *bi]],
        *(torch.from_numpy(c) for c in cot))
    assert len(got) == len(want)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-4, atol=1e-5)


def test_saved_buf_gradients_track_jax(monkeypatch):
    """``saved_buf`` end to end: each package quantizes its own buffer."""
    monkeypatch.setattr(act8, "BWD_MODE", "saved_buf")
    monkeypatch.setattr(jact8, "BWD_MODE", "saved_buf")
    args = _block_args()
    assert _cos(_port_grads(args, "act8"), _jax_grads(jact8.act8_block_apply, *args)) >= 0.9999


@pytest.mark.parametrize("mode", ["replay", "saved_buf"])
def test_block_grad_contained_deviation(mode, monkeypatch):
    """JAX's contract, in both modes: against the exact block (the engine)
    the gradient's cosine is above 0.99 and its relative error under 0.10."""
    monkeypatch.setattr(act8, "BWD_MODE", mode)
    args = _block_args()
    exact, quant = _port_grads(args, None), _port_grads(args, "act8")
    rel = np.linalg.norm(_flat(quant) - _flat(exact)) / np.linalg.norm(_flat(exact))
    assert _cos(quant, exact) > 0.99 and rel < 0.10, (_cos(quant, exact), rel)


def _saved(fn):
    """The tensors autograd saves while ``fn`` runs, and ``fn``'s result."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return saved, out


@pytest.mark.parametrize("mode", ["replay", "saved_buf"])
def test_block_residual_is_fp8(mode, monkeypatch):
    """The block saves an e4m3 copy (of x, or of the buffer), its scale,
    the parameters and, in ``saved_buf``, the two statistics vectors:
    nothing in f32 as large as x."""
    monkeypatch.setattr(act8, "BWD_MODE", mode)
    dims, *arrays = _block_args()
    leaves = _port_leaves(*arrays)
    saved, (buf, _, _) = _saved(lambda: _port_block(leaves, dims[1]))
    params = {p.data_ptr() for p in leaves[1:]}
    fp8 = [t for t in saved if t.dtype == torch.float8_e4m3fn]
    big = [tuple(t.shape) for t in saved if t.dtype != torch.float8_e4m3fn
           and t.data_ptr() not in params and t.numel() >= leaves[0].numel()]
    assert [t.shape for t in fp8] == [leaves[0].shape if mode == "replay" else buf.shape]
    assert not big, big


@pytest.fixture(scope="module")
def model_case():
    """FCDenseNet-57 (conditioned, seeded BN) at 32x32 b8, its JAX act8
    twin's loss and gradients, and the batch."""
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, 32, 32, 3),
                                           seed=8))
    batch = _synthetic_batch(seed=8, batch=8, h=32, w=32)
    apply_fn = JaxFCDenseNet57(n_classes=1, act8=True).apply
    # the value_and_grad of JAX train_step's loss_fn (its loss is the step's)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: _jax_loss(apply_fn, p, s, b, jnp.float32(DCL)),
        has_aux=True))(jstate.params, jstate.batch_stats, _to_jax(batch))
    return jstate, _to_torch(batch), float(jloss), jgrads


def _model_grads(model, batch):
    model = copy.deepcopy(model).train()
    d1, d2 = training._forward_pair(model, batch)
    loss, _ = training.compute_losses(d1, d2, batch, CONFIG.sfl_weight, torch.tensor(DCL),
                                      CONFIG.zero_division_epsilon)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return loss.detach(), (d1.detach(), d2.detach()), dict(zip(names, grads)), stats


@pytest.mark.parametrize("mode", ["replay", "saved_buf"])
def test_model_act8_forward_exact_and_grad_close(model_case, mode, monkeypatch):
    """The act8 model's forward, loss and new BN statistics equal the
    engine route's bit for bit; its gradient's cosine is above 0.97
    against the exact gradient (JAX's contract) and above 0.99 against
    JAX's act8 model's."""
    monkeypatch.setattr(act8, "BWD_MODE", mode)
    jstate, batch, _, jgrads = model_case
    exact = _port_model(jstate, FCDenseNet57())
    quant = _port_model(jstate, FCDenseNet57(act8=True))
    l_e, d_e, g_e, s_e = _model_grads(exact, batch)
    l_q, d_q, g_q, s_q = _model_grads(quant, batch)
    assert torch.equal(l_e, l_q)
    assert all(torch.equal(a, b) for a, b in zip(d_e, d_q))
    assert all(torch.equal(s_e[k], s_q[k]) for k in s_e)
    names = list(g_e)
    cos_exact = _cos([g_q[k] for k in names], [g_e[k] for k in names])
    jnamed = _named_jax(jgrads, jstate.batch_stats)
    cos_jax = _cos([g_q[k] for k in names], [jnamed[k].numpy() for k in names])
    assert cos_exact > 0.97, cos_exact
    assert cos_jax > 0.99, cos_jax


def test_model_act8_saves_fp8_activations(model_case):
    """The act8 model's train-mode forward saves every activation of more
    than 3 channels as e4m3 (block inputs, transition and head inputs);
    the exact model's does not."""
    jstate, batch, _, _ = model_case
    counts = {}
    for flag in (False, True):
        model = _port_model(jstate, FCDenseNet57(act8=flag)).train()
        saved, _ = _saved(lambda: training._forward_pair(model, batch))
        params = {p.data_ptr() for p in model.parameters()}
        image = 16 * 3 * 32 * 32  # the stacked 2B colors
        counts[flag] = (sum(t.dtype == torch.float8_e4m3fn for t in saved),
                        [tuple(t.shape) for t in saved if t.dtype != torch.float8_e4m3fn
                         and t.data_ptr() not in params and t.numel() > image])
    assert counts[True][0] == 11 + 5 + 5 + 1 and not counts[True][1], counts[True]
    assert counts[False][0] == 0 and counts[False][1]


def test_act8_with_block_engine_keeps_the_dense_blocks_exact(model_case, monkeypatch):
    """``FCDenseNet57(act8=True, block_engine=True)`` in train mode sends
    all 11 dense blocks through ``block_engine_apply`` and none through
    ``act8.ReplayBlock``, while the 5 transitions down, the 5 up and the
    head still go through ``compressed_call`` (without ``block_engine``,
    the blocks replay); its depths, loss and new BN statistics equal the
    exact model's bit for bit, and its backward runs."""
    calls = {"engine": 0, "replay": 0, "compressed": []}
    engine_apply, replay_apply = block_engine.block_engine_apply, act8.replay_block_apply
    compressed_call = act8.compressed_call

    def counting_engine(*args):
        calls["engine"] += 1
        return engine_apply(*args)

    def counting_replay(*args, **kwargs):
        calls["replay"] += 1
        return replay_apply(*args, **kwargs)

    def counting_compressed(fn, *args):
        calls["compressed"].append(fn.__name__)
        return compressed_call(fn, *args)

    monkeypatch.setattr(block_engine, "block_engine_apply", counting_engine)
    monkeypatch.setattr(act8, "replay_block_apply", counting_replay)
    monkeypatch.setattr(act8, "compressed_call", counting_compressed)
    jstate, batch, _, _ = model_case
    exact = copy.deepcopy(_port_model(jstate, FCDenseNet57())).train()
    with torch.no_grad():
        d_e = training._forward_pair(exact, batch)
        l_e, _ = training.compute_losses(*d_e, batch, CONFIG.sfl_weight, torch.tensor(DCL),
                                         CONFIG.zero_division_epsilon)
    s_e = {k: v for k, v in exact.state_dict().items() if "running" in k}
    heads = sorted(["td_apply"] * 5 + ["tu_apply"] * 5 + ["conv1x1_apply"])
    calls.update(engine=0, replay=0, compressed=[])
    l_q, d_q, g_q, s_q = _model_grads(
        _port_model(jstate, FCDenseNet57(act8=True, block_engine=True)), batch)
    assert (calls["engine"], calls["replay"]) == (11, 0)
    assert sorted(calls["compressed"]) == heads
    assert torch.equal(l_e, l_q)
    assert all(torch.equal(a, b) for a, b in zip(d_e, d_q))
    assert all(torch.equal(s_e[k], s_q[k]) for k in s_e)
    assert all(torch.isfinite(g).all() for g in g_q.values())
    calls.update(engine=0, replay=0, compressed=[])
    with torch.no_grad():
        training._forward_pair(
            _port_model(jstate, FCDenseNet57(act8=True)).train(), batch)
    assert (calls["engine"], calls["replay"]) == (0, 11)
    assert sorted(calls["compressed"]) == heads


def test_model_act8_train_step_matches_jax(model_case):
    """One train step of the act8 model: its loss against JAX's act8 train
    step's at rtol 1e-3; finite, one step taken."""
    jstate, batch, jloss, _ = model_case
    state = training.create_train_state(_port_model(jstate, FCDenseNet57(act8=True)))
    state, metrics = training.train_step(state, batch, torch.tensor(DCL), CONFIG)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3)
    assert torch.isfinite(metrics["grad_norm"]) and int(state.step) == 1
