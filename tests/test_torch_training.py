"""The port's train step against the JAX package's, on the CPU in f32.

Same weights (JAX variables carried over by ``from_jax_variables``), the
same seeded batch (tests/test_training.py's geometrically consistent
synthetic batch), TF32 off. The JAX sampler runs on its Pallas kernel in
interpret mode; the port's on the plain rendering of K2/K3's math. The
slow JAX compiles are shared through module-scoped fixtures.

Conditioning. At the raw seeded init some predicted depths sit near the
kink of the model's |conv| head and near the pole of the SFL's 1/z2, and
the objective amplifies the f32 order noise of the two forwards (~2e-5
of the depth) to a 25% difference in the loss (PERF.md "Objective
conditioning"). The step tests therefore scale the head by 0.1 and add 3
to its bias, so every predicted depth lies near 3, away from both; given
the same depths the two ``compute_losses`` agree to 1e-7.

Tolerances, from what is left: losses and the grad norm at rel 1e-3.
Gradients per tensor at |d| <= 3e-2 |ref| + 1e-6 max|grad| sqrt(n) (2-norms):
the train-mode BN's var = mean(x^2) - mu^2 cancels, and the deep, small
maps amplify f32 noise through it; a 1e-7 relative perturbation of the
JAX weights alone moves the same gradients by up to 1.7e-2 at seed 4
(measured), and the conv biases ahead of a BN have a true gradient of 0,
so theirs is noise of ~1e-10 held by the absolute term. New parameters at
1e-5 of their size (they move by lr * grad ~ 1e-4 of it), the new BN
statistics at rtol 1e-4 (f32 means over the batch).
"""
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from endoscopydepthestimation_pytorch_tpu import training as jtraining
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.models.fcdensenet import FCDenseNet as JaxFCDenseNet
from endoscopydepthestimation_pytorch_tpu.ops import block_engine as jax_block_engine
from endoscopydepthestimation_pytorch_tpu.ops import dense_conv as jax_dense_conv
from endoscopydepthestimation_pytorch_tpu.ops import gridsample as jgridsample
from endoscopydepthestimation_pytorch_tpu.ops import warp_pallas
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import (
    FCDenseNet, FCDenseNet57, from_jax_variables)
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                          warp_sample)

from test_training import _synthetic_batch
from torch_port_cases import jax_numpy_variables, seeded_jax_state

TINY = dict(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2)
TINY_ARCH = dict(growth_rate=12, out_chans_first_conv=24, **TINY)
CONFIG = training.TrainConfig()
JCONFIG = jtraining.TrainConfig()
DCL = 0.1


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    """Pallas in interpret mode, and the JAX sampler on the Pallas backend
    (the backend is picked when a function is traced)."""
    saved = (warp_pallas.INTERPRET, jax_dense_conv.INTERPRET,
             jax_block_engine.INTERPRET)
    warp_pallas.INTERPRET = jax_dense_conv.INTERPRET = True
    jax_block_engine.INTERPRET = True
    with jgridsample.backend_scope("pallas"):
        yield
    (warp_pallas.INTERPRET, jax_dense_conv.INTERPRET,
     jax_block_engine.INTERPRET) = saved


def _jax_loss(apply_fn, params, batch_stats, batch, dcl_weight):
    """The loss_fn of JAX ``train_step`` (training.py:246-251)."""
    d1, d2, new_stats = jtraining._forward_pair(apply_fn, params, batch_stats,
                                                batch, train=True)
    loss, aux = jtraining.compute_losses(d1, d2, batch, JCONFIG.sfl_weight,
                                         dcl_weight, JCONFIG.zero_division_epsilon)
    return loss, (new_stats, aux)


def _jax_grads(state, batch):
    """JAX loss, aux, new statistics and gradients, by the value_and_grad
    that train_step runs."""
    fn = jax.jit(jax.value_and_grad(partial(_jax_loss, state.apply_fn),
                                    has_aux=True))
    (loss, (new_stats, aux)), grads = fn(state.params, state.batch_stats,
                                         batch, jnp.float32(DCL))
    return loss, new_stats, aux, grads


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _conditioned(state):
    """``state`` with the head scaled by 0.1 and 3 added to its bias, so
    depth = |3 + 0.1 * conv| (see the module docstring)."""
    params = jax.tree.map(lambda x: x, state.params)
    head = params["finalConv"]
    params["finalConv"] = {"kernel": head["kernel"] * 0.1,
                           "bias": head["bias"] * 0.1 + 3.0}
    return state.replace(params=params)


def _port_model(state, model, **arch):
    model.load_state_dict(from_jax_variables(*jax_numpy_variables(state), **arch))
    return model


def _port_grads(model, batch):
    """Port loss, aux and named gradients of one train-mode forward, on a
    copy (so the model's running statistics are not advanced)."""
    model = copy.deepcopy(model).train()
    d1, d2 = training._forward_pair(model, batch)
    loss, aux = training.compute_losses(d1, d2, batch, CONFIG.sfl_weight,
                                        torch.tensor(DCL),
                                        CONFIG.zero_division_epsilon)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, aux, dict(zip(names, grads))


def _named_jax(params, stats, **arch):
    """A JAX {params, batch_stats} pair as the port's state_dict names."""
    return from_jax_variables(jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, stats), **arch)


def _assert_tensors_close(got: dict, want: dict, rel: float, what: str):
    """max|got - want| <= rel * max|want|, tensor by tensor."""
    worst = {}
    for k, r in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        r = r.numpy()
        worst[k] = np.abs(got[k].detach().numpy() - r).max() / max(np.abs(r).max(), 1e-30)
    bad = {k: v for k, v in worst.items() if not v <= rel}
    assert not bad, (what, max(worst.values()), bad)


def _jax_step(jstate, batch, via_train_step=True):
    """The JAX side of one step: loss, new statistics, aux and gradients by
    the value_and_grad that train_step runs, and the new state and metrics
    by the jitted train_step; with ``via_train_step=False`` the new state
    and metrics come from ``apply_gradients`` on those gradients, which is
    train_step's own body at grad_accum=1, so the model compiles once."""
    jbatch = _to_jax(batch)
    loss, new_stats, aux, grads = _jax_grads(jstate, jbatch)
    if via_train_step:
        jnew, jmetrics = jax.jit(partial(jtraining.train_step, config=JCONFIG))(
            jax.tree.map(jnp.array, jstate), jbatch, jnp.float32(DCL))
        # the value_and_grad and the jitted train_step agree on the JAX side
        np.testing.assert_allclose(float(jmetrics["loss"]), float(loss), rtol=1e-5)
    else:
        jnew, jmetrics = jax.jit(jtraining.apply_gradients)(
            jax.tree.map(jnp.array, jstate), loss, grads, new_stats, aux)
    return loss, new_stats, aux, grads, jnew, jmetrics


def _check_step(jstate, model, batch, arch, jax_side=None):
    """One step of each side from the same start; compare everything.
    ``jax_side``: ``_jax_step``'s result, when already computed."""
    tbatch = _to_torch(batch)
    loss, new_stats, aux, grads, jnew, jmetrics = jax_side or _jax_step(jstate, batch)

    p_loss, p_aux, p_grads = _port_grads(model, tbatch)
    state = training.create_train_state(model)
    state, metrics = training.train_step(state, tbatch, torch.tensor(DCL), CONFIG)

    for key, want in (("loss", jmetrics["loss"]),
                      ("sparse_flow_loss", jmetrics["sparse_flow_loss"]),
                      ("depth_consistency_loss", jmetrics["depth_consistency_loss"]),
                      ("scale_std", jmetrics["scale_std"]),
                      ("grad_norm", jmetrics["grad_norm"])):
        np.testing.assert_allclose(float(metrics[key]), float(want), rtol=1e-3,
                                   err_msg=key)
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=1e-3)

    want_grads = {k: v.numpy() for k, v in
                  _named_jax(grads, new_stats, **arch).items() if k in p_grads}
    assert len(want_grads) == len(p_grads)
    biggest = max(np.abs(v).max() for v in want_grads.values())
    bad = {}
    for k, r in want_grads.items():
        err = np.linalg.norm(p_grads[k].numpy() - r)
        if not err <= 3e-2 * np.linalg.norm(r) + 1e-6 * biggest * np.sqrt(r.size):
            bad[k] = err / np.linalg.norm(r)
    assert not bad, bad
    want_new = _named_jax(jnew.params, jnew.batch_stats, **arch)
    got_new = state.model.state_dict()
    params = {k: v for k, v in want_new.items() if "running" not in k}
    stats = {k: v for k, v in want_new.items() if "running" in k}
    _assert_tensors_close(got_new, params, 1e-5, "param")
    for k, v in stats.items():
        np.testing.assert_allclose(got_new[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(state.step) == int(jnew.step) == 1
    assert int(state.count) == 1


def test_seed4_tiny_fused_step_matches_jax(monkeypatch):
    """TINY ``fused=True`` net at B=4, 64x80: the stacked 2B=8 batch and
    W=80 pass ``_fusable``, so JAX's level-0 dense layers run Pallas K1
    with ``_fused_bwd``, and its sampler Pallas K2/K3."""
    calls = []
    original = jax_dense_conv.fused_dense_conv

    def counting(*args):
        calls.append(args[0].shape)
        return original(*args)

    monkeypatch.setattr(jax_dense_conv, "fused_dense_conv", counting)
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet(fused=True, **TINY_ARCH),
                                           (8, 64, 80, 3), seed=4))
    model = _port_model(jstate, FCDenseNet(**TINY_ARCH), **TINY)
    calls.clear()
    _check_step(jstate, model, _synthetic_batch(seed=4, batch=4, h=64, w=80), TINY)
    assert calls and all(s[0] == 8 and s[2] == 80 for s in calls)


def test_seed4_tiny_engine_step_matches_jax(monkeypatch):
    """TINY net at B=4, 32x32 against JAX's ``block_engine=True``: the port
    runs every dense block through the engine (its twins on the CPU); on
    the JAX side the 16x16 down block (stacked 2B = 8 passes the TPU gate)
    runs the Pallas engine, the others the materialized path, which is the
    same math."""
    calls = []
    original = jax_block_engine.block_engine_apply

    def counting(dims, x, *args):
        calls.append(x.shape)
        return original(dims, x, *args)

    monkeypatch.setattr(jax_block_engine, "block_engine_apply", counting)
    jstate = _conditioned(seeded_jax_state(
        JaxFCDenseNet(block_engine=True, block_engine_levels=("denseBlocksDown1",),
                      **TINY_ARCH), (8, 32, 32, 3), seed=4))
    model = _port_model(jstate, FCDenseNet(**TINY_ARCH), **TINY)
    calls.clear()
    batch = _synthetic_batch(seed=4, batch=4, h=32, w=32)
    before = dict(block_engine.LAUNCHES)
    _check_step(jstate, model, batch, TINY, _jax_step(jstate, batch, False))
    assert calls == [(8, 16, 16, 48)]
    assert block_engine.LAUNCHES == before  # CPU tensors: the twins


def test_seed4_full_width_step_matches_jax():
    """Full-width FCDenseNet-57 at 64x64, B=2 (tests/test_training.py's
    size): the port's dense blocks through the engine against JAX's
    default materialized path, which is the same math."""
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1),
                                           (1, 64, 64, 3), seed=4))
    model = _port_model(jstate, FCDenseNet57())
    _check_step(jstate, model, _synthetic_batch(seed=4), {})


@pytest.fixture(scope="module")
def tiny():
    """A TINY net (XLA dense layers on the JAX side) and its port twin."""
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet(**TINY_ARCH),
                                           (4, 32, 40, 3), seed=6))
    return jstate, _port_model(jstate, FCDenseNet(**TINY_ARCH), **TINY)


def test_grad_accum_2_matches_jax(tiny):
    """Row-strided microbatches, one update on the mean gradient, the
    running statistics advanced twice; with_images in row order."""
    jstate, model = tiny
    batch = _synthetic_batch(seed=7, batch=4, h=32, w=40)
    step = jax.jit(partial(jtraining.train_step, config=JCONFIG, grad_accum=2,
                           with_images=True))
    jnew, jm = step(jax.tree.map(jnp.array, jstate), _to_jax(batch), jnp.float32(DCL))
    state = training.create_train_state(copy.deepcopy(model))
    state, m = training.train_step(state, _to_torch(batch), torch.tensor(DCL),
                                   CONFIG, with_images=True, grad_accum=2)
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    for key in training._IMAGE_KEYS:
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    want = _named_jax(jnew.params, jnew.batch_stats, **TINY)
    got = state.model.state_dict()
    _assert_tensors_close(got, {k: v for k, v in want.items() if "running" not in k},
                          1e-5, "param")
    for k in (k for k in want if "running" in k):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_eval_step_matches_jax(tiny, use_batch_stats):
    jstate, model = tiny
    batch = _synthetic_batch(seed=8, batch=2, h=32, w=40)
    ev = jax.jit(partial(jtraining.eval_step, config=JCONFIG, with_images=True,
                         use_batch_stats=use_batch_stats))
    jm = ev(jstate, _to_jax(batch), jnp.float32(5.0))
    state = training.create_train_state(model)
    before = copy.deepcopy(model.state_dict())
    m = training.eval_step(state, _to_torch(batch), torch.tensor(5.0), CONFIG,
                           with_images=True, use_batch_stats=use_batch_stats)
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(m["warped_depth_2_to_1"].numpy(),
                               np.asarray(jm["warped_depth_2_to_1"]),
                               rtol=1e-4, atol=1e-5)
    for k, v in model.state_dict().items():  # never written back
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("training_mode", [False, True])
@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_eval_step_leaves_the_mode_as_it_found_it(tiny, use_batch_stats,
                                                  training_mode):
    """eval_step sets the BatchNorm mode it needs and restores the model's
    own afterwards; on an eval-mode model a predict_step then runs."""
    _, model = tiny
    model = copy.deepcopy(model).train(training_mode)
    batch = _to_torch(_synthetic_batch(seed=8, batch=2, h=32, w=40))
    training.eval_step(training.create_train_state(model), batch,
                       torch.tensor(DCL), CONFIG, use_batch_stats=use_batch_stats)
    assert model.training == training_mode
    assert all(m.training == training_mode for m in model.modules())
    if not training_mode:
        depth = training.predict_step(model, batch["color_1"], batch["boundary"])
        assert depth.shape == (2, 32, 40, 1) and torch.isfinite(depth).all()


def test_non_finite_loss_guard(tiny):
    """Empty depth masks: 0/0 in scale recovery, a NaN loss. Params,
    momentum, count and step stay put; the BN running statistics advance."""
    _, model = tiny
    batch = _synthetic_batch(seed=9, batch=2, h=32, w=40)
    batch["depth_mask_1"] = np.zeros_like(batch["depth_mask_1"])
    batch["sparse_depth_1"] = np.zeros_like(batch["sparse_depth_1"])
    state = training.create_train_state(copy.deepcopy(model))
    for b in state.momentum:
        b.fill_(0.5)
    before = copy.deepcopy(state.model.state_dict())
    state, m = training.train_step(state, _to_torch(batch), torch.tensor(DCL), CONFIG)
    assert not torch.isfinite(m["loss"]) and float(m["finite"]) == 0.0
    assert int(state.step) == 0 and int(state.count) == 0
    assert all((b == 0.5).all() for b in state.momentum)
    after = state.model.state_dict()
    for k, v in before.items():
        if "running" in k:
            assert not torch.equal(after[k], v), k
        else:
            assert torch.equal(after[k], v), k


def test_steps_refuse_a_model_of_another_compute_dtype(tiny):
    """The model computes in the dtype it was built with; a config that
    asks for another is refused, before anything moves."""
    _, model = tiny
    batch = _to_torch(_synthetic_batch(seed=9, batch=2, h=32, w=40))
    state = training.create_train_state(copy.deepcopy(model))
    before = copy.deepcopy(state.model.state_dict())
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="computes in torch.float32"):
        training.train_step(state, batch, torch.tensor(DCL), config)
    with pytest.raises(ValueError, match="computes in torch.float32"):
        training.eval_step(state, batch, torch.tensor(DCL), config)
    assert int(state.step) == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- the optimizer, rule by rule, against optax (JAX apply_gradients) -------


class _Params(nn.Module):
    """Two parameters, in the order of a JAX {"a", "b"} tree's leaves."""

    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


def _optimizer_pair(config, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(3, 4).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    tx = jtraining.make_optimizer(config)
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    jstate = jtraining.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats={}, opt_state=tx.init(params),
                                  apply_fn=None, tx=tx)
    return jstate, training.create_train_state(_Params(a, b))


_SCALARS = {k: 0.0 for k in ("sparse_flow_loss", "depth_consistency_loss",
                             "scale_std_1", "scale_std_2")}


def _apply_both(jstate, state, grads, loss, tconfig):
    jstate, jm = jtraining.apply_gradients(
        jstate, jnp.float32(loss), {"a": jnp.asarray(grads[0]),
                                    "b": jnp.asarray(grads[1])}, {}, _SCALARS)
    m = training.apply_gradients(state, torch.tensor(loss, dtype=torch.float32),
                                 [torch.from_numpy(g) for g in grads],
                                 {k: torch.tensor(v) for k, v in _SCALARS.items()},
                                 tconfig)
    return jstate, jm, m


def _assert_same_state(jstate, state):
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    trace = jstate.opt_state.inner_state[1][0].trace
    for b, name in zip(state.momentum, ("a", "b")):
        np.testing.assert_allclose(b.numpy(), np.asarray(trace[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert int(state.step) == int(jstate.step)
    assert int(state.count) == int(jstate.opt_state.inner_state[1][1].count)


def _grads(scale, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, 4) * scale).astype(np.float32),
            (rng.randn(5) * scale).astype(np.float32)]


@pytest.mark.parametrize("scale", [0.5, 30.0])
def test_optimizer_clips_as_optax(scale):
    """Scale by 10/|g| only when |g| >= 10 (no 1e-6 as clip_grad_norm_)."""
    jstate, state = _optimizer_pair(JCONFIG)
    grads = _grads(scale)
    jstate, jm, m = _apply_both(jstate, state, grads, 1.0, CONFIG)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert (float(m["grad_norm"]) >= 10.0) == (scale > 1.0)
    _assert_same_state(jstate, state)


def test_optimizer_momentum_as_optax():
    """b = 0.9*b + g, then p -= lr*b, over three steps."""
    jstate, state = _optimizer_pair(JCONFIG)
    for k in range(3):
        jstate, _, _ = _apply_both(jstate, state, _grads(0.3, seed=k), 1.0, CONFIG)
        _assert_same_state(jstate, state)


def test_optimizer_lr_counts_finite_steps_only():
    """The rate is the schedule at the count of steps whose gradients were
    all finite, from lr(0) = min_lr; a NaN step does not move the count."""
    tconfig = training.TrainConfig(lr_step_size=2)
    jstate, state = _optimizer_pair(jtraining.TrainConfig(lr_step_size=2))
    nan_grads = _grads(0.3)
    nan_grads[1][2] = np.nan
    sequence = [(_grads(0.3, 5), 1.0), (nan_grads, 1.0), (_grads(0.3, 6), 1.0),
                (_grads(0.3, 7), float("nan")), (_grads(0.3, 8), 1.0)]
    for grads, loss in sequence:
        jstate, _, _ = _apply_both(jstate, state, grads, loss, tconfig)
        _assert_same_state(jstate, state)
    assert int(state.count) == 3 and int(state.step) == 4


def test_optimizer_non_finite_loss_poisons_grads():
    """A non-finite loss: grads become NaN (grad_norm NaN), and params,
    momentum, count and step stay put."""
    jstate, state = _optimizer_pair(JCONFIG)
    jstate, _, _ = _apply_both(jstate, state, _grads(0.3), 1.0, CONFIG)
    jstate, jm, m = _apply_both(jstate, state, _grads(0.3, 2), float("inf"), CONFIG)
    assert np.isnan(float(m["grad_norm"])) and np.isnan(float(jm["grad_norm"]))
    assert float(m["finite"]) == 0.0
    _assert_same_state(jstate, state)
    assert int(state.step) == 1 and int(state.count) == 1


def test_optimizer_finite_loss_non_finite_grad_still_counts_the_step():
    """The JAX step's quirk: a finite loss with a non-finite gradient
    leaves params, momentum and count, but ``step`` advances."""
    jstate, state = _optimizer_pair(JCONFIG)
    grads = _grads(0.3)
    grads[0][1, 1] = np.inf
    jstate, _, m = _apply_both(jstate, state, grads, 1.0, CONFIG)
    _assert_same_state(jstate, state)
    assert int(state.step) == 1 and int(state.count) == 0
    assert float(m["finite"]) == 1.0


def test_dcl_weight_for_epoch():
    assert training.dcl_weight_for_epoch(20, CONFIG) == 0.1
    assert training.dcl_weight_for_epoch(21, CONFIG) == 5.0


def test_cpu_step_launches_no_kernel(tiny):
    _, model = tiny
    k1, k23 = dense_conv.LAUNCHES, dict(warp_sample.LAUNCHES)
    k456 = dict(block_engine.LAUNCHES)
    state = training.create_train_state(copy.deepcopy(model))
    training.train_step(state, _to_torch(_synthetic_batch(batch=2, h=32, w=40)),
                        torch.tensor(DCL), CONFIG)
    assert dense_conv.LAUNCHES == k1 and warp_sample.LAUNCHES == k23
    assert block_engine.LAUNCHES == k456
