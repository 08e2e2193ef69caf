"""``FCDenseNet(remat=True)`` / ``train.py --remat`` on the CPU in f32:
each train-mode dense block's backward replays the engine's forward from
the block's exact input (``ops.act8.ReplayBlock`` without quantization).

The replay runs below the module, so the running statistics advance once
a step. K4's plain twin is deterministic, so the remat step is the engine
step bit for bit; against JAX's ``FCDenseNet57(remat=True)`` it is held
at tests/test_torch_training.py's train-step tolerances.
"""
import copy

import torch

from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet, FCDenseNet57

from test_torch_training import (CONFIG, DCL, TINY_ARCH, _check_step, _conditioned,  # noqa: F401
                                 _jax_step,
                                 _port_grads, _port_model, _to_torch, pallas_interpret,
                                 tiny)  # (fixtures)
from test_training import _synthetic_batch
from torch_port_cases import seeded_jax_state


def _step(model, batch):
    grads = _port_grads(model, batch)
    state = training.create_train_state(copy.deepcopy(model))
    state, metrics = training.train_step(state, batch, torch.tensor(DCL), CONFIG)
    return grads, metrics, state


def test_remat_step_is_the_engine_step_bit_for_bit(tiny):
    """Loss, gradients, new parameters, momentum and running statistics
    (advanced once) of a remat step equal the engine step's exactly."""
    jstate, model = tiny
    batch = _to_torch(_synthetic_batch(seed=9, batch=4, h=32, w=40))
    remat = FCDenseNet(**TINY_ARCH, remat=True)
    remat.load_state_dict(model.state_dict())
    (l_e, _, g_e), m_e, s_e = _step(model, batch)
    (l_r, _, g_r), m_r, s_r = _step(remat, batch)
    assert torch.equal(l_r, l_e)
    assert all(torch.equal(g_r[k], v) for k, v in g_e.items())
    assert all(torch.equal(m_r[k], v) for k, v in m_e.items())
    sd_e, sd_r = s_e.model.state_dict(), s_r.model.state_dict()
    assert all(torch.equal(sd_r[k], v) for k, v in sd_e.items())
    assert all(torch.equal(a, b) for a, b in zip(s_r.momentum, s_e.momentum))
    moved = [k for k, v in model.state_dict().items() if "running" in k
             and not torch.equal(sd_r[k], v)]
    assert len(moved) == sum("running" in k for k in sd_e)


def test_remat_step_matches_jax():
    """Full-width FCDenseNet-57 at 64x64 B=2 against JAX
    ``FCDenseNet57(remat=True)``'s step (nn.remat around its dense blocks)."""
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1, remat=True),
                                           (1, 64, 64, 3), seed=4))
    model = _port_model(jstate, FCDenseNet57(remat=True))
    batch = _synthetic_batch(seed=4)
    _check_step(jstate, model, batch, {}, _jax_step(jstate, batch, via_train_step=False))
