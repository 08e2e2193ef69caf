"""The port's FCDenseNet eval forward and weight import against the JAX
package, on the CPU in f32 (TF32 off)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.models.fcdensenet import FCDenseNet as JaxFCDenseNet
from endoscopydepthestimation_pytorch_tpu.models.torch_import import (
    export_reference_state_dict, save_reference_checkpoint)
from endoscopydepthestimation_pytorch_tpu.ops import dense_conv as jax_dense_conv
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import (
    FCDenseNet, FCDenseNet57, load_reference_checkpoint)
from endoscopydepthestimation_pytorch_tpu_torch.models.fcdensenet import DenseBlock
from endoscopydepthestimation_pytorch_tpu_torch.ops import block_engine, dense_conv
from endoscopydepthestimation_pytorch_tpu_torch.utils import load_any_checkpoint

from torch_port_cases import (jax_numpy_variables, jax_predict,
                              port_state_dict, seeded_jax_state)

TINY = dict(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2)


@pytest.fixture(scope="module")
def jax57():
    return seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, 64, 64, 3), seed=5)


@pytest.fixture(scope="module")
def port57(jax57):
    model = FCDenseNet57()
    model.load_state_dict(port_state_dict(jax57), strict=True)
    return model.eval()


def _inputs(b, h, w, seed):
    rng = np.random.RandomState(seed)
    colors = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    round_mask = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (0.45 * min(h, w)) ** 2
    boundaries = np.repeat(round_mask[None, :, :, None], b, 0).astype(np.float32)
    return colors, boundaries


def _port_predict(model, colors, boundaries):
    return training.predict_step(model, torch.from_numpy(colors),
                                 torch.from_numpy(boundaries)).numpy()


def test_from_jax_variables_equals_export_reference_state_dict(jax57):
    params, stats = jax_numpy_variables(jax57)
    want = export_reference_state_dict(params, stats, module_prefix=False)
    got = port_state_dict(jax57)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_parameter_counts_match(jax57, port57):
    n_jax = sum(np.asarray(p).size for p in jax.tree_util.tree_leaves(jax57.params))
    assert sum(p.numel() for p in port57.parameters()) == n_jax


def test_fcdensenet57_eval_forward_matches_jax(jax57, port57):
    colors, boundaries = _inputs(2, 64, 64, seed=6)
    want = jax_predict(jax57, colors, boundaries)
    got = _port_predict(port57, colors, boundaries)
    assert got.shape == want.shape == (2, 64, 64, 1)
    # 44 dense layers of f32 sums taken in another order
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_tiny_fused_fcdensenet_matches_jax_pallas(monkeypatch):
    """JAX ``fused=True`` at batch 8, 64x80: its level-0 dense layers run
    the Pallas kernel (interpret mode), the others the XLA layer."""
    monkeypatch.setattr(jax_dense_conv, "INTERPRET", True)
    calls = []
    original = jax_dense_conv.fused_dense_conv

    def counting(*args):
        calls.append(args[0].shape)
        return original(*args)

    monkeypatch.setattr(jax_dense_conv, "fused_dense_conv", counting)
    arch = dict(growth_rate=12, out_chans_first_conv=24, **TINY)
    state = seeded_jax_state(JaxFCDenseNet(fused=True, **arch), (8, 64, 80, 3), seed=7)
    model = FCDenseNet(**arch)
    model.load_state_dict(port_state_dict(state, **TINY), strict=True)
    model.eval()
    colors, boundaries = _inputs(8, 64, 80, seed=8)
    calls.clear()  # count the predict trace only, not the init's
    want = jax_predict(state, colors, boundaries)
    assert len(calls) == 4  # down block 0 and the last up block
    got = _port_predict(model, colors, boundaries)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def test_jax_block_engine_variables_load_strict():
    """JAX's engine flag does not change the parameter tree: a JAX
    ``block_engine=True`` model's variables load ``strict=True`` into the
    port's model, which trains through the engine without a flag."""
    state = seeded_jax_state(JaxFCDenseNet57(n_classes=1, block_engine=True),
                             (1, 32, 32, 3), seed=9)
    FCDenseNet57().load_state_dict(port_state_dict(state), strict=True)


def test_train_mode_runs_the_engine_where_the_gate_takes_the_block(monkeypatch):
    """In train mode every dense block runs the engine, K4 once a layer,
    and no K1; in eval mode every dense layer runs K1, layer by layer."""
    engine_calls, layer_calls = [], []
    forward, reference = block_engine.layer_forward, dense_conv.fused_dense_conv_reference

    def engine_layer(*args):
        engine_calls.append(args[1])
        return forward(*args)

    def kernel_layer(x, *args):
        layer_calls.append(x.shape[-1])
        return reference(x, *args)

    monkeypatch.setattr(block_engine, "layer_forward", engine_layer)
    monkeypatch.setattr(dense_conv, "fused_dense_conv_reference", kernel_layer)
    model = FCDenseNet(growth_rate=12, out_chans_first_conv=24, **TINY)
    x = torch.zeros(2, 3, 32, 32)
    # down 0, down 1, the bottleneck, up 0, up 1: each layer's input channels
    channels = [24, 36, 48, 60, 72, 84, 96, 108, 72, 84]
    with torch.no_grad():
        model.eval()(x)
        assert engine_calls == []
        assert layer_calls == channels
        layer_calls.clear()
        model.train()(x)
    assert engine_calls == channels
    assert layer_calls == []


def test_growth_above_the_kernels_maximum_is_refused_at_construction():
    """K1 and the engine take a growth of at most 16: a larger one fails
    when the model is built, not at its first forward."""
    assert min(block_engine.MAX_GROWTH, dense_conv.MAX_FEATURES) == 16
    with pytest.raises(ValueError, match="growth_rate 17"):
        FCDenseNet(growth_rate=17, out_chans_first_conv=24, **TINY)
    FCDenseNet(growth_rate=16, out_chans_first_conv=24, **TINY)


def test_jax_written_pt_loads_strict(jax57, port57, tmp_path):
    path = tmp_path / "jax_export.pt"
    save_reference_checkpoint(path, {"params": jax57.params,
                                     "batch_stats": jax57.batch_stats},
                              epoch=3, step=11, validation=0.25)
    state_dict, meta = load_reference_checkpoint(path)
    assert meta == {"epoch": 3, "step": 11, "validation": 0.25}
    model, epoch, validation = load_any_checkpoint(path, FCDenseNet57())
    assert (epoch, validation) == (3, 0.25)
    for k, v in port57.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_orbax_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="save_reference_checkpoint"):
        load_any_checkpoint(tmp_path, FCDenseNet57())


def test_training_mode_forward_raises(port57):
    """Serving refuses a train-mode model: its forward would normalize
    with batch statistics and advance the running ones."""
    port57.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            training.predict_step(port57, torch.zeros(1, 32, 32, 3),
                                  torch.ones(1, 32, 32, 1))
    finally:
        port57.eval()


def test_train_mode_forward_and_statistics_match_jax(jax57, port57):
    """Train-mode FCDenseNet-57: batch-statistics BN over the whole batch,
    and the running statistics moved to 0.9*r + 0.1*stat with the biased
    variance, as the JAX package's BNFold."""
    colors, _ = _inputs(2, 64, 64, seed=12)
    want, mutated = jax.jit(partial(jax57.apply_fn, train=True,
                                    mutable=["batch_stats"]))(
        {"params": jax57.params, "batch_stats": jax57.batch_stats},
        jnp.asarray(colors))
    model = FCDenseNet57()
    model.load_state_dict(port57.state_dict())
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(colors).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=2e-4, atol=1e-4)
    new = port_state_dict(jax57.replace(batch_stats=mutated["batch_stats"]))
    for k, v in model.state_dict().items():
        if "running" in k:  # f32 means over 8k positions, in another order
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_dense_layer_input_gradient_takes_both_routes(monkeypatch):
    """In train mode x reaches the loss through the conv's input and
    through the batch statistics folded into (scale, shift); the dx of a
    one-layer block through the engine must carry both (against autograd
    of the plain formula)."""
    rng = np.random.RandomState(13)
    block = DenseBlock(10, 12, 1, upsample=True).train()
    layer = block.layers[0]
    x = torch.from_numpy(rng.randn(3, 10, 6, 7).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    cot = torch.from_numpy(rng.randn(3, 12, 6, 7).astype(np.float32))
    calls = []
    engine_apply = block_engine.block_engine_apply

    def counting(*args):
        calls.append(args[0].shape)
        return engine_apply(*args)

    monkeypatch.setattr(block_engine, "block_engine_apply", counting)
    (got,) = torch.autograd.grad(block(x), x, cot)
    assert calls == [(3, 6, 7, 10)]

    def plain(xx, stats_grad=True):
        xs = xx if stats_grad else xx.detach()
        mu = xs.mean((0, 2, 3))
        var = xs.square().mean((0, 2, 3)) - mu.square()
        scale = layer.norm.weight * torch.rsqrt(var + 1e-5)
        shift = layer.norm.bias - mu * scale
        return dense_conv.fused_dense_conv_reference(
            xx.permute(0, 2, 3, 1), scale, shift,
            layer.conv.weight.permute(2, 3, 1, 0), layer.conv.bias
        ).permute(0, 3, 1, 2)

    (want,) = torch.autograd.grad(plain(x), x, cot)
    (kernel_only,) = torch.autograd.grad(plain(x, stats_grad=False), x, cot)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got - kernel_only).abs().max() > 1e-2 * kernel_only.abs().max()


def test_activations_stay_channels_last(port57, monkeypatch):
    """Down to a 1x1 bottleneck, every dense layer gets NHWC-contiguous x
    (the op raises otherwise)."""
    seen = []
    original = dense_conv.fused_dense_conv_reference

    def spy(x, *args):
        seen.append(x.is_contiguous())
        return original(x, *args)

    monkeypatch.setattr(dense_conv, "fused_dense_conv_reference", spy)
    with torch.inference_mode():
        port57(torch.zeros(1, 3, 32, 32))
    assert len(seen) == 44 and all(seen)
