"""The port's FCDenseNet eval forward and weight import against the JAX
package, on the CPU in f32 (TF32 off)."""
import jax
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
from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv
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
    port57.train()
    try:
        with pytest.raises(NotImplementedError, match="train step"):
            port57(torch.zeros(1, 3, 32, 32))
    finally:
        port57.eval()


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
