"""The port's UNet against the JAX package's, on the CPU in f32.

JAX ``UNet(depth=4, wf=4)`` weights (its own init, biases drawn from a
seed) cross over by ``from_jax_variables``; the forward matches in both
``up_mode``s at 64x64 and at 36x44, where the pooling floors and the skips
are center-cropped (the output is 32x40), at rtol 1e-4 / atol 1e-5. One
f32 ``train_step`` of the same net on tests/test_training.py's synthetic
batch matches JAX's: the loss, SFL, DCL and the gradient norm at rtol
1e-4, each parameter's momentum after the step (its clipped gradient;
optax's trace) at 1e-3 of its largest entry (the UNet has no BatchNorm
to amplify the f32 noise of the two forwards, but a bias's gradient is a
sum over every pixel that cancels: the head's, at 1.7e-4, differs by
1.1e-4 of itself), and the parameters after the step at rtol 1e-4. The head is conditioned
(x0.1, bias +3) as tests/test_torch_training.py explains. The JAX warp
sampler runs on its Pallas kernel in interpret mode. Then the trainer,
``--architecture unet``, for one epoch at 64x64 b2 on the CPU.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu import training as jtraining
from endoscopydepthestimation_pytorch_tpu.models import UNet as JaxUNet
from endoscopydepthestimation_pytorch_tpu.ops import gridsample as jgridsample
from endoscopydepthestimation_pytorch_tpu.ops import warp_pallas
from endoscopydepthestimation_pytorch_tpu_torch import train, training
from endoscopydepthestimation_pytorch_tpu_torch.models import UNet, from_jax_variables
from endoscopydepthestimation_pytorch_tpu_torch.ops import warp_sample
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt

from test_torch_train_cli import _argv
from test_training import _synthetic_batch
from torch_sfm_sequence import write_sequence

SMALL = dict(depth=4, wf=4)
CONFIG = training.TrainConfig()
JCONFIG = jtraining.TrainConfig()
DCL = 0.1


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    saved = warp_pallas.INTERPRET
    warp_pallas.INTERPRET = True
    with jgridsample.backend_scope("pallas"):
        yield
    warp_pallas.INTERPRET = saved


def _jax_params(up_mode, shape, seed=0, conditioned=False):
    """JAX UNet parameters (numpy): its init, then seeded biases; with
    ``conditioned`` the head scaled by 0.1 and 3 added to its bias."""
    model = JaxUNet(up_mode=up_mode, **SMALL)
    params = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))["params"])
    rng = np.random.RandomState(seed)
    for path, node in jax.tree_util.tree_flatten_with_path(params)[0]:
        if path[-1].key == "bias":
            node[...] = rng.randn(*node.shape).astype(np.float32) * 0.1
    if conditioned:
        params["last"]["kernel"] *= 0.1
        params["last"]["bias"] = params["last"]["bias"] * 0.1 + 3.0
    return model, params


def _port_unet(params, up_mode):
    model = UNet(up_mode=up_mode, **SMALL)
    model.load_state_dict(from_jax_variables(params, {}, up_mode=up_mode), strict=True)
    return model


@pytest.mark.parametrize("up_mode", ["upsample", "upconv"])
@pytest.mark.parametrize("size", [(64, 64), (36, 44)])
def test_forward_matches_jax(up_mode, size):
    x = np.random.RandomState(1).uniform(-1, 1, (2, *size, 3)).astype(np.float32)
    jmodel, params = _jax_params(up_mode, x.shape)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_unet(params, up_mode)(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    expect = size if size == (64, 64) else (32, 40)  # floored pooling, cropped skips
    assert got.shape == want.shape == (2, *expect, 1)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_unknown_up_mode_raises():
    with pytest.raises(ValueError, match="up_mode"):
        UNet(up_mode="bilinear")
    _, params = _jax_params("upsample", (1, 16, 16, 3))
    with pytest.raises(ValueError, match="up_mode"):
        from_jax_variables(params, {}, up_mode="bilinear")


def test_state_dict_names_follow_jax():
    _, params = _jax_params("upconv", (1, 16, 16, 3))
    model = UNet(up_mode="upconv", **SMALL)
    names = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    assert {"down0.conv0", "down3.conv1", "up2_conv", "up0_block.conv1", "last"} <= names
    assert not list(model.buffers())  # no BatchNorm, no running statistics
    assert sorted(from_jax_variables(params, {}, up_mode="upconv")) == sorted(
        model.state_dict())


@pytest.mark.parametrize("up_mode", ["upsample", "upconv"])
def test_train_step_matches_jax(up_mode):
    batch = _synthetic_batch(seed=4)
    jmodel, params = _jax_params(up_mode, (1, 64, 64, 3), seed=2, conditioned=True)
    jstate = jtraining.create_train_state(jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3),
                                          JCONFIG)
    assert jstate.batch_stats == {}
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    jnew, jm = jax.jit(partial(jtraining.train_step, config=JCONFIG))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(DCL))

    state = training.create_train_state(_port_unet(params, up_mode))
    state, m = training.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.tensor(DCL),
        CONFIG)
    assert int(state.step) == int(state.count) == 1
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm"):
        assert np.isfinite(float(m[key]))
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)

    want = from_jax_variables(jax.tree.map(np.asarray, jnew.params), {}, up_mode=up_mode)
    got = state.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # apply_if_finite(chain(clip_by_global_norm, sgd(momentum))): sgd's trace
    trace = jnew.opt_state.inner_state[1][0].trace
    want = from_jax_variables(jax.tree.map(np.asarray, trace), {}, up_mode=up_mode)
    names = [n for n, _ in state.model.named_parameters()]
    assert len(names) == len(state.momentum) == len(want)
    for name, b in zip(names, state.momentum):
        w = want[name].numpy()
        assert np.abs(b.numpy() - w).max() <= 1e-3 * np.abs(w).max(), name


def test_eval_step_runs_a_model_without_statistics():
    """``eval_step`` in both BN modes on a model with no buffers: the batch
    statistics mode has nothing to copy, and gives the running mode's
    result."""
    batch = {k: torch.from_numpy(v) for k, v in _synthetic_batch(seed=5).items()}
    _, params = _jax_params("upsample", (1, 64, 64, 3), seed=3, conditioned=True)
    state = training.create_train_state(_port_unet(params, "upsample"))
    a, b = (training.eval_step(state, batch, torch.tensor(DCL), CONFIG, with_images=True,
                               use_batch_stats=s) for s in (False, True))
    for key in ("loss", "scaled_depth_1", "warped_depth_1_to_2"):
        assert torch.equal(a[key], b[key]), key
    assert np.isfinite(float(a["loss"]))


def test_trainer_trains_unet(tmp_path):
    """``--architecture unet`` (the default UNet, depth 6, wf 6) for one
    epoch on the CPU: two steps with finite losses, no kernel launched
    (CPU tensors run the kernels' plain versions), and a checkpoint that
    loads back into a fresh UNet."""
    write_sequence(tmp_path / "data", seed=9)
    argv = _argv(tmp_path / "data", tmp_path / "out", "--architecture", "unet")
    argv[argv.index("--number_epoch") + 1] = "0"
    launches = dict(warp_sample.LAUNCHES)
    run = train.main(argv)
    assert warp_sample.LAUNCHES == launches
    assert isinstance(run.state.model, UNet) and run.state.model.depth == 6
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    (path,) = run.checkpoints
    assert path.name.startswith("checkpoint_model_epoch_0_validation_")
    state, epoch, _ = ckpt.load_checkpoint(path, training.create_train_state(UNet()))
    assert epoch == 1 and int(state.step) == int(state.count) == 2
    for k, v in run.state.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    for got, want in zip(state.momentum, run.state.momentum):
        assert torch.equal(got, want)
