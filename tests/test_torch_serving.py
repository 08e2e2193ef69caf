"""The serving slice as a whole: the port's DepthPredictor against the JAX
package's, on the CPU in f32, from one reference-format .pt and one
synthetic sequence (64x64 crop, round boundary mask)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from endoscopydepthestimation_pytorch_tpu import serving as jax_serving
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.models.torch_import import save_reference_checkpoint
from endoscopydepthestimation_pytorch_tpu_torch import serving
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv

from torch_port_cases import seeded_jax_state

H = W = 64
TOL = dict(rtol=2e-4, atol=1e-4)  # 44 dense layers of f32 sums in another order


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    state = seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, H, W, 3), seed=9)
    path = tmp_path_factory.mktemp("serving") / "seeded.pt"
    save_reference_checkpoint(path, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    return path


@pytest.fixture(scope="module")
def predictors(checkpoint):
    sequence = chip_smoke.synthetic_sequence(H, W)
    want = jax_serving.DepthPredictor(checkpoint, sequence, batch_size=2,
                                      downsampling=1.0, dtype=jnp.float32,
                                      packed=False)
    got = serving.DepthPredictor(checkpoint, sequence, batch_size=2,
                                 downsampling=1.0, device="cpu",
                                 dtype=torch.float32)
    return want, got


def _frames(n, scale=1):
    rng = np.random.RandomState(10)
    side = (H + 2 * chip_smoke.MARGIN) * scale
    return [rng.randint(0, 256, (side, side, 3)).astype(np.uint8) for _ in range(n)]


def test_predict_batch_matches_jax(predictors):
    want, got = predictors
    colors = np.stack([got.prepare(f) for f in _frames(2)])
    np.testing.assert_allclose(got.predict_batch(colors),
                               want.predict_batch(colors), **TOL)


def test_predict_frame_matches_jax(predictors):
    want, got = predictors
    frame = _frames(1)[0]
    depth = got.predict_frame(frame)
    assert depth.shape == (H, W)
    np.testing.assert_allclose(depth, want.predict_frame(frame), **TOL)
    boundary = chip_smoke.synthetic_sequence(H, W).mask_boundary / 255.0 > 0.9
    assert depth[~boundary].max() == 0.0


def test_stream_with_ragged_tail_matches_jax(predictors):
    want, got = predictors
    frames = _frames(5)
    got_stream = list(got.stream(frames))
    want_stream = list(want.stream(frames))
    assert [i for i, _ in got_stream] == [0, 1, 2, 3, 4]
    for (_, g), (_, w) in zip(got_stream, want_stream):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("downsampling", [1.0, 2.0])
def test_prepare_matches_jax_on_raw_frames(predictors, downsampling):
    want, got = predictors
    frame = _frames(1, scale=int(downsampling))[0]
    want.downsampling = got.downsampling = downsampling
    try:
        np.testing.assert_array_equal(got.prepare(frame), want.prepare(frame))
    finally:
        want.downsampling = got.downsampling = 1.0


def test_prepare_matches_jax_on_image_files(predictors, tmp_path):
    import cv2
    want, got = predictors
    path = tmp_path / "00000001.png"
    cv2.imwrite(str(path), _frames(1)[0])
    np.testing.assert_array_equal(got.prepare(path), want.prepare(path))


def test_predictor_runs_on_the_card_unless_asked_for_the_cpu(checkpoint):
    """``device`` defaults to the CUDA card; ``device="cpu"`` is honoured.
    Without a card the default refuses to build the predictor rather than
    falling back to the CPU."""
    import inspect
    default = inspect.signature(serving.DepthPredictor).parameters["device"].default
    assert torch.device(default).type == "cuda"
    sequence = chip_smoke.synthetic_sequence(H, W)
    cpu = serving.DepthPredictor(checkpoint, sequence, downsampling=1.0, device="cpu",
                                 dtype=torch.float32)
    assert cpu.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in cpu.model.parameters())
    if torch.cuda.is_available():
        card = serving.DepthPredictor(checkpoint, sequence, downsampling=1.0)
        assert card.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            serving.DepthPredictor(checkpoint, sequence, downsampling=1.0)


def test_chip_smoke_serving_phase_on_cpu(checkpoint):
    before = dense_conv.LAUNCHES
    out = chip_smoke.serving_phase(checkpoint, "cpu", torch.float32, H, W,
                                   batch=2, n_stream=5)
    assert dense_conv.LAUNCHES == before  # CPU tensors never launch the kernel
    assert out["forwards"] == 2 + 1 + 3
    assert out["depth"].shape == (5, H, W) and np.isfinite(out["depth"]).all()
    ref = chip_smoke.cpu_reference(checkpoint, H, W, out["colors"][:2])
    assert chip_smoke.masked_rel_err(out["depth"][:2], ref, H, W) < 1e-6


def test_chip_smoke_layer_shapes_are_the_models(monkeypatch):
    seen = []
    original = dense_conv.fused_dense_conv_reference

    def spy(x, *args):
        seen.append(tuple(x.shape[1:]))
        return original(x, *args)

    monkeypatch.setattr(dense_conv, "fused_dense_conv_reference", spy)
    with torch.inference_mode():
        FCDenseNet57().eval()(torch.zeros(1, 3, 64, 96))
    assert seen == chip_smoke.dense_layer_shapes(64, 96)
    assert len(seen) == 44


def test_chip_smoke_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA exit")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
