"""The port's geometry, losses, metrics and LR schedule against the JAX
package, on the CPU in f32 with the same seeded numpy inputs.

Where the JAX function samples (``warp_depth``), its sampler runs on the
Pallas kernel in interpret mode (``gridsample.backend_scope("pallas")``),
the port's on the plain rendering of its CUDA kernels' math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu import losses as jlosses
from endoscopydepthestimation_pytorch_tpu import schedule as jschedule
from endoscopydepthestimation_pytorch_tpu.ops import geometry as jgeometry
from endoscopydepthestimation_pytorch_tpu.ops import gridsample as jgridsample
from endoscopydepthestimation_pytorch_tpu.ops import warp_pallas
from endoscopydepthestimation_pytorch_tpu_torch import losses, schedule
from endoscopydepthestimation_pytorch_tpu_torch.ops import geometry

torch.set_num_threads(2)
B, H, W = 2, 12, 16


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(warp_pallas, "INTERPRET", True)
    with jgridsample.backend_scope("pallas"):
        yield


def _scene(seed=0, b=B, h=H, w=W):
    """A pose with a small rotation and translation, pinhole intrinsics,
    positive depth maps, a boundary mask and sparse masks."""
    rng = np.random.RandomState(seed)
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = rng.uniform(15, 25, b)
    k[:, 1, 1] = rng.uniform(15, 25, b)
    k[:, 0, 2] = w / 2 + rng.uniform(-1, 1, b)
    k[:, 1, 2] = h / 2 + rng.uniform(-1, 1, b)
    k[:, 2, 2] = 1.0
    angles = rng.uniform(-0.05, 0.05, (b, 3))
    rot = np.stack([_rotation(a) for a in angles]).astype(np.float32)
    trans = rng.uniform(-0.05, 0.05, (b, 3, 1)).astype(np.float32)
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, 1:-1, 2:-2] = 1.0
    sparse = (rng.rand(b, h, w, 1) < 0.3).astype(np.float32) * mask
    return {
        "k": k, "rot": rot, "trans": trans, "mask": mask, "sparse": sparse,
        "d1": rng.uniform(0.5, 2.0, (b, h, w, 1)).astype(np.float32),
        "d2": rng.uniform(0.5, 2.0, (b, h, w, 1)).astype(np.float32),
        "flow": (rng.randn(b, h, w, 2) * 0.05).astype(np.float32),
    }


def _rotation(a):
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol=1e-5, atol=1e-5, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, **kw)


def test_intrinsics_inverse_and_reprojection_terms():
    s = _scene(1)
    _close(geometry.intrinsics_inverse(*_t(s["k"])),
           jgeometry.intrinsics_inverse(s["k"]), rtol=1e-6, atol=1e-6)
    got = geometry._reprojection_terms(*_t(s["rot"], s["trans"], s["k"]), H, W)
    want = jgeometry._reprojection_terms(s["rot"], s["trans"], s["k"], H, W)
    for a, b in zip(got, want):
        _close(a, b)


def test_warp_coordinates_and_flow_from_depth():
    """Masked pixels take the 1e30 sentinel depth (u2, v2 -> ~0)."""
    s = _scene(2)
    args = (s["d1"], s["mask"], s["trans"], s["rot"], s["k"])
    got = geometry.warp_coordinates(*_t(*args))
    want = jgeometry.warp_coordinates(*args)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5, atol=1e-4)
    assert np.abs(got[0].numpy()[s["mask"] == 0]).max() < 1e-20
    _close(geometry.flow_from_depth(*_t(*args)), jgeometry.flow_from_depth(*args),
           rtol=1e-5, atol=1e-5)


def test_warp_depth_values_and_gradients():
    """Forward, intersect mask, and the gradients of a weighted sum of the
    warped depth w.r.t. both depth maps (JAX through Pallas K2/K3)."""
    s = _scene(3)
    rng = np.random.RandomState(30)
    cot = rng.randn(B, H, W, 1).astype(np.float32)
    fixed = (s["mask"], s["trans"], s["rot"], s["k"])

    def jloss(d1, d2):
        warped, inter = jgeometry.warp_depth(d1, d2, *fixed)
        return jnp.sum(warped * cot), (warped, inter)

    (_, (jw, ji)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        s["d1"], s["d2"])
    d1, d2 = (t.requires_grad_() for t in _t(s["d1"], s["d2"]))
    warped, inter = geometry.warp_depth(d1, d2, *_t(*fixed))
    grads = torch.autograd.grad(warped, (d1, d2), torch.from_numpy(cot))
    _close(warped, jw, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(ji))
    assert 0 < inter.numpy().mean() < 1  # the mask cuts somewhere
    for a, b in zip(grads, jg):
        # 1/z2 near the image edge amplifies f32 order noise
        _close(a, b, rtol=1e-4, atol=1e-4)


def test_warp_depth_epsilon_guards():
    """Depth behind the camera (z2 <= 0) and masked pixels use epsilon."""
    s = _scene(4)
    s["d1"][:, :3] = -5.0
    args = (s["d1"], s["d2"], s["mask"], s["trans"], s["rot"], s["k"])
    got = geometry.warp_depth(*_t(*args))
    want = jgeometry.warp_depth(*args)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5, atol=1e-5)


def test_scale_recovery_and_the_cross_batch_std():
    s = _scene(5, b=3)
    sparse_depth = s["sparse"] * s["d2"]
    args = (s["d1"], sparse_depth, s["sparse"])
    got = geometry.scale_recovery_per_sample(*_t(*args))
    want = jgeometry.scale_recovery_per_sample(*args)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5, atol=1e-6)
    _close(geometry.normalized_scale_std(got[1], got[2]),
           jgeometry.normalized_scale_std(want[1], want[2]), rtol=1e-5)
    got_s, got_std = geometry.scale_recovery(*_t(*args))
    want_s, want_std = jgeometry.scale_recovery(*args)
    _close(got_s, want_s, rtol=1e-5, atol=1e-6)
    _close(got_std, want_std, rtol=1e-5)


def test_images_warping():
    rng = np.random.RandomState(6)
    images = rng.randn(B, H, W, 3).astype(np.float32)
    u = rng.uniform(-2, W + 2, (B, H, W)).astype(np.float32)
    v = rng.uniform(-2, H + 2, (B, H, W)).astype(np.float32)
    for align in (False, True):
        _close(geometry.images_warping(*_t(images, u, v), align_corners=align),
               jgeometry.images_warping(images, u, v, align_corners=align))


def _loss_inputs(seed=7):
    s = _scene(seed)
    rng = np.random.RandomState(seed + 70)
    intersect = (rng.rand(B, H, W, 1) < 0.7).astype(np.float32)
    return s, intersect


LOSSES = {
    "sparse_masked_l1_loss": lambda s, i: (s["flow"], s["flow"][::-1] * 2, s["sparse"]),
    "sparse_masked_l1_loss_per_sample": lambda s, i: (s["flow"], s["flow"][::-1], s["sparse"]),
    "normalized_distance_loss": lambda s, i: (s["d1"], s["d2"], i, s["k"]),
    "scale_invariant_loss": lambda s, i: (s["d1"], s["d2"], s["mask"]),
    "masked_scale_invariant_loss": lambda s, i: (s["d1"], s["d2"] * s["sparse"], s["sparse"]),
    "masked_l1_loss": lambda s, i: (s["d1"], s["d2"], i),
    "normalized_l2_loss": lambda s, i: (s["d1"], s["d2"], i),
    "normalized_l1_loss": lambda s, i: (s["d1"], s["d2"], i),
    "normalized_weighted_masked_l2_loss": lambda s, i: (s["d1"], s["d2"], i, s["trans"]),
    "abs_rel_error": lambda s, i: (s["d1"], s["d2"] * s["sparse"], s["sparse"]),
    "threshold_metric": lambda s, i: (s["d1"], s["d1"] * (1 + 0.3 * s["d2"]) * s["sparse"],
                                      s["sparse"]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    s, intersect = _loss_inputs()
    args = LOSSES[name](s, intersect)
    got = getattr(losses, name)(*_t(*args))
    want = getattr(jlosses, name)(*map(jnp.asarray, args))
    if name == "threshold_metric":
        assert len(got) == 3
        for a, b in zip(got, want):
            _close(a, b, rtol=1e-6, atol=0)
    else:
        _close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sparse_masked_l1_loss",
                                  "normalized_distance_loss"])
def test_training_loss_gradients_match_jax(name):
    """SFL and DCL gradients w.r.t. their two differentiable inputs; DCL's
    mean_value carries none (stop_gradient / detach)."""
    s, intersect = _loss_inputs(8)
    args = LOSSES[name](s, intersect)
    jg = jax.grad(getattr(jlosses, name), argnums=(0, 1))(*map(jnp.asarray, args))
    leaves = [t.requires_grad_() for t in _t(*args[:2])]
    got = torch.autograd.grad(getattr(losses, name)(*leaves, *_t(*args[2:])),
                              leaves)
    for a, b in zip(got, jg):
        _close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode,gamma", [("triangular", 1.0),
                                        ("triangular2", 1.0),
                                        ("exp_range", 0.9995)])
def test_cyclic_lr_matches_jax(mode, gamma):
    steps = np.arange(0, 5001, dtype=np.int32)
    got = schedule.cyclic_lr(torch.from_numpy(steps), 1e-4, 1e-3, 700, mode, gamma)
    want = jschedule.cyclic_lr(jnp.asarray(steps), 1e-4, 1e-3, 700, mode, gamma)
    _close(got, want, rtol=1e-6, atol=1e-10)
    sched = schedule.make_cyclic_schedule(1e-4, 1e-3, 700, mode, gamma)
    assert float(sched(torch.tensor(0))) == pytest.approx(1e-4, rel=1e-6)


def test_cyclic_lr_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        schedule.cyclic_lr(torch.tensor(3), 1e-4, 1e-3, 10, "cosine")
