"""The port's bilinear warp sampler against the JAX package's Pallas sampler
(``warp_pallas.grid_sample_pallas`` in interpret mode), on the CPU.

On CPU tensors the port's ``SampleBilinear`` (full and grad-first) runs
the plain forward and the plain PyTorch rendering of the CUDA
backward's formula, so these tests hold that formula against JAX. Same
seeded numpy inputs to both, f32; every comparison at rtol/atol 1e-5 (the
same f32 arithmetic summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu.ops import warp_pallas
from endoscopydepthestimation_pytorch_tpu_torch.ops import gridsample, warp_sample

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(warp_pallas, "INTERPRET", True)


def _case(seed, b, h, w, c, hq, wq):
    """Coordinates in the reference's grid convention, spanning
    [-3, size+3] (beyond the clamp band on both sides); the first query
    row sits on integer sampler coordinates (x - 0.5 integer)."""
    rng = np.random.RandomState(seed)
    image = rng.randn(b, h, w, c).astype(np.float32)
    x = rng.uniform(-3, w + 3, (b, hq, wq)).astype(np.float32)
    y = rng.uniform(-3, h + 3, (b, hq, wq)).astype(np.float32)
    x[:, 0] = (np.arange(wq) % (w + 4) - 2 + 0.5).astype(np.float32)
    y[:, 0] = np.float32(h // 2 + 0.5)
    cot = rng.randn(b, hq, wq, c).astype(np.float32)
    return image, x, y, cot


def _jax(image, x, y, cot, grad_first):
    def loss(im, xx, yy):
        out = warp_pallas.grid_sample_pallas(im, xx, yy,
                                             grad_first_only=grad_first)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (image, x, y)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(image, x, y, cot, grad_first):
    leaves = [torch.tensor(a, requires_grad=True) for a in (image, x, y)]
    before = dict(warp_sample.LAUNCHES)
    out = gridsample.grid_sample(*leaves, grad_first_only=grad_first)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    assert warp_sample.LAUNCHES == before  # CPU tensors: no kernel
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("grad_first", [False, True])
@pytest.mark.parametrize("b,h,w,c,hq,wq", [
    (2, 16, 24, 2, 13, 24),   # 13 query rows: not a multiple of 8
    (1, 12, 16, 2, 12, 16),
    (3, 9, 11, 1, 7, 5),      # one channel, queries smaller than the image
])
def test_matches_pallas_forward_and_gradients(b, h, w, c, hq, wq, grad_first):
    case = _case(b * 100 + h, b, h, w, c, hq, wq)
    want, want_grads = _jax(*case, grad_first)
    got, got_grads = _port(*case, grad_first)
    np.testing.assert_allclose(got, want, **TOL)
    for name, a, r in zip(("dimg", "dx", "dy"), got_grads, want_grads):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


def test_grad_first_zeroes_the_other_channels():
    image, x, y, cot = _case(3, 1, 10, 12, 2, 10, 12)
    _, (dimg, _, _) = _port(image, x, y, cot, grad_first=True)
    assert np.abs(dimg[..., 0]).max() > 0
    assert (dimg[..., 1] == 0).all()


def test_nan_coordinate_gives_nan_like_pallas():
    """A NaN coordinate yields a NaN sample, so a diverging prediction
    makes the loss non-finite. The clamp passes no gradient to the NaN
    coordinate itself, and the other coordinate's derivative at that
    query is NaN, in both. dimg is non-finite in both: Pallas spreads the
    NaN over the image through its tent matrices, the port only into the
    query's four taps."""
    image, x, y, cot = _case(4, 2, 9, 14, 2, 9, 14)
    x[0, 3, 4] = np.nan
    y[1, 5, 6] = np.nan
    want, want_grads = _jax(image, x, y, cot, False)
    got, got_grads = _port(image, x, y, cot, False)
    assert np.isnan(got[0, 3, 4]).all() and np.isnan(got[1, 5, 6]).all()
    assert np.isnan(got).any(-1).sum() == 2
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    assert np.isnan(got_grads[1][1, 5, 6]) and np.isnan(got_grads[2][0, 3, 4])
    for g, r in zip(got_grads[1:], want_grads[1:]):
        np.testing.assert_allclose(g, r, equal_nan=True, **TOL)
    assert np.isnan(got_grads[0]).any() and np.isnan(want_grads[0]).any()


def test_plain_backward_formula_matches_autograd_of_plain_forward():
    """The CPU rendering of the kernel's backward against autograd through
    the four-gather forward, on sampler coordinates clamped to the band."""
    image, x, y, cot = _case(5, 2, 11, 13, 2, 11, 13)
    px = torch.from_numpy(x - 0.5).clamp(-2, 14)
    py = torch.from_numpy(y - 0.5).clamp(-2, 12)
    leaves = [t.clone().requires_grad_() for t in (torch.from_numpy(image), px, py)]
    ref = torch.autograd.grad(warp_sample.sample_bilinear_reference(*leaves),
                              leaves, torch.from_numpy(cot))
    got = warp_sample._backward_plain(torch.from_numpy(image), px, py,
                                      torch.from_numpy(cot), 2)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **TOL)


def test_zeros_padding_far_outside():
    image = torch.ones(1, 8, 8, 1)
    far = torch.full((1, 8, 8), 50.0)
    assert (gridsample.grid_sample(image, far, far) == 0).all()


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "three_channels",
                                  "batch_mismatch"])
def test_refuses_what_the_kernel_does_not_take(case):
    image, px, py = torch.zeros(2, 4, 5, 2), torch.zeros(2, 4, 5), torch.zeros(2, 4, 5)
    if case == "float64":
        image = image.double()
    elif case == "non_contiguous":
        px = torch.zeros(2, 5, 4).transpose(1, 2)
    elif case == "three_channels":
        image = torch.zeros(2, 4, 5, 3)
    else:
        px, py = px[:1], py[:1]
    with pytest.raises(ValueError):
        warp_sample.sample_bilinear(image, px, py)
