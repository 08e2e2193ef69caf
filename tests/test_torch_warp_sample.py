"""The port's bilinear warp sampler against the JAX package's Pallas sampler
(``warp_pallas.grid_sample_pallas`` in interpret mode), on the CPU.

On CPU tensors the port's ``SampleBilinear`` (full and grad-first) runs
the plain forward and the plain PyTorch rendering of the CUDA
backward's arithmetic, so these tests hold that arithmetic against JAX.
Same seeded numpy inputs to both, f32; every comparison at rtol/atol 1e-5
(the same f32 products, summed in another order and, for dimg, in
fixed point: each rounded by at most max|g| * 2^(h-62)). Then the
fixed-point scatter's own properties: query order, headroom, non-finite
values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _sampler_coordinates(seed, b, h, w, c):
    """_case's inputs as torch tensors, the coordinates shifted to the
    sampler's convention and clamped to its band."""
    image, x, y, cot = _case(seed, b, h, w, c, h, w)
    px = torch.from_numpy(x - 0.5).clamp(-2, w + 1)
    py = torch.from_numpy(y - 0.5).clamp(-2, h + 1)
    return torch.from_numpy(image), px, py, torch.from_numpy(cot)


def _f32_scatter(image, px, py, g, cg):
    """dimg as the plain f32 scatter-add of each valid tap's product."""
    b, h, w, c = image.shape
    _, indices, valid, wx, wy = warp_sample._taps(image[..., :cg], px, py)
    g = g[..., :cg]
    gt, gb = g * (1.0 - wy), g * wy
    dimg = torch.zeros(b, h * w, cg)
    for d, idx, ok in zip((gt * (1.0 - wx), gt * wx, gb * (1.0 - wx), gb * wx),
                          indices, valid):
        d = torch.where(ok[..., None], d, 0.0).reshape(b, -1, cg)
        dimg.scatter_add_(1, idx[..., None].expand(-1, -1, cg), d)
    return F.pad(dimg, (0, c - cg)).reshape(b, h, w, c)


@pytest.mark.parametrize("grad_channels", [1, 2])
def test_plain_dimg_is_bitwise_invariant_to_query_order(grad_channels):
    """Integer sums ignore order: the queries of each image shuffled give
    the same dimg bit for bit (and dpx, dpy follow their queries)."""
    b, h, w = 2, 37, 53
    image, px, py, cot = _sampler_coordinates(6, b, h, w, 2)
    perm = torch.from_numpy(np.random.RandomState(7).permutation(h * w))

    def shuffled(t):
        return t.reshape(b, h * w, *t.shape[3:])[:, perm].reshape(t.shape)

    want = warp_sample._backward_plain(image, px, py, cot, grad_channels)
    got = warp_sample._backward_plain(image, shuffled(px), shuffled(py),
                                      shuffled(cot), grad_channels)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], shuffled(want[1]))
    assert torch.equal(got[2], shuffled(want[2]))


@pytest.mark.parametrize("hq,wq", [(16, 16), (15, 17)])
def test_collapse_onto_one_texel_does_not_overflow(hq, wq):
    """Every query on one integer coordinate with g = +m, m the largest
    float below 1: one texel sums Q_b*m, at the headroom's limit (2^62 -
    2^38 for Q_b = 256). It agrees with a float64 scatter within one f32
    rounding of the sum plus Q_b*m*2^(h-62)."""
    b, h, w = 2, 9, 11
    m = float(np.nextafter(np.float32(1), np.float32(0)))
    image = torch.from_numpy(np.random.RandomState(8).randn(b, h, w, 2).astype(np.float32))
    px, py = torch.full((b, hq, wq), 4.0), torch.full((b, hq, wq), 6.0)
    cot = torch.zeros(b, hq, wq, 2)
    cot[..., 0] = m
    got = warp_sample._backward_plain(image, px, py, cot, 1)[0].double()
    leaves = [image.double().requires_grad_(), px.double(), py.double()]
    ref = torch.autograd.grad(warp_sample.sample_bilinear_reference(*leaves),
                              leaves[0], torch.cat([cot[..., :1].double(),
                                                    torch.zeros(b, hq, wq, 1)], -1))[0]
    q = hq * wq
    assert ref[:, 6, 4, 0].eq(q * m).all() and ref.count_nonzero() == b
    tol = ref.abs() * 2.0 ** -24 + q * m * 2.0 ** ((q - 1).bit_length() - 62)
    assert ((got - ref).abs() <= tol).all()


@pytest.mark.parametrize("grad_channels", [1, 2])
def test_non_finite_texels_are_the_plain_scatters(grad_channels):
    """Inf and NaN in g (an Inf on an integer coordinate, whose
    zero-weight taps then take Inf * 0 = NaN), -Inf in channel 1 and a NaN
    coordinate: dimg is non-finite exactly where the plain f32 scatter's
    is, NaN there, and within 1e-5 of it elsewhere."""
    image, px, py, cot = _sampler_coordinates(9, 2, 12, 15, 2)
    px[0, 2, 3], py[0, 2, 3] = 4.0, 5.0
    cot[0, 2, 3, 0] = float("inf")
    cot[1, 4, 5, 0] = float("nan")
    cot[1, 7, 8, 1] = -float("inf")
    px[1, 9, 10] = float("nan")
    got = warp_sample._backward_plain(image, px, py, cot, grad_channels)[0]
    ref = _f32_scatter(image, px, py, cot, grad_channels)
    bad = ~torch.isfinite(ref)
    assert bad[..., 0].sum() > 4 and bad[..., 1].any() == (grad_channels == 2)
    assert torch.equal(~torch.isfinite(got), bad)
    assert torch.isnan(got[bad]).all()
    torch.testing.assert_close(got[~bad], ref[~bad], **TOL)


@pytest.mark.parametrize("scale", [1e-30, 1e30])
@pytest.mark.parametrize("grad_channels", [1, 2])
def test_plain_dimg_at_extreme_g_scales(scale, grad_channels):
    """g far from 1 puts S outside f32's exponent range (S > 127 for tiny
    g, S < 0 for huge g): the fixed-point dimg still agrees with the plain
    f32 scatter."""
    image, px, py, cot = _sampler_coordinates(11, 2, 12, 15, 2)
    cot = cot * scale
    got = warp_sample._backward_plain(image, px, py, cot, grad_channels)[0]
    ref = _f32_scatter(image, px, py, cot, grad_channels)
    assert (warp_sample.fixed_point_shift(cot[..., :grad_channels], 180) > 127) == (scale < 1)
    torch.testing.assert_close(got / scale, ref / scale, **TOL)


def test_fixed_point_shift_ignores_non_finite_g():
    """m is the largest finite |g|: Inf and NaN leave S as zeros would;
    S = 62 - ceil(log2(Q_b)) - frexp(m)'s exponent; no finite g: e = 0."""
    g = torch.from_numpy(np.random.RandomState(10).randn(2, 5, 7, 1).astype(np.float32))
    poisoned = g.clone()
    poisoned[0, 1, 2, 0], poisoned[1, 3, 4, 0] = float("inf"), -float("inf")
    poisoned[1, 0, 0, 0] = float("nan")
    zeroed = torch.where(torch.isfinite(poisoned), poisoned, 0.0)
    shift = warp_sample.fixed_point_shift(poisoned, 35)
    assert shift == warp_sample.fixed_point_shift(zeroed, 35)
    assert shift == 62 - 6 - int(np.frexp(np.abs(zeroed.numpy()).max())[1])
    assert warp_sample.fixed_point_shift(torch.full((1, 2, 2, 1), float("nan")), 4) == 60
