"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57, FCDenseNet103
from endoscopydepthestimation_pytorch_tpu_torch.models.init import init_weights
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                          sgd_update, warp_sample)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, w, c, f, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    scale = torch.rand(c, generator=g) + 0.5
    shift = torch.randn(c, generator=g) * 0.3
    wk = torch.randn(3, 3, c, f, generator=g) * (2.0 / (9 * c)) ** 0.5
    bias = torch.randn(f, generator=g) * 0.1
    return (x.to(device, dtype), scale.to(device), shift.to(device),
            wk.to(device, dtype), bias.to(device))


# (B, H, W, Cin, F): FCDenseNet-57 levels at batch 8 and 1, ragged tiles,
# channel counts that are not a multiple of the 16-channel chunk, F < 12
SHAPES = [
    (8, 256, 320, 48, 12), (8, 128, 160, 132, 12), (8, 16, 20, 372, 12),
    (8, 8, 10, 288, 12), (1, 512, 576, 180, 12), (1, 8, 10, 324, 12),
    (2, 17, 33, 7, 5), (3, 5, 3, 1, 16), (1, 1, 1, 20, 1),
]


@pytest.mark.parametrize("b,h,w,c,f", SHAPES)
def test_kernel_matches_plain_f32(device, b, h, w, c, f):
    args = _inputs(b, h, w, c, f, torch.float32, device)
    before = dense_conv.LAUNCHES
    got = dense_conv.fused_dense_conv(*args)
    ref = dense_conv.fused_dense_conv_reference(*args)
    torch.cuda.synchronize()
    assert dense_conv.LAUNCHES == before + 1
    assert got.shape == (b, h, w, f) and got.is_contiguous()
    err = (got - ref).abs().max().item()
    # FFMA sums in another order than cuDNN's (TF32 off): f32 rounding only
    assert err <= 1e-4 * ref.abs().max().item(), err


@pytest.mark.parametrize("b,h,w,c,f", SHAPES)
def test_kernel_matches_plain_bf16(device, b, h, w, c, f):
    args = _inputs(b, h, w, c, f, torch.bfloat16, device)
    got = dense_conv.fused_dense_conv(*args).float()
    ref = dense_conv.fused_dense_conv_reference(*args).float()
    torch.cuda.synchronize()
    # both round the activation to bf16 the same way; the output rounding
    # and cuDNN's bf16 accumulation order differ
    rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    assert rel <= 1e-2, rel


# (B, H, W, Cin, F) -> (tile_w, channels a lane loads, split): every bf16
# K1 instantiation (tile width 32, 16, 8 x 16-byte, 8-byte and scalar halo
# loads) with its chunks split and in one pass. C % 8 == 0 takes 16-byte
# vectors, C = 4 mod 8 8-byte ones, odd C or F scalars
K1_MMA_SHAPES = {
    (8, 128, 160, 96, 12): (32, 8, False), (1, 128, 160, 96, 12): (32, 8, True),
    (8, 128, 160, 108, 12): (32, 4, False), (4, 16, 24, 44, 12): (32, 4, True),
    (8, 128, 160, 37, 12): (32, 1, False), (1, 16, 20, 96, 5): (32, 1, True),
    (8, 128, 144, 144, 12): (16, 8, False), (1, 64, 80, 144, 12): (16, 8, True),
    (8, 128, 144, 156, 12): (16, 4, False), (1, 64, 80, 156, 12): (16, 4, True),
    (8, 128, 144, 33, 12): (16, 1, False), (2, 64, 80, 37, 12): (16, 1, True),
    (8, 128, 72, 192, 12): (8, 8, False), (1, 32, 40, 192, 12): (8, 8, True),
    (8, 128, 72, 60, 12): (8, 4, False), (2, 64, 72, 60, 12): (8, 4, True),
    (8, 128, 72, 7, 5): (8, 1, False), (2, 64, 72, 37, 12): (8, 1, True),
}


def _bf16_close(got, args, bias=None):
    """The bf16 K1 against its tight twin (the same bf16 operands, f32
    sums in another order, one rounding: a stored value moves only where
    that order crosses a rounding edge) and against the plain version
    (cuDNN's bf16 conv and bias, another rounding)."""
    x, scale, shift, wk = args[:4]
    out = []
    for plain, limit in ((dense_conv.fused_dense_conv_twin, 1e-4),
                         (dense_conv.fused_dense_conv_reference, 1e-2)):
        ref = plain(x, scale, shift, wk, bias).float()
        rel = ((got.float() - ref).abs().mean() / ref.abs().mean()).item()
        out.append(rel <= limit)
    return all(out) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("b,h,w,c,f", list(K1_MMA_SHAPES))
def test_bf16_kernel_instantiations_match_twins(device, b, h, w, c, f):
    x, scale, shift, wk, bias = _inputs(b, h, w, c, f, torch.bfloat16, device)
    tile_w, vw, split = K1_MMA_SHAPES[(b, h, w, c, f)]
    tiling = dense_conv.forward_tiling(torch.bfloat16, b, h, w, c)
    assert (tiling[1], tiling[2] > 1) == (tile_w, split)
    assert dense_conv.vector_width(torch.bfloat16, c, f, x.data_ptr(), wk.data_ptr(),
                                   0) == vw
    before = dense_conv.LAUNCHES
    got = dense_conv.fused_dense_conv(x, scale, shift, wk, bias)
    torch.cuda.synchronize()
    assert dense_conv.LAUNCHES == before + 1
    assert got.shape == (b, h, w, f) and got.dtype == torch.bfloat16
    assert _bf16_close(got, (x, scale, shift, wk), bias)


@pytest.mark.parametrize("b,h,w,c", [(1, 64, 80, 156), (8, 64, 80, 144), (2, 17, 33, 7)])
def test_bf16_kernel_without_bias(device, b, h, w, c):
    x, scale, shift, wk, _ = _inputs(b, h, w, c, 12, torch.bfloat16, device, seed=6)
    got = dense_conv.fused_dense_conv(x, scale, shift, wk)
    torch.cuda.synchronize()
    assert _bf16_close(got, (x, scale, shift, wk))


@pytest.mark.parametrize("c", [96, 60, 37])
def test_bf16_kernel_reads_nothing_past_its_tensors(device, c):
    """x, w, scale, shift and bias each end an allocation, whose tail in
    a larger buffer holds NaN: a read of w, scale, shift or bias past its
    tensor would bring NaN into y. Reads of x past C cannot show here:
    the kernel zeroes the channels >= C by a select, so NaN read past C
    (from the next pixel or the tail) comes out as 0. What keeps x's
    vectors inside C is ``vector_width`` (``test_vector_width``) and the
    C entry's ``vector_ok`` re-check. Also a base only 2-byte aligned,
    which must take the scalar path, and give the same y."""
    b, h, w, f = 2, 24, 40, 12
    args = _inputs(b, h, w, c, f, torch.bfloat16, device, seed=7)

    def at_head(t):  # t's values at the head of a NaN-tailed buffer
        buf = torch.full((t.numel() + 64,), float("nan"), dtype=t.dtype, device=device)
        buf[:t.numel()] = t.flatten()
        return buf[:t.numel()].view(t.shape)

    x, scale, shift, wk, bias = [at_head(t) for t in args]
    got = dense_conv.fused_dense_conv(x, scale, shift, wk, bias)
    exact = dense_conv.fused_dense_conv(*(t.clone() for t in args))
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    buf[1:] = x.flatten()
    odd = buf[1:].view(x.shape)  # 2-byte aligned: scalar loads
    assert dense_conv.vector_width(torch.bfloat16, c, f, odd.data_ptr(), wk.data_ptr(),
                                   0) == 1
    got_odd = dense_conv.fused_dense_conv(odd, scale, shift, wk, bias)
    torch.cuda.synchronize()
    assert _bf16_close(got, args[:4], args[4])
    assert torch.equal(got, exact)
    assert torch.equal(got_odd, got)


@pytest.mark.parametrize("shape", [(1, 64, 80, 156, 12), (8, 128, 144, 144, 12)],
                         ids=["split", "one-pass"])
def test_bf16_kernel_is_deterministic(device, shape):
    """Two bf16 K1 launches on the same inputs give bitwise-equal y, with
    its chunks split across blocks and without: the split's partials are
    summed in a fixed order, no atomics."""
    args = _inputs(*shape, torch.bfloat16, device, seed=8)
    runs = [dense_conv.fused_dense_conv(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


def test_bf16_kernel_under_memcheck(device):
    """A small bf16 K1 call on each halo path, split and in one pass, with
    every tensor at its allocation's end, under ``compute-sanitizer --tool
    memcheck``: no out-of-bounds or misaligned access. Skips where the
    toolkit lacks the sanitizer or it cannot attach to the card."""
    import subprocess
    import sys
    from pathlib import Path

    from endoscopydepthestimation_pytorch_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).parent / "compute-sanitizer"
    if not tool.exists():
        pytest.skip(f"no {tool}")
    dense_conv._library()  # built here, not under the sanitizer
    code = (
        "import torch\n"
        "from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv\n"
        "for b, h, w, c, f in [(1, 24, 40, 96, 12), (1, 24, 40, 60, 12), (1, 24, 40, 37, 5),\n"
        "                      (8, 64, 80, 60, 12)]:\n"
        "    g = torch.Generator().manual_seed(0)\n"
        "    x = torch.randn(b, h, w, c, generator=g).bfloat16().cuda()\n"
        "    wk = (torch.randn(3, 3, c, f, generator=g) * 0.1).bfloat16().cuda()\n"
        "    y = dense_conv.fused_dense_conv(x, torch.ones(c).cuda(), torch.zeros(c).cuda(),\n"
        "                                    wk, torch.zeros(f).cuda())\n"
        "    torch.cuda.synchronize()\n"
        "    assert torch.isfinite(y).all()\n")
    out = subprocess.run([str(tool), "--tool", "memcheck", sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    text = out.stdout + out.stderr
    if "ERROR SUMMARY" not in text or "Device not supported" in text:
        pytest.skip(f"compute-sanitizer cannot check this card: {text[:300]}")
    assert "ERROR SUMMARY: 0 errors" in text and out.returncode == 0, text[-3000:]


def test_border_is_zero_after_activation(device):
    """shift > 0 everywhere: a kernel that padded with relu(shift) would
    differ from the plain version on the image border."""
    x, scale, _, wk, bias = _inputs(2, 9, 40, 24, 12, torch.float32, device)
    shift = torch.full_like(scale, 0.7)
    got = dense_conv.fused_dense_conv(x, scale, shift, wk, bias)
    ref = dense_conv.fused_dense_conv_reference(x, scale, shift, wk, bias)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_refuses_what_it_does_not_take(device):
    x, scale, shift, wk, bias = _inputs(1, 8, 8, 4, 12, torch.float32, device)
    with pytest.raises(ValueError):  # NCHW memory is not NHWC-contiguous
        dense_conv.fused_dense_conv(x.permute(0, 3, 1, 2).contiguous()
                                    .permute(0, 2, 3, 1), scale, shift, wk)
    with pytest.raises(ValueError):  # above the compiled feature maximum
        dense_conv.fused_dense_conv(
            x, scale, shift, torch.zeros(3, 3, 4, 17, device=device))
    with pytest.raises(ValueError):  # inputs on two devices
        dense_conv.fused_dense_conv(x, scale.cpu(), shift, wk)


def test_model_forward_launches_44_kernels(device):
    """FCDenseNet-57 sends every one of its 44 dense layers through the
    kernel at any batch size, and agrees with its own CPU forward."""
    model = FCDenseNet57()
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn(1, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = model(x)
        model.to(device)
        before = dense_conv.LAUNCHES
        got = model(x.to(device)).cpu()
    assert dense_conv.LAUNCHES == before + 44
    err = (got - ref).abs().max().item()
    # 44 layers of f32 sums taken in other orders (TF32 off)
    assert err <= 1e-3 * ref.abs().max().item(), err


def _warp_case(b, h, w, c, device, seed=0):
    """A random warp spanning [-3, size+3] (the clamp band and beyond),
    with the first row of queries on integer coordinates."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn(b, h, w, c, generator=g)
    px = torch.rand(b, h, w, generator=g) * (w + 6) - 3
    py = torch.rand(b, h, w, generator=g) * (h + 6) - 3
    px[:, 0] = torch.arange(w, dtype=torch.float32) - 1
    py[:, 0] = float(h // 2)
    px, py = px.clamp(-2, w + 1), py.clamp(-2, h + 1)
    cot = torch.randn(b, h, w, c, generator=g)
    return [t.to(device) for t in (image, px, py, cot)]


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("grad_first", [False, True])
@pytest.mark.parametrize("b,h,w,c", [(16, 256, 320, 2), (2, 512, 576, 2),
                                     (3, 37, 53, 1)])
def test_warp_sample_matches_plain(device, b, h, w, c, grad_first):
    image, px, py, cot = _warp_case(b, h, w, c, device)
    before = dict(warp_sample.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (image, px, py)]
    got = warp_sample.sample_bilinear(*leaves, grad_first_only=grad_first)
    got_grads = torch.autograd.grad(got, leaves, cot)
    assert warp_sample.LAUNCHES["warp_sample_fwd"] == before["warp_sample_fwd"] + 1
    assert warp_sample.LAUNCHES["warp_sample_bwd"] == before["warp_sample_bwd"] + 1
    ref_leaves = [t.clone().requires_grad_() for t in (image, px, py)]
    ref = warp_sample.sample_bilinear_reference(*ref_leaves)
    # grad-first: the other channels' cotangents count as zero
    ref_cot = torch.cat([cot[..., :1], torch.zeros_like(cot[..., 1:])], -1
                        ) if grad_first else cot
    ref_grads = torch.autograd.grad(ref, ref_leaves, ref_cot)
    twin = warp_sample._backward_plain(image, px, py, cot, 1 if grad_first else c)
    torch.cuda.synchronize()
    # the same f32 products; K3 sums dimg in fixed point (each product
    # rounded by at most max|g| * 2^(h-62)), the autograd scatter in f32
    assert _rel(got, ref) <= 1e-5
    for name, a, r in zip(("dimg", "dpx", "dpy"), got_grads, ref_grads):
        assert _rel(a, r) <= 1e-5, name
    # the twin does K3's arithmetic in int64 scatter_add_: the same bits
    assert torch.equal(got_grads[0], twin[0])


@pytest.mark.parametrize("grad_first", [False, True])
def test_warp_sample_bwd_is_deterministic(device, grad_first):
    """Two K3 launches at the train step's image on the same inputs give
    bitwise-equal dimg, dpx and dpy: dimg is a sum of int64 fixed-point
    contributions, which integer atomics add to the same bits in any
    order, with no float atomics."""
    image, px, py, cot = _warp_case(16, 256, 320, 2, device, seed=2)
    runs = [warp_sample._backward(image, px, py, cot, 1 if grad_first else 2)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, r in zip(("dimg", "dpx", "dpy"), *runs):
        assert torch.equal(a, r), name


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("grad_first", [False, True])
def test_warp_sample_bwd_non_finite_g(device, grad_first):
    """Inf and NaN in g (an Inf on an integer coordinate, so its
    zero-weight taps take Inf * 0 = NaN) and a NaN coordinate: K3's dimg
    is bitwise equal to the twin's, NaN at its non-finite texels (which
    the CPU tests hold to the plain f32 scatter's)."""
    image, px, py, cot = _warp_case(2, 40, 48, 2, device, seed=3)
    px[0, 2, 3], py[0, 2, 3] = 4.0, 5.0
    cot[0, 2, 3, 0] = float("inf")
    cot[1, 4, 5, 0] = float("nan")
    cot[1, 7, 8, 1] = -float("inf")
    px[1, 9, 10] = float("nan")
    cg = 1 if grad_first else 2
    got = warp_sample._backward(image, px, py, cot, cg)
    twin = warp_sample._backward_plain(image, px, py, cot, cg)
    torch.cuda.synchronize()
    assert _same_bits(got[0], twin[0])
    nan = torch.isnan(got[0])
    assert torch.equal(nan, ~torch.isfinite(got[0]))
    assert int(nan[..., 0].sum()) > 4 and bool(nan[..., 1].any()) == (not grad_first)


@pytest.mark.parametrize("scale", [1e-40, 1e-30, 1e30])
def test_warp_sample_bwd_bits_at_extreme_g_scales(device, scale):
    """g scaled so that max|g| is subnormal (1e-40), S exceeds f32's
    exponent range (1e-30) or S < 0 (1e30): K3's dimg still equals the
    twin's bit for bit, in both variants."""
    image, px, py, cot = _warp_case(2, 40, 48, 2, device, seed=5)
    cot = cot * scale
    for cg in (1, 2):
        got = warp_sample._backward(image, px, py, cot, cg)[0]
        twin = warp_sample._backward_plain(image, px, py, cot, cg)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, twin), cg
        assert got[..., 0].abs().max() > 0


@pytest.mark.parametrize("warp", ["smooth", "random"])
def test_warp_sample_bwd_shared_window_and_fallback(device, warp):
    """K3 sums a tile in shared memory where its taps' box fits the window
    (a smooth warp: every tile), else (a random warp: no tile) with global
    atomics: the same bits as the twin either way."""
    b, h, w = 4, 96, 160
    image, px, py, cot = _warp_case(b, h, w, 2, device, seed=4)
    if warp == "smooth":
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        px = (xx + 2 * torch.sin(yy / 17) + 0.3).expand(b, h, w).contiguous()
        py = (yy + 2 * torch.cos(xx / 23) - 0.2).expand(b, h, w).contiguous()
    tiles = b * -(-h // warp_sample.TILE[0]) * -(-w // warp_sample.TILE[1])
    dimg, _, _, fit = warp_sample._backward_cuda(image, px, py, cot, 1)
    twin = warp_sample._backward_plain(image, px, py, cot, 1)
    torch.cuda.synchronize()
    assert torch.equal(dimg, twin[0])
    assert int(fit) == (tiles if warp == "smooth" else 0)


def test_warp_sample_nan_coordinate_gives_nan(device):
    image, px, py, _ = _warp_case(2, 8, 12, 2, device)
    px[0, 3, 4] = float("nan")
    py[1, 5, 6] = float("nan")
    out = warp_sample.sample_bilinear(image, px, py)
    torch.cuda.synchronize()
    nan = torch.isnan(out).any(-1)
    assert nan[0, 3, 4] and nan[1, 5, 6] and int(nan.sum()) == 2


def _tiny_batch(device, b=2, h=64, w=80):
    g = torch.Generator().manual_seed(1)
    k = torch.tensor([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]])
    t12 = torch.tensor([[0.0], [0.0], [0.02]])
    mask = torch.zeros(b, h, w, 1)
    mask[:, 8:-8, 8:-8] = 1
    sparse = torch.zeros(b, h, w, 1)
    sparse[:, 12:-12:4, 12:-12:4] = 1
    batch = {
        "color_1": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "color_2": torch.rand(b, h, w, 3, generator=g) * 2 - 1,
        "sparse_depth_1": sparse, "sparse_depth_2": sparse,
        "depth_mask_1": sparse, "depth_mask_2": sparse,
        "flow_1": torch.zeros(b, h, w, 2), "flow_2": torch.zeros(b, h, w, 2),
        "flow_mask_1": sparse, "flow_mask_2": sparse, "boundary": mask,
        "rotation_1_wrt_2": torch.eye(3).repeat(b, 1, 1),
        "rotation_2_wrt_1": torch.eye(3).repeat(b, 1, 1),
        "translation_1_wrt_2": t12.repeat(b, 1, 1),
        "translation_2_wrt_1": (-t12).repeat(b, 1, 1),
        "intrinsic": k.repeat(b, 1, 1),
    }
    return {key: v.to(device) for key, v in batch.items()}


def _tiny_bf16_steps(device, steps=3):
    """``steps`` bf16 train steps of a tiny FCDenseNet (10 dense layers),
    one K2 and one K3 launch and one optimizer call each, no gradient
    copied into its parameter's layout; returns the K1 launches they
    made. The first step runs eagerly, the second is captured as a CUDA
    graph and replayed, the rest replay (``step_graph``): the counters
    read one step's launches a step all the same."""
    from endoscopydepthestimation_pytorch_tpu_torch import step_graph, training
    from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet
    model = FCDenseNet(down_blocks=(2, 2), up_blocks=(2, 2), bottleneck_layers=2,
                       growth_rate=12, out_chans_first_conv=24,
                       dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    state = training.create_train_state(model.to(device))
    batch = _tiny_batch(device)
    config = training.TrainConfig(lr_step_size=50, compute_dtype=torch.bfloat16)
    k1, k2 = dense_conv.LAUNCHES, dict(warp_sample.LAUNCHES)
    sgd, restrided = sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED
    graphed = dict(step_graph.GRAPHED)
    losses = []
    for _ in range(steps):
        state, metrics = training.train_step(state, batch,
                                             torch.tensor(0.1, device=device), config)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all(), losses
    assert int(state.step) == steps and int(state.count) == steps
    for name in ("warp_sample_fwd", "warp_sample_bwd"):
        assert warp_sample.LAUNCHES[name] == k2[name] + steps, name
    assert sgd_update.LAUNCHES["sgd_update"] == sgd + steps
    assert sgd_update.RESTRIDED == restrided
    assert {k: v - graphed[k] for k, v in step_graph.GRAPHED.items()} == {
        "eager": 1, "captures": 1, "replays": steps - 1}
    return dense_conv.LAUNCHES - k1


def test_tiny_train_step_bf16_launch_counts(device):
    """Three bf16 train steps of a tiny FCDenseNet, one K2 and one K3
    launch and one ``sgd_update`` call per step: every dense layer runs
    K4, K5 and K6 once per step through the engine, every dense block its
    entry and exit once, and K1 never; the glue once a layer and once a
    block in each direction, and the running statistics once a block (2L +
    3 launches a block of L layers)."""
    before = dict(block_engine.LAUNCHES)
    assert _tiny_bf16_steps(device) == 0
    layers, blocks = 10, 5
    per_step = {**dict.fromkeys(block_engine.LAUNCHES, layers), "block_engine_entry": blocks,
                "block_engine_exit": blocks, "block_engine_glue_fwd": layers + blocks,
                "block_engine_glue_bwd": layers + blocks, "block_engine_running_stats": blocks}
    for name, n in block_engine.LAUNCHES.items():
        assert n == before[name] + 3 * per_step[name], name


# the CUDA runtime's and driver's calls that put work on a stream, as the
# profiler names them on the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
                "cuMemcpy", "cuMemset")


def test_traced_step_spans_match_the_launch_counters(device, monkeypatch):
    """One eager bf16 FCDenseNet-57 step under ``torch.profiler``
    recording the device alone, as the benchmark's traced stretch does:
    one ``engine_fwd``, ``engine_dinput`` and ``engine_dweight`` span per
    K4, K5 and K6 launch (44 each), one ``engine_entry`` and
    ``engine_exit`` per block's entry and exit (11 each), one
    ``engine_glue_fwd`` and ``engine_glue_bwd`` per glue launch (44 + 11
    each) and one ``engine_running_stats`` a block, one ``warp_fwd`` and
    one ``warp_bwd``,
    no ``dense_conv``; and on the profiler's clock every K5 kernel starts
    after the step's ``backward`` span began. (A replayed step has no
    such span: ``tests/test_torch_cuda_step_graph.py``.)"""
    from torch.profiler import ProfilerActivity, profile

    from endoscopydepthestimation_pytorch_tpu_torch import step_graph, training
    from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

    class Eager(step_graph.CudaGraphs):
        def engages(self, device):
            return False

    monkeypatch.setattr(step_graph, "BACKEND", Eager())
    model = init_weights(FCDenseNet57(dtype=torch.bfloat16), torch.Generator().manual_seed(0))
    state = training.create_train_state(model.to(device))
    batch = _tiny_batch(device, h=128, w=160)
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    dcl = torch.tensor(0.1, device=device)
    training.train_step(state, batch, dcl, config)  # builds; the profiler off
    torch.cuda.synchronize()
    k1, k23, k456 = (dense_conv.LAUNCHES, dict(warp_sample.LAUNCHES),
                     dict(block_engine.LAUNCHES))
    sgd, restrided = sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        training.train_step(state, batch, dcl, config)
        torch.cuda.synchronize()
    session = profiling.sessions()[-1]
    count = {name: sum(r.name == name for r in session.records)
             for name in ("dense_conv", "warp_fwd", "warp_bwd", "engine_fwd",
                          "engine_dinput", "engine_dweight", "engine_entry", "engine_exit",
                          "engine_glue_fwd", "engine_glue_bwd", "engine_running_stats",
                          "sgd_update")}
    assert count == {
        "dense_conv": dense_conv.LAUNCHES - k1,
        "warp_fwd": warp_sample.LAUNCHES["warp_sample_fwd"] - k23["warp_sample_fwd"],
        "warp_bwd": warp_sample.LAUNCHES["warp_sample_bwd"] - k23["warp_sample_bwd"],
        **{"engine_" + k.removeprefix("block_engine_"): n - k456[k]
           for k, n in block_engine.LAUNCHES.items()},
        "sgd_update": sgd_update.LAUNCHES["sgd_update"] - sgd}
    assert count == {"dense_conv": 0, "warp_fwd": 1, "warp_bwd": 1, "engine_fwd": 44,
                     "engine_dinput": 44, "engine_dweight": 44, "engine_entry": 11,
                     "engine_exit": 11, "engine_glue_fwd": 55, "engine_glue_bwd": 55,
                     "engine_running_stats": 11, "sgd_update": 1}
    assert sgd_update.RESTRIDED == restrided
    parents = {r.parent for r in session.records
               if r.name.startswith("engine_d") or r.name in ("engine_exit", "engine_glue_bwd")}
    assert parents == {"backward"}
    assert {r.parent for r in session.records if r.name in (
        "engine_entry", "engine_glue_fwd", "engine_running_stats")} == {"forward"}
    assert {r.parent for r in session.records if r.name == "sgd_update"} == {"optimizer"}
    (optimizer,) = [r for r in session.records if r.name == "optimizer"]
    launched = [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(LAUNCH_CALLS)
                and optimizer.start_ns <= e.start_ns() <= optimizer.end_ns]
    assert 3 <= len(launched) <= 20, launched
    (backward,) = [r for r in session.records if r.name == "backward"]
    dinput = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and "dinput_mma_kernel" in e.name()]
    assert len(dinput) == 44
    assert min(dinput) > backward.start_ns, (min(dinput) - backward.start_ns) * 1e-6


# -- the multi-tensor optimizer (ops/sgd_update) ------------------------------

# (shape, the parameter's layout, the gradient's): 1-d tensors of 1, 5,
# 4097 and 65,537 elements, the block engine's dW beside an OIHW weight,
# cuDNN's channels_last gradient beside an OIHW weight and the reverse, a
# 1x1 head whose layouts differ only along dimensions of size 1
OPT_TENSORS = [((1,), "contiguous", "contiguous"), ((5,), "contiguous", "contiguous"),
               ((4097,), "contiguous", "contiguous"),
               ((65537,), "contiguous", "contiguous"),
               ((16, 48, 3, 3), "contiguous", "hwio"),
               ((48, 3, 3, 3), "contiguous", "channels_last"),
               ((32, 24, 3, 3), "channels_last", "contiguous"),
               ((24, 24, 3, 3), "channels_last", "channels_last"),
               ((1, 192, 1, 1), "contiguous", "channels_last")]


def _laid_out(x, layout):
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    if layout == "hwio":  # (3, 3, C, F) in memory
        return x.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    return x.contiguous()


def _optimizer_state(device, tensors, norm, seed=0):
    """Parameters, momentum buffers (both random, in the parameters'
    layouts) and gradients scaled to global norm ``norm``, on the card;
    count 5, step 7."""
    g = torch.Generator().manual_seed(seed)
    params, momentum, grads = [], [], []
    for shape, p_layout, g_layout in tensors:
        params.append(_laid_out(torch.randn(shape, generator=g), p_layout).to(device))
        momentum.append(_laid_out(torch.randn(shape, generator=g) * 0.01, p_layout).to(device))
        grads.append(_laid_out(torch.randn(shape, generator=g), g_layout).to(device))
    scale = norm / float(torch.sqrt(sum(x.double().square().sum() for x in grads)))
    grads = [x * scale for x in grads]  # keeps each layout
    count, step = (torch.tensor(v, dtype=torch.int32, device=device) for v in (5, 7))
    return params, momentum, grads, count, step


def _clone(tensors):
    return [t.clone() for t in tensors]  # clone keeps a dense layout


def _optimizer_pair(device, tensors, norm, loss, bad=None):
    """The kernel's and the plain loop's step from one state, with the
    gradient element 4321 of the fourth tensor set to ``bad`` if given:
    the states after it ((params, momentum, count, step) each) and
    (finite, norm) of each."""
    params, momentum, grads, count, step = _optimizer_state(device, tensors, norm)
    if bad is not None:
        grads[3][4321] = bad
    lr = torch.tensor(3e-3, device=device)
    loss = torch.tensor(loss, device=device)
    plain = (_clone(params), _clone(momentum), count.clone(), step.clone())
    got = sgd_update._sgd_update_cuda(params, momentum, grads, loss, lr, count, step,
                                      10.0, 0.9)
    want = sgd_update._sgd_update_plain(plain[0], plain[1], grads, loss, lr, plain[2],
                                        plain[3], 10.0, 0.9)
    return (params, momentum, count, step), plain, got, want


@pytest.mark.parametrize("norm", [3.0, 30.0])  # both sides of the clip at 10
@pytest.mark.parametrize("loss,bad", [(1.25, None), (float("nan"), None),
                                      (float("inf"), None), (1.25, float("nan")),
                                      (1.25, float("inf"))])
def test_sgd_update_kernel_matches_plain(device, norm, loss, bad):
    """The kernel against the plain loop on mixed sizes and layouts: the
    global norm to rtol 1e-6; momentum and parameters bitwise where the
    gradient is not clipped, within rtol 1e-6 of their largest where it
    is; count and step exact. A non-finite loss leaves everything as it
    was (the norm NaN); a finite loss with a non-finite gradient element
    leaves parameters, momentum and count, and advances step."""
    restrided = sgd_update.RESTRIDED
    (p, b, count, step), (pp, pb, pcount, pstep), got, want = _optimizer_pair(
        device, OPT_TENSORS, norm, loss, bad)
    assert sgd_update.RESTRIDED == restrided  # every layout read in place
    finite = loss == 1.25
    assert bool(got[0]) == bool(want[0]) == finite
    updated = finite and bad is None
    if updated:
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    elif bad == float("inf") and finite:
        assert float(got[1]) == float(want[1]) == float("inf")
    else:
        assert torch.isnan(got[1]) and torch.isnan(want[1])
    assert (int(count), int(step)) == (int(pcount), int(pstep)) == (5 + updated, 7 + finite)
    for name, a, ref in [*(("p", x, y) for x, y in zip(p, pp)),
                         *(("b", x, y) for x, y in zip(b, pb))]:
        assert a.stride() == ref.stride()
        if norm < 10.0 or not updated:
            assert torch.equal(a, ref), (name, tuple(a.shape))
        else:
            torch.testing.assert_close(a, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()),
                                       msg=f"{name} {tuple(a.shape)}")


def test_sgd_update_kernel_is_deterministic(device):
    """Two runs from one state give the same bits, clipped and not."""
    for norm in (3.0, 30.0):
        runs = []
        for _ in range(2):
            params, momentum, grads, count, step = _optimizer_state(device, OPT_TENSORS, norm)
            _, got = sgd_update._sgd_update_cuda(
                params, momentum, grads, torch.tensor(1.0, device=device),
                torch.tensor(3e-3, device=device), count, step, 10.0, 0.9)
            runs.append([got, *params, *momentum])
        assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_sgd_update_checks_a_parameter_again_once_its_storage_moves(device):
    """The parameters and momentum buffers are checked once while they
    stay where they are; a parameter moved to another layout (new storage)
    is checked again, and its momentum buffer, left in the old layout, is
    refused."""
    params, momentum, grads, count, step = _optimizer_state(device, OPT_TENSORS, 3.0)
    args = (torch.tensor(1.0, device=device), torch.tensor(3e-3, device=device), count,
            step, 10.0, 0.9)
    for _ in range(2):
        sgd_update._sgd_update_cuda(params, momentum, grads, *args)
    params[4].data = params[4].data.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="lie in memory as its parameter"):
        sgd_update._sgd_update_cuda(params, momentum, grads, *args)
    assert (int(count), int(step)) == (7, 9)


def test_sgd_update_at_fcdensenet103_shapes_is_one_call_of_few_launches(device):
    """FC-DenseNet-103's 398 parameter tensors (9,319,521 elements), the
    dense layers' gradients laid out as the engine's dW: one C call, at most
    four device operations, and the plain loop's parameters and momentum
    bit for bit (unclipped)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in FCDenseNet103().parameters()]
    assert len(shapes) == 398 and sum(torch.Size(s).numel() for s in shapes) == 9319521
    tensors = [(s, "contiguous", "hwio" if len(s) == 4 and s[2] == 3 else "contiguous")
               for s in shapes]
    params, momentum, grads, count, step = _optimizer_state(device, tensors, 3.0)
    plain = (_clone(params), _clone(momentum), count.clone(), step.clone())
    scalars = (torch.tensor(1.0, device=device), torch.tensor(3e-3, device=device))
    calls = sgd_update.LAUNCHES["sgd_update"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sgd_update._sgd_update_cuda(params, momentum, grads, *scalars, count, step, 10.0, 0.9)
        torch.cuda.synchronize()
    assert sgd_update.LAUNCHES["sgd_update"] == calls + 1
    device_ops = [e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert 3 <= len(device_ops) <= 4, device_ops
    sgd_update._sgd_update_plain(plain[0], plain[1], grads, *scalars, plain[2], plain[3],
                                 10.0, 0.9)
    assert all(torch.equal(a, b) for a, b in zip(params + momentum, plain[0] + plain[1]))


# (B, H, W, C, F, extra channels after the layer's): a full-resolution
# up-block layer, a ragged tile with F < 12 and a row stride (15) that is
# not 16-byte aligned, a deep level whose f32 K5 splits its channel chunks
# across blocks, with F = 16; a first-down-block layer (C = 60 = 4 mod 8,
# row stride 96: bf16 K5's 16-byte path with a ragged last vector); a
# width (44) and height (20) that no 256-pixel tile divides, with C = 36;
# bf16 K5's scalar path (odd C and F) in its 32- and 16-wide tiles; a
# 16-byte row with C = 16 (one chunk: bf16 K4 in one pass, 8 wide). With
# them the bf16 K4 runs every tile width on both paths, its one-pass
# epilogue and its split chunks (``forward_tiling``; the third to fifth
# shapes split)
ENGINE_SHAPES = [(8, 64, 80, 180, 12, 24), (2, 17, 33, 7, 5, 3),
                 (4, 8, 10, 324, 16, 0), (4, 32, 64, 60, 12, 24),
                 (2, 20, 44, 36, 12, 0), (2, 16, 20, 7, 5, 3),
                 (2, 64, 80, 7, 5, 3), (2, 32, 40, 16, 12, 4)]


def _engine_layer(b, h, w, c, f, extra, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    ld = c + f + extra
    buf = torch.randn(b, h, w, ld, generator=g)
    grad = torch.randn(b, h, w, ld, generator=g)
    scale = torch.rand(c, generator=g) + 0.5
    shift = torch.randn(c, generator=g) * 0.3
    wk = torch.randn(3, 3, c, f, generator=g) * (2.0 / (9 * c)) ** 0.5
    bias = torch.randn(f, generator=g) * 0.1
    c1 = torch.randn(f, generator=g) * 0.1
    c2 = torch.randn(f, generator=g) * 0.1
    return (buf.to(device, dtype), grad.to(device, dtype), scale.to(device),
            shift.to(device), wk.to(device, dtype), bias.to(device),
            c1.to(device), c2.to(device))


def _close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:  # f32 sums in another order (TF32 off)
        return _rel(got, ref) <= 1e-4
    # the same bf16 operands and roundings, f32 sums in another order: a
    # stored value differs only where that order crosses a rounding edge
    return ((got - ref).abs().mean() / ref.abs().mean()).item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,f,extra", ENGINE_SHAPES)
def test_engine_kernels_match_twins(device, b, h, w, c, f, extra, dtype):
    """K4, K5 and K6 against their plain versions on the same inputs; the
    channels a kernel does not own stay as they were."""
    buf, grad, scale, shift, wk, bias, c1, c2 = _engine_layer(
        b, h, w, c, f, extra, dtype, device)
    before = dict(block_engine.LAUNCHES)
    got_buf, ref_buf = buf.clone(), buf.clone()
    got = block_engine.layer_forward(got_buf, c, scale, shift, wk, bias).sum(1)
    ref = block_engine.layer_forward_reference(ref_buf, c, scale, shift, wk, bias)
    torch.cuda.synchronize()
    assert _close(got_buf[..., c:c + f], ref_buf[..., c:c + f], dtype)
    assert _close(got, ref, dtype), (got, ref)
    keep = torch.cat([buf[..., :c], buf[..., c + f:]], -1)
    assert torch.equal(torch.cat([got_buf[..., :c], got_buf[..., c + f:]], -1), keep)

    # K5 adds into the random gradient prefix; in bf16 also into a zero
    # one, which compares the increment itself after rounding
    grads = [grad]
    if dtype == torch.bfloat16:
        grads.append(torch.cat([torch.zeros_like(grad[..., :c]), grad[..., c:]], -1))
    for grad0 in grads:
        got_grad, ref_grad = grad0.clone(), grad0.clone()
        part, part_bias = block_engine.layer_dinput(got_grad, buf, c, scale, shift, wk,
                                                    c1, c2)
        got = (*part.sum(1), part_bias.sum(0))
        ref = block_engine.layer_dinput_reference(ref_grad, buf, c, scale, shift, wk,
                                                  c1, c2)
        torch.cuda.synchronize()
        assert _close(got_grad[..., :c], ref_grad[..., :c], dtype)
        assert torch.equal(got_grad[..., c:], grad0[..., c:])
        for name, a, r in zip(("dscale", "dshift", "dbias"), got, ref):
            assert _close(a, r, dtype), name

    got = block_engine.layer_dweight(grad, buf, c, f, scale, shift, c1, c2)
    ref = block_engine.layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)
    torch.cuda.synchronize()
    assert got.shape == (3, 3, c, f) and _close(got, ref, dtype)
    for name, n in block_engine.LAUNCHES.items():
        k5 = name == "block_engine_dinput"
        layer = name in ("block_engine_fwd", "block_engine_dinput", "block_engine_dweight")
        assert n == before[name] + (len(grads) if k5 else 1 if layer else 0), name


def test_engine_dinput_is_deterministic(device):
    """Two bf16 K5 launches on the same inputs give bitwise-equal gradient
    prefixes and sums: every reduction runs in a fixed order, no atomics."""
    b, h, w, c, f, extra = ENGINE_SHAPES[3]
    buf, grad, scale, shift, wk, _, c1, c2 = _engine_layer(
        b, h, w, c, f, extra, torch.bfloat16, device, seed=1)
    runs = []
    for _ in range(2):
        got_grad = grad.clone()
        part, part_bias = block_engine.layer_dinput(got_grad, buf, c, scale, shift, wk, c1, c2)
        runs.append((got_grad, *part.sum(1), part_bias.sum(0)))
    torch.cuda.synchronize()
    for name, a, r in zip(("grad", "dscale", "dshift", "dbias"), *runs):
        assert torch.equal(a, r), name


@pytest.mark.parametrize("shape", [ENGINE_SHAPES[3], ENGINE_SHAPES[7]],
                         ids=["split", "one-pass"])
def test_engine_forward_is_deterministic(device, shape):
    """Two bf16 K4 launches on the same inputs give bitwise-equal y and
    sums, with its chunks split across blocks and without: every reduction
    runs in a fixed order, no atomics."""
    b, h, w, c, f, extra = shape
    buf, _, scale, shift, wk, bias, _, _ = _engine_layer(
        b, h, w, c, f, extra, torch.bfloat16, device, seed=2)
    runs = []
    for _ in range(2):
        got = buf.clone()
        runs.append((got, block_engine.layer_forward(got, c, scale, shift, wk, bias).sum(1)))
    torch.cuda.synchronize()
    for name, a, r in zip(("buf", "sums"), *runs):
        assert torch.equal(a, r), name


def test_dinput_check_catches_a_kernel_that_drops_the_old_gradient(
        device, tmp_path, monkeypatch):
    """A copy of block_engine.cu whose bf16 K5 stores its increment without
    adding the old gradient, built with the package's nvcc flags: on a
    random gradient prefix the comparison of
    ``test_engine_kernels_match_twins`` fails on it, and passes on the
    real kernel with the same inputs."""
    import ctypes
    import subprocess

    from endoscopydepthestimation_pytorch_tpu_torch.ops import _build
    source = (_build.CSRC / "block_engine.cu").read_text()
    store = "__fadd_rn(gv.x, __fmul_rn(d0, sc.x)), __fadd_rn(gv.y, __fmul_rn(d1, sc.y))"
    assert source.count(store) == 1
    mutant_src = tmp_path / "block_engine.cu"
    mutant_src.write_text(source.replace(store, "__fmul_rn(d0, sc.x), __fmul_rn(d1, sc.y)"))
    mutant_lib = tmp_path / "block_engine_mutant.so"
    # the copy includes the shared header from the package's csrc
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(mutant_lib), str(mutant_src)], check=True,
                   capture_output=True)
    mutant = block_engine.bind(ctypes.CDLL(str(mutant_lib)))

    b, h, w, c, f, extra = ENGINE_SHAPES[3]
    buf, grad, scale, shift, wk, _, c1, c2 = _engine_layer(
        b, h, w, c, f, extra, torch.bfloat16, device)
    ref_grad = grad.clone()
    block_engine.layer_dinput_reference(ref_grad, buf, c, scale, shift, wk, c1, c2)

    def passes() -> bool:
        got = grad.clone()
        block_engine.layer_dinput(got, buf, c, scale, shift, wk, c1, c2)
        torch.cuda.synchronize()
        return _close(got[..., :c], ref_grad[..., :c], torch.bfloat16)

    assert passes()
    monkeypatch.setattr(block_engine, "_library", lambda: mutant)
    assert not passes()


def test_block_engine_apply_matches_cpu(device):
    """A 4-layer growth-12 block, f32, forward and every gradient (through
    mu and m2 too) on the card against the same orchestration on the CPU
    twins."""
    g = torch.Generator().manual_seed(3)
    b, h, w, c0, n_layers, f = 4, 24, 40, 20, 4, 12
    x = torch.randn(b, h, w, c0, generator=g)
    params = ([torch.rand(c0 + j * f, generator=g) + 0.5 for j in range(n_layers)]
              + [torch.randn(c0 + j * f, generator=g) * 0.1 for j in range(n_layers)]
              + [torch.randn(3, 3, c0 + j * f, f, generator=g) * 0.1
                 for j in range(n_layers)]
              + [torch.randn(f, generator=g) * 0.1 for j in range(n_layers)])
    ctot = c0 + n_layers * f
    cots = (torch.randn(b, h, w, ctot, generator=g), torch.randn(ctot, generator=g),
            torch.randn(ctot, generator=g))

    def run(dev):
        leaves = [t.to(dev).requires_grad_() for t in [x] + params]
        outs = block_engine.block_engine_apply(
            leaves[0], *(leaves[1 + i * n_layers:1 + (i + 1) * n_layers]
                         for i in range(4)))
        grads = torch.autograd.grad(outs, leaves, [t.to(dev) for t in cots])
        return [t.detach().cpu() for t in list(outs) + list(grads)]

    before = dict(block_engine.LAUNCHES)
    got = run(device)
    assert {k: n - before[k] for k, n in block_engine.LAUNCHES.items()} == {
        "block_engine_fwd": n_layers, "block_engine_dinput": n_layers,
        "block_engine_dweight": n_layers, "block_engine_entry": 1, "block_engine_exit": 1,
        "block_engine_glue_fwd": n_layers + 1, "block_engine_glue_bwd": n_layers + 1,
        "block_engine_running_stats": 0}
    ref = run("cpu")
    for i, (a, r) in enumerate(zip(got, ref)):
        assert _rel(a, r) <= 1e-4, i


def _dense_blocks(net: str) -> tuple:
    """[(H, W, C0, layers)] of the 11 dense blocks of FCDenseNet-57 or
    FC-DenseNet-103 at 256x320, in forward order, and the growth."""
    import chip_smoke
    if net == "fcdensenet57":
        sizes, kwargs = (4,) * 11, {}
    else:
        down, up = (4, 5, 7, 10, 12), (12, 10, 7, 5, 4)
        sizes, kwargs = down + (15,) + up, dict(down=down, up=up, bottleneck=15, growth=16)
    layers = chip_smoke.dense_layer_shapes(256, 320, **kwargs)
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    return [(*layers[s], n) for s, n in zip(starts, sizes)], kwargs.get("growth", 12)


def _glue_block(c0, n_layers, f, device, seed):
    """The block's statistics mu, m2 (C_tot,) and per layer (gamma, beta,
    kernel): the kernel an HWIO view of an OIHW f32 parameter, as the model
    passes it."""
    g = torch.Generator().manual_seed(seed)
    ctot = c0 + n_layers * f
    mu = torch.randn(ctot, generator=g) * 0.5
    m2 = mu.square() + torch.rand(ctot, generator=g) + 0.5
    layers = [(torch.rand(c0 + j * f, generator=g) + 0.5,
               torch.randn(c0 + j * f, generator=g) * 0.1,
               torch.randn(f, c0 + j * f, 3, 3, generator=g))
              for j in range(n_layers)]
    return mu.to(device), m2.to(device), [
        (gamma.to(device), beta.to(device), k.to(device).permute(2, 3, 1, 0))
        for gamma, beta, k in layers]


def _sums_close(got, ref, part, dim) -> bool:
    """f32 sums of the same partials in another order: within 1e-5 of the
    partials' absolute sum, the bound this test states for them."""
    return bool(((got - ref).abs() <= 1e-5 * part.abs().sum(dim)).all())


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("net", ["fcdensenet57", "fcdensenet103"])
def test_glue_kernels_match_twins(device, net, dtype):
    """Every dense layer's glue of FCDenseNet-57 or FC-DenseNet-103 at 2B =
    16 256x320, on random partials of K4's and K5's shapes at that layer:
    the sums (statistics, dbeta, the bias gradient, the rank's (dsx, dss))
    within 1e-5 of the partials' absolute sum of the twin's, and bitwise
    the same over 3 runs; what is computed from them bitwise the plain
    expressions on the card given the kernel's sums: the statistics from
    the means, dgamma, the (C1, C2) updates, the folds and the kernels
    cast. The one-call path equals the two calls of a process group
    bitwise; the backward's start is bitwise its twin."""
    reduce, finish = block_engine.REDUCE, block_engine.FINISH
    blocks, f = _dense_blocks(net)
    b = 16
    for i, (h, w, c0, n_layers) in enumerate(blocks):
        n = b * h * w
        mu, m2, layers = _glue_block(c0, n_layers, f, device, seed=i)
        ctot = mu.shape[0]
        g = torch.Generator(device=device).manual_seed(i)

        def fresh():
            return block_engine.GlueBuffers.empty(ctot - f, f, dtype, device)

        # the backward's start: C1, C2 from the cotangent, the top layer's fold
        gmu, gm2 = (torch.randn(ctot, generator=g, device=device) for _ in range(2))
        runs = []
        for glue in (block_engine.glue_backward_start,
                     block_engine.glue_backward_start_reference):
            c1, c2 = torch.empty(ctot, device=device), torch.empty(ctot, device=device)
            runs.append((c1, c2, *glue(mu, m2, c1, c2, gmu, gm2, n, layers[-1], fresh())))
        assert _same(*runs), (net, i, "start")
        for j in range(n_layers):
            c = c0 + j * f
            where = (net, i, j)
            # the forward, after layer j's K4
            n_part = block_engine._n_part(b, h, w,
                                          *block_engine.forward_tiling(dtype, b, h, w, c)[:2])
            part = torch.randn(2, n_part, f, generator=g, device=device) * 16
            part[1] = part[1].abs() * 16
            nxt = layers[j + 1] if j + 1 < n_layers else None
            outs = []
            for _ in range(3):
                mu_k, m2_k = mu.clone(), m2.clone()
                folded = block_engine.glue_forward(mu_k, m2_k, c, part, n, reduce | finish,
                                                   nxt, fresh())
                outs.append((mu_k, m2_k, *(folded or ())))
            assert all(_same(outs[0], o) for o in outs[1:]), where
            mu_k, m2_k = outs[0][:2]
            mu_t, m2_t = mu.clone(), m2.clone()
            block_engine.glue_forward_reference(mu_t, m2_t, c, part, n, reduce | finish, None,
                                                None)
            assert torch.equal(mu_k[:c], mu[:c]) and torch.equal(m2_k[c + f:], m2[c + f:])
            assert _sums_close(mu_k[c:c + f] * n, mu_t[c:c + f] * n, part[0], 0), where
            assert _sums_close(m2_k[c:c + f] * n, m2_t[c:c + f] * n, part[1], 0), where
            moments = block_engine.glue_forward(mu.clone(), m2.clone(), c, part, n, reduce,
                                                None, fresh())
            assert torch.equal(moments, torch.stack([mu_k[c:c + f], m2_k[c:c + f]])), where
            if nxt is not None:
                twin = block_engine._fold_next(mu_k, m2_k, nxt, fresh())
                assert _same(outs[0][2:], twin), where
            two = [mu.clone(), m2.clone()]
            folded = block_engine.glue_forward(*two, c, moments, n, finish, nxt, fresh())
            assert _same(two + list(folded or ()), outs[0]), where

            # the backward, after layer j's K5 and K6
            n_part = block_engine._n_part(b, h, w,
                                          *block_engine.dinput_tiling(dtype, b, h, w, c)[:2])
            part = torch.randn(2, n_part, c, generator=g, device=device)
            part_bias = torch.randn(n_part, f, generator=g, device=device)
            c1, c2 = (torch.randn(ctot, generator=g, device=device) * 0.1 for _ in range(2))
            gamma = layers[j][0]
            prev = layers[j - 1] if j > 0 else None
            outs = []
            for _ in range(3):
                grads = [torch.empty(k, device=device) for k in (c, c, f)]
                c1_k, c2_k = c1.clone(), c2.clone()
                folded = block_engine.glue_backward(mu, m2, c1_k, c2_k, c, (part, part_bias),
                                                    n, reduce | finish, gamma, grads, prev,
                                                    fresh())
                outs.append((*grads, c1_k, c2_k, *(folded or ())))
            assert all(_same(outs[0], o) for o in outs[1:]), where
            dgamma, dbeta, dbias = outs[0][:3]
            grads = [torch.empty(k, device=device) for k in (c, c, f)]
            sums = block_engine.glue_backward(mu, m2, c1.clone(), c2.clone(), c,
                                              (part, part_bias), n, reduce, gamma, grads, None,
                                              fresh())
            assert _sums_close(sums, part.sum(1), part, 1) and torch.equal(sums[1], dbeta)
            assert _sums_close(dbias, part_bias.sum(0), part_bias, 0), where
            assert _same(grads, outs[0][:3]), where
            inv = torch.rsqrt(m2[:c] - mu[:c].square() + block_engine.EPS)
            assert torch.equal(dgamma, inv * (sums[0] - mu[:c] * sums[1])), where
            for glue in (block_engine.glue_backward, block_engine.glue_backward_reference):
                c1_t, c2_t = c1.clone(), c2.clone()
                folded = glue(mu, m2, c1_t, c2_t, c, sums, n, finish, gamma, None, prev,
                              fresh())
                assert _same((c1_t, c2_t, *(folded or ())), outs[0][3:]), (*where, glue)
            assert torch.equal(outs[0][3][c:], c1[c:]) and torch.equal(outs[0][4][c:], c2[c:])


def test_glue_launches_of_a_fcdensenet103_block(device):
    """FC-DenseNet-103's bottleneck block (15 layers of growth 16 on 656
    channels, bf16, 2B = 16 at 8x10) as a train-mode ``DenseBlock``,
    forward and backward: the glue once before the first layer and once
    after each in each direction (16 + 16 C calls) and the running
    statistics once, beside 15 of K4, K5 and K6 and one entry and exit:
    33 glue launches, 2.2 a dense layer. The running statistics are
    bitwise ``update_running_stats`` layer by layer on the card."""
    from endoscopydepthestimation_pytorch_tpu_torch.models import fcdensenet
    block = fcdensenet.DenseBlock(656, 16, 15, upsample=True).to(device).train()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g))
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    x = torch.randn(16, 656, 8, 10, generator=g).to(device, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    want = [(layer.norm.running_mean.clone(), layer.norm.running_var.clone())
            for layer in block.layers]
    before = dict(block_engine.LAUNCHES)
    out, (mu, m2) = block(x, with_stats=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in block_engine.LAUNCHES.items()}
    assert moved == {"block_engine_fwd": 15, "block_engine_dinput": 15,
                     "block_engine_dweight": 15, "block_engine_entry": 1,
                     "block_engine_exit": 1, "block_engine_glue_fwd": 16,
                     "block_engine_glue_bwd": 16, "block_engine_running_stats": 1}
    glue = sum(moved[k] for k in ("block_engine_glue_fwd", "block_engine_glue_bwd",
                                  "block_engine_running_stats"))
    assert glue == 33 <= 3 * 15
    for j, ((mean, var), layer) in enumerate(zip(want, block.layers)):
        bn = torch.nn.BatchNorm2d(656 + 16 * j).to(device)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
        fcdensenet.update_running_stats(bn, mu[:656 + 16 * j].detach(),
                                        m2[:656 + 16 * j].detach())
        assert torch.equal(layer.norm.running_mean, bn.running_mean), j
        assert torch.equal(layer.norm.running_var, bn.running_var), j


# (B, H, W, C, F, extra) -> (tile_w, prefix vector width): every bf16 K6
# instantiation (tile width 32, 16, 8 x 16/8-byte and scalar loads), with
# ragged tiles, F in {1, 5, 12, 16}, odd C (scalars), C % 8 == 4 (8-byte g
# and y beside 16-byte prefix vectors), extra = 0 (the last layer of a
# block: C + F = ld), one tile (n_split = 1) and the wrapper's most splits
# (DWEIGHT_BLOCKS, one chunk over 320 tiles)
K6_MMA_SHAPES = {
    (2, 20, 44, 36, 12, 0): (32, 8), (4, 8, 10, 320, 16, 8): (32, 8),
    (1, 8, 10, 48, 12, 4): (32, 8), (2, 16, 20, 7, 1, 0): (32, 1),
    (3, 40, 24, 33, 5, 2): (32, 1), (16, 64, 80, 16, 12, 4): (16, 8),
    (2, 64, 80, 36, 12, 4): (16, 1), (2, 64, 80, 7, 5, 3): (16, 1),
    (2, 32, 40, 44, 12, 0): (8, 8), (2, 32, 40, 20, 16, 4): (8, 8),
    (2, 17, 33, 7, 5, 3): (8, 1),
}


@pytest.mark.parametrize("b,h,w,c,f,extra", list(K6_MMA_SHAPES))
def test_bf16_dweight_instantiations_match_plain(device, b, h, w, c, f, extra):
    """Each bf16 K6 instantiation against ``layer_dweight_reference``: the
    same bf16 operands, f32 sums in another order (mean rel <= 1e-4)."""
    buf, grad, scale, shift, _, _, c1, c2 = _engine_layer(
        b, h, w, c, f, extra, torch.bfloat16, device, seed=9)
    tile_w, vw = K6_MMA_SHAPES[(b, h, w, c, f, extra)]
    _, got_tile_w, n_split = block_engine.dweight_tiling(torch.bfloat16, b, h, w, c)
    assert got_tile_w == tile_w
    assert block_engine.dweight_vector_width(torch.bfloat16, c, f, c + f + extra,
                                             buf.data_ptr(), grad.data_ptr()) == vw
    if (b, h, w) == (1, 8, 10):
        assert n_split == 1
    if (b, c) == (16, 16):
        assert n_split == block_engine.DWEIGHT_BLOCKS
    before = block_engine.LAUNCHES["block_engine_dweight"]
    got = block_engine.layer_dweight(grad, buf, c, f, scale, shift, c1, c2)
    ref = block_engine.layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)
    torch.cuda.synchronize()
    assert block_engine.LAUNCHES["block_engine_dweight"] == before + 1
    assert got.shape == (3, 3, c, f) and bool(torch.isfinite(got).all())
    assert _close(got, ref, torch.bfloat16)


def test_engine_dweight_is_deterministic(device):
    """Two bf16 K6 launches on the same inputs give bitwise-equal dW: the
    warps' and the splits' partials are summed in a fixed order, no
    atomics."""
    b, h, w, c, f, extra = ENGINE_SHAPES[0]
    buf, grad, scale, shift, _, _, c1, c2 = _engine_layer(
        b, h, w, c, f, extra, torch.bfloat16, device, seed=10)
    runs = [block_engine.layer_dweight(grad, buf, c, f, scale, shift, c1, c2)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


# (B, H, W, C0, ld, dtype) -> the channels a lane moves: FC-DenseNet-103's
# and FCDenseNet-57's last up block at 2B = 16, 256x320; FC-DenseNet-103's
# bottleneck; a row of more than 256 vectors; f32 vectors; scalars (ld or
# C0 off the vector)
BOUNDARY_CASES = {
    (16, 256, 320, 192, 256, torch.bfloat16): 8, (16, 256, 320, 144, 192, torch.bfloat16): 8,
    (16, 8, 10, 656, 896, torch.bfloat16): 8, (2, 8, 10, 2056, 2064, torch.bfloat16): 8,
    (4, 64, 80, 48, 100, torch.bfloat16): 1, (3, 17, 33, 37, 61, torch.bfloat16): 1,
    (4, 64, 80, 48, 96, torch.float32): 4, (3, 17, 33, 37, 61, torch.float32): 1,
}


def _boundary_moved(before: dict) -> dict:
    return {k: n - before[k] for k, n in block_engine.LAUNCHES.items() if n != before[k]}


@pytest.mark.parametrize("case", list(BOUNDARY_CASES), ids=str)
def test_block_entry_copies_x_and_its_moments(device, case):
    """The entry kernel: ``buf[..., :C0]`` bitwise x and the rest of buf
    untouched; x's per-channel mean and mean of squares within 2e-6
    (relative) of their f64 values; a repeat bitwise equal; one counted C
    call each."""
    b, h, w, c0, ld, dtype = case
    g = torch.Generator(device=device).manual_seed(21)
    offset = torch.rand(c0, generator=g, device=device) + 0.5
    x = (torch.randn(b, h, w, c0, generator=g, device=device) + offset).to(dtype)
    bufs = [torch.full((b, h, w, ld), 7.0, dtype=dtype, device=device) for _ in range(2)]
    assert block_engine.boundary_layout(bufs[0], c0, x)["vw"] == BOUNDARY_CASES[case]
    before = dict(block_engine.LAUNCHES)
    stats = [block_engine.block_entry(x, buf) for buf in bufs]
    torch.cuda.synchronize()
    assert _boundary_moved(before) == {"block_engine_entry": 2}
    assert torch.equal(bufs[0][..., :c0], x) and bool((bufs[0][..., c0:] == 7).all())
    assert torch.equal(*bufs) and torch.equal(*stats)
    x64 = x.double()
    want = torch.stack([x64.mean((0, 1, 2)), x64.square().mean((0, 1, 2))])
    assert stats[0].shape == (2, c0) and stats[0].dtype == torch.float32
    rel = ((stats[0].double() - want).abs() / want.abs()).max().item()
    assert rel <= 2e-6, rel


@pytest.mark.parametrize("case", list(BOUNDARY_CASES), ids=str)
def test_block_exit_is_bitwise_its_twin(device, case):
    """The exit kernel: dx = (g + c1) + c2*x over the prefix bitwise
    ``block_exit_reference``'s (the same f32 steps, no FMA, the same
    rounding to the dtype), on the vector and the scalar path; a fresh
    contiguous (B, H, W, C0) tensor; a repeat bitwise equal."""
    b, h, w, c0, ld, dtype = case
    g = torch.Generator(device=device).manual_seed(22)
    buf = torch.randn(b, h, w, ld, generator=g, device=device).to(dtype)
    grad = torch.randn(b, h, w, ld, generator=g, device=device).to(dtype)
    c1, c2 = (torch.randn(ld, generator=g, device=device) * 0.1 for _ in range(2))
    assert block_engine.boundary_layout(buf, c0, grad)["vw"] == BOUNDARY_CASES[case]
    before = dict(block_engine.LAUNCHES)
    dx = [block_engine.block_exit(grad, buf, c1, c2, c0) for _ in range(2)]
    ref = block_engine.block_exit_reference(grad, buf, c1, c2, c0)
    torch.cuda.synchronize()
    assert _boundary_moved(before) == {"block_engine_exit": 2}
    assert dx[0].shape == (b, h, w, c0) and dx[0].dtype == dtype and dx[0].is_contiguous()
    assert torch.equal(dx[0], ref) and torch.equal(*dx)


def test_engine_backward_allocates_no_f32_temporaries(device):
    """``engine_backward`` at FCDenseNet-57's last up block (2B = 16,
    256x320, C0 144, four layers of growth 12: ld 192), bf16: the
    allocator's peak rises by no more than the gradient buffer, dx and 1
    MiB (the per-layer partials and the parameters' gradients)."""
    b, h, w, c0, n_layers, f = 16, 256, 320, 144, 4, 12
    g = torch.Generator(device=device).manual_seed(23)
    cs = [c0 + j * f for j in range(n_layers)]
    ld = c0 + n_layers * f

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    params = ([torch.rand(c, generator=g, device=device) + 0.5 for c in cs]
              + [randn(c, scale=0.1) for c in cs]
              + [randn(3, 3, c, f, scale=(2.0 / (9 * c)) ** 0.5) for c in cs]
              + [randn(f, scale=0.1) for _ in cs])
    buf = randn(b, h, w, ld).bfloat16()
    mu = buf.float().mean((0, 1, 2))
    m2 = buf.float().square().mean((0, 1, 2))
    gbuf, gmu, gm2 = randn(b, h, w, ld).bfloat16(), randn(ld), randn(ld)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    dx, *_ = block_engine.engine_backward(buf, mu, m2, n_layers, params, gbuf, gmu, gm2)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(device) - base
    grad_bytes, dx_bytes = 2 * buf.numel(), 2 * dx.numel()
    assert dx.shape == (b, h, w, c0) and bool(torch.isfinite(dx.float()).all())
    assert rise <= grad_bytes + dx_bytes + 2 ** 20, rise - grad_bytes - dx_bytes


def test_device_prefetch_copies_every_batch_to_the_card(device):
    """``device_prefetch`` on the card: each batch's arrays arrive equal,
    in order, as tensors on the current device; list fields stay on the
    host; a step's stream may read a batch as soon as it is yielded (the
    stream waits on the copy's event), even while the next copies run."""
    import numpy as np

    from endoscopydepthestimation_pytorch_tpu_torch.parallel import device_prefetch
    rng = np.random.RandomState(0)
    batches = [{"color_1": rng.rand(8, 256, 320, 3).astype(np.float32),
                "boundary": rng.rand(8, 256, 320, 1).astype(np.float32),
                "names": [str(i)] * 8} for i in range(5)]
    seen = []
    for host, moved in zip(batches, device_prefetch(iter(batches), "cuda", depth=2)):
        assert sorted(moved) == ["boundary", "color_1"]
        assert moved["color_1"].device.index == torch.cuda.current_device()
        total = moved["color_1"].sum() + moved["boundary"].sum()  # read on the step's stream
        seen.append((total, host))
    for total, host in seen:
        want = host["color_1"].astype(np.float64).sum() + host["boundary"].astype(np.float64).sum()
        assert abs(total.item() - want) <= 1e-4 * want
    assert len(seen) == 5


def test_evaluate_test_phase_on_the_card(device, tmp_path):
    """The evaluate CLI's test phase on the card (f32, the default):
    every frame's eval forward launches K1 44 times and nothing else, and
    every frame writes a PNG and a PLY whose depths are finite and >= 0."""
    import numpy as np

    from endoscopydepthestimation_pytorch_tpu_torch import evaluate
    from endoscopydepthestimation_pytorch_tpu_torch.models import save_reference_checkpoint
    from endoscopydepthestimation_pytorch_tpu_torch.utils import plyio
    from torch_sfm_sequence import write_sequence

    folder = write_sequence(tmp_path / "data", seed=5, n_frames=4)
    checkpoint = tmp_path / "model.pt"
    save_reference_checkpoint(checkpoint, init_weights(FCDenseNet57(),
                                                       torch.Generator().manual_seed(0)))
    k1, sampler = dense_conv.LAUNCHES, dict(warp_sample.LAUNCHES)
    engine = dict(block_engine.LAUNCHES)
    run = evaluate.main([
        "--adjacent_range", "1", "3", "--id_range", "1", "2", "--input_size", "64", "64",
        "--num_pre_workers", "1", "--testing_patient_id", "1", "--load_all_frames",
        "--trained_model_path", str(checkpoint), "--sequence_root", str(folder),
        "--evaluation_result_root", str(tmp_path / "out"),
        "--evaluation_data_root", str(tmp_path / "data"), "--phase", "test"])
    torch.cuda.synchronize()
    assert dense_conv.LAUNCHES - k1 == 44 * 4
    assert warp_sample.LAUNCHES == sampler and block_engine.LAUNCHES == engine
    assert run.frames == len(run.ms) == 4 and run.metrics is None
    clouds = sorted(run.log_root.glob("*.ply"))
    assert len(clouds) == len(list(run.log_root.glob("*.png"))) == 4
    for path in clouds:
        z = plyio.read_ply_vertices(path)["z"]
        assert z.size > 0 and np.isfinite(z).all() and (z >= 0).all(), path.name


# -- K1 as the op endodepth::fused_dense_conv, and the serving export ---------

# bf16 K1 with its chunks split (8 tiles) and in one pass (320 tiles)
OP_SHAPES = [(8, 16, 20, 372, 12), (8, 128, 160, 96, 12)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_through_torch_ops_is_fused_dense_conv(device, dtype):
    for shape in OP_SHAPES:
        args = _inputs(*shape, dtype, device)
        tiling = dense_conv.forward_tiling(dtype, *args[0].shape)
        before = dense_conv.LAUNCHES
        got = torch.ops.endodepth.fused_dense_conv(*args, *tiling)
        assert dense_conv.LAUNCHES == before + 1
        assert torch.equal(got, dense_conv.fused_dense_conv(*args))


def test_cpp_op_library_matches_the_python_op(device, tmp_path):
    """The C++ registration (``csrc/dense_conv_op.cpp``), in a process of
    its own that never imports ``ops/dense_conv.py``, gives the Python
    op's output bitwise at a split and an unsplit shape, and counts its
    launches."""
    import subprocess
    import sys

    from endoscopydepthestimation_pytorch_tpu_torch.ops import _libtorch_build
    cases, want = [], []
    for seed, shape in enumerate(OP_SHAPES):
        args = _inputs(*shape, torch.bfloat16, device, seed=seed)
        tiling = dense_conv.forward_tiling(torch.bfloat16, *args[0].shape)
        assert (tiling[2] > 1) == (seed == 0)
        cases.append(([t.cpu() for t in args], tiling))
        want.append(dense_conv.fused_dense_conv(*args).cpu())
    torch.save(cases, tmp_path / "cases.pt")
    code = ("import ctypes, sys, torch\n"
            "torch.ops.load_library(sys.argv[1])\n"
            "outs = [torch.ops.endodepth.fused_dense_conv(*(t.cuda() for t in args), *tiling)"
            ".cpu() for args, tiling in torch.load(sys.argv[2])]\n"
            "torch.save(outs, sys.argv[3])\n"
            "count = ctypes.CDLL(sys.argv[1]).endodepth_dense_conv_launches\n"
            "count.restype = ctypes.c_int64\n"
            "print(count())\n")
    out = subprocess.run([sys.executable, "-c", code, str(_libtorch_build.op_library()),
                          str(tmp_path / "cases.pt"), str(tmp_path / "outs.pt")],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(OP_SHAPES))]
    for got, ref in zip(torch.load(tmp_path / "outs.pt"), want):
        assert torch.equal(got, ref)


def test_load_exported_runs_k1_on_the_card(device, tmp_path):
    """A bf16 predictor's ``torch.export`` artifact loads on the card and
    launches K1 44 times a forward, agreeing with ``predict_batch``."""
    import numpy as np

    import chip_smoke
    from endoscopydepthestimation_pytorch_tpu_torch import serving
    from endoscopydepthestimation_pytorch_tpu_torch.models import save_reference_checkpoint

    checkpoint = tmp_path / "model.pt"
    save_reference_checkpoint(checkpoint, chip_smoke.seeded_model(0))
    predictor = serving.DepthPredictor(checkpoint, chip_smoke.synthetic_sequence(64, 96),
                                       batch_size=2, downsampling=1.0, dtype=torch.bfloat16)
    predictor.export(tmp_path / "depth.pt2")
    fn = serving.load_exported(tmp_path / "depth.pt2")
    colors = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    before = dense_conv.LAUNCHES
    got = fn(colors)
    torch.cuda.synchronize()
    assert dense_conv.LAUNCHES - before == 44
    assert got.shape == (2, 64, 96, 1) and got.device.type == "cuda"
    want = predictor.predict_batch(colors)
    # the same aten ops and K1 replayed: f32 glue rounding at most
    assert chip_smoke.masked_rel_err(got[..., 0].cpu().numpy(), want, 64, 96) <= 1e-4
