"""The dense-layer CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet57
from endoscopydepthestimation_pytorch_tpu_torch.models.init import init_weights
from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv

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
    with pytest.raises(NotImplementedError):  # no backward yet
        dense_conv.fused_dense_conv(x.requires_grad_(), scale, shift, wk)


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
