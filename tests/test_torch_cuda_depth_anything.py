"""Depth Anything V2 (``models/depth_anything.py``) on the card, against the
plain reference ``tests/reference_depth_anything.py`` (float32, TF32 off).

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_depth_anything.py
"""
import pytest
import torch

import reference_depth_anything as ref
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import DepthAnythingV2Large, init_weights
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                          sgd_update, warp_sample)

pytestmark = pytest.mark.cuda

ROWS, COLS = 37, 46  # a 518x644 input's patches
N = ROWS * COLS + 1
FUSED_OPS = ("aten::_scaled_dot_product_flash_attention",
             "aten::_scaled_dot_product_cudnn_attention")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().float(), want.detach()
    return float((got - want).abs().mean() / want.abs().mean())


def _ops(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


def test_attention_runs_a_fused_kernel_and_never_the_math_path(device):
    block = init_weights(dav2.Block(1024, 16, 4.0, 1.0), torch.Generator().manual_seed(0))
    block = block.to(device)
    encoder = dav2.DinoVisionTransformer(518, 1024, 1, 16).to(device)
    encoder.blocks[0] = block

    def step():
        out = encoder(torch.randn(2, 3, 518, 644, device=device, dtype=torch.bfloat16), [0])
        out[0].float().square().mean().backward()

    ops = _ops(step)
    assert any(op in ops for op in FUSED_OPS), sorted(ops)
    assert "aten::_scaled_dot_product_attention_math" not in ops
    # a call no fused kernel takes raises instead of falling back: float32
    with pytest.raises(RuntimeError):
        encoder(torch.randn(1, 3, 518, 644, device=device), [0])


def test_one_full_width_block_matches_the_reference(device):
    port = init_weights(dav2.Block(1024, 16, 4.0, 1.0), torch.Generator().manual_seed(1))
    with torch.no_grad():  # LayerScale and the norms off their identity values
        for m in port.modules():
            if isinstance(m, dav2.LayerScale):
                m.gamma.uniform_(0.5, 1.5)
    want_block = ref.Block(1024, 16, 4.0)
    want_block.load_state_dict(port.state_dict(), strict=True)
    port, want_block = port.to(device), want_block.to(device)
    x = torch.randn(2, N, 1024, device=device, generator=torch.Generator(device).manual_seed(2))
    xb = x.to(torch.bfloat16).requires_grad_()
    xf = x.to(torch.bfloat16).float().requires_grad_()
    got = port(xb)
    want = want_block(xf, None)
    g = torch.randn_like(want)
    got.float().backward(g)
    want.backward(g)
    # bfloat16 activations (2^-9 relative a rounding) through two matmuls,
    # attention over 1,703 tokens and the MLP: under 1% of the output and of
    # the input's gradient; float8 would be tens of percent
    assert _rel(got, want) < 1e-2, _rel(got, want)
    assert _rel(xb.grad, xf.grad) < 2e-2, _rel(xb.grad, xf.grad)


def test_the_full_head_matches_the_reference(device):
    port = init_weights(dav2.DPTHead(1024, 256, (256, 512, 1024, 1024)),
                        torch.Generator().manual_seed(3))
    with torch.no_grad():
        port.scratch.output_conv2[2].bias.fill_(3.0)  # depth away from the ReLU's kink
    want_head = ref.Head(1024, 256, (256, 512, 1024, 1024))
    want_head.load_state_dict(port.state_dict(), strict=True)
    port, want_head = port.to(device), want_head.to(device)
    gen = torch.Generator(device).manual_seed(4)
    feats = [torch.randn(2, ROWS * COLS, 1024, device=device, generator=gen)
             for _ in range(4)]
    with torch.no_grad():
        got = port([f.to(torch.bfloat16) for f in feats], ROWS, COLS)
        want = want_head([f.to(torch.bfloat16).float() for f in feats], ROWS, COLS, None)
    assert got.shape == want.shape == (2, 1, 518, 644)
    # bfloat16 (2^-9 relative a rounding) through the head's 17 convolutions,
    # two transposed convs, 7 residual sums and 5 resizes, at a raw Kaiming
    # init whose activations grow to ~20 and a bfloat16 output: 2.1e-2 on
    # an H100, twice that as the limit
    assert _rel(got, want) < 4e-2, _rel(got, want)


def test_the_train_step_takes_the_model_path(device):
    model = init_weights(DepthAnythingV2Large(dtype=torch.bfloat16),
                         torch.Generator().manual_seed(5)).to(device)
    with torch.no_grad():
        model.depth_head.scratch.output_conv2[2].weight.mul_(0.1)
        model.depth_head.scratch.output_conv2[2].bias.fill_(3.0)
    state = training.create_train_state(model)
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    h, w = 518, 644
    gen = torch.Generator(device).manual_seed(6)
    batch = {"color_1": torch.rand(1, h, w, 3, device=device, generator=gen) * 2 - 1,
             "color_2": torch.rand(1, h, w, 3, device=device, generator=gen) * 2 - 1}
    mask = torch.zeros(1, h, w, 1, device=device)
    mask[:, h // 8:-h // 8, w // 8:-w // 8] = 1
    sparse = torch.zeros(1, h, w, 1, device=device)
    sparse[:, h // 5:-h // 5:4, w // 5:-w // 5:4] = 1
    k = torch.tensor([[[80.0 * w / 64, 0, w / 2], [0, 80.0 * w / 64, h / 2], [0, 0, 1]]],
                     device=device)
    t = torch.tensor([[[0.0], [0.0], [0.02]]], device=device)
    eye = torch.eye(3, device=device)[None]
    batch.update(sparse_depth_1=sparse, sparse_depth_2=sparse, depth_mask_1=sparse,
                 depth_mask_2=sparse, flow_1=torch.zeros(1, h, w, 2, device=device),
                 flow_2=torch.zeros(1, h, w, 2, device=device), flow_mask_1=sparse,
                 flow_mask_2=sparse, boundary=mask, rotation_1_wrt_2=eye,
                 rotation_2_wrt_1=eye, translation_1_wrt_2=t, translation_2_wrt_1=-t,
                 intrinsic=k)
    before = (dense_conv.LAUNCHES, dict(warp_sample.LAUNCHES), dict(block_engine.LAUNCHES),
              sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED,
              dav2.LAUNCHES["attention"])
    _, metrics = training.train_step(state, batch, torch.tensor(5.0, device=device), config)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and int(state.step) == 1
    assert dense_conv.LAUNCHES == before[0]
    assert {k: v - before[1][k] for k, v in warp_sample.LAUNCHES.items()} == {
        "warp_sample_fwd": 1, "warp_sample_bwd": 1}
    assert block_engine.LAUNCHES == before[2]
    # 402 tensors, 334 M elements: one C call of the optimizer, nothing restrided
    assert len(state.params) == 402 and sum(p.numel() for p in state.params) < 2**30
    assert sgd_update.LAUNCHES["sgd_update"] == before[3] + 1
    assert sgd_update.RESTRIDED == before[4]
    assert dav2.LAUNCHES["attention"] == before[5] + 24
