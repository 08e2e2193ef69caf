"""Depth Pro (``models/depth_pro.py``) on the card, against the plain
reference ``tests/reference_depth_pro.py`` (float32, TF32 off).

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_depth_pro.py
"""
import pytest
import torch

import reference_depth_pro as ref
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.models import DepthProLarge, init_weights
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_pro as dp
from endoscopydepthestimation_pytorch_tpu_torch.ops import (block_engine, dense_conv,
                                                          sgd_update, warp_sample)

pytestmark = pytest.mark.cuda

FUSED_OPS = ("aten::_scaled_dot_product_flash_attention",
             "aten::_scaled_dot_product_cudnn_attention")
DIMS = (256, 512, 1024, 1024)
SIDES = (768, 384, 192, 96, 48)  # the decoder's inputs at 1536x1536


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


def test_the_patch_encoder_runs_fused_attention_over_every_tile(device):
    """One full-width block at patch 16 over the 70 tiles of a pair: the
    fused kernel, never the math path; the normed output and the raw tap
    at the stored 24x24 grid."""
    encoder = init_weights(dav2.DinoVisionTransformer(384, 1024, 1, 16, patch=16),
                           torch.Generator().manual_seed(0)).to(device)
    tiles = torch.randn(70, 3, 384, 384, device=device, dtype=torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        normed, raw = encoder(tiles, (0,), (0,))
        (normed.float().square().mean() + raw.float().square().mean()).backward()
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert any(op in ops for op in FUSED_OPS), sorted(ops)
    assert "aten::_scaled_dot_product_attention_math" not in ops
    assert normed.shape == raw.shape == (70, 576, 1024)
    assert not torch.equal(normed, raw)


def test_the_full_width_decoder_and_head_match_the_reference(device):
    port = dp.DepthPro(depth=1)  # the decoder and head at full width
    init_weights(port, torch.Generator().manual_seed(3))
    with torch.no_grad():
        port.head[4].bias.fill_(3.0)  # depth away from the ReLU's kink
    want_dec, want_head = ref.Decoder([256, *DIMS], 256), ref.DepthPro(
        1024, 1, 16, 4.0, 384, 16, DIMS, 256, (0,)).head
    want_dec.load_state_dict(port.decoder.state_dict(), strict=True)
    want_head.load_state_dict(port.head.state_dict(), strict=True)
    port, want_dec, want_head = port.to(device), want_dec.to(device), want_head.to(device)
    gen = torch.Generator(device).manual_seed(4)
    feats = [torch.randn(1, c, s, s, device=device, generator=gen)
             for c, s in zip((256, *DIMS), SIDES)]
    with torch.no_grad():
        low = [f.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for f in feats]
        f = port.decoder(low)
        h = port.head
        y = torch.relu(dav2._conv(dav2._conv(dav2._conv(f, h[0]), h[1]), h[2]))
        got = torch.relu(dav2._conv(y.float(), h[4]))
        wf = want_dec([x.float() for x in low], None)
        y = ref._conv(want_head[1], ref._conv(want_head[0], wf, None), None)
        want = torch.relu(ref._conv(want_head[4], torch.relu(ref._conv(want_head[2], y, None)),
                                    None))
    assert got.shape == want.shape == (1, 1, 1536, 1536)
    # bfloat16 (2^-9 relative a rounding) through 4 decoder convs, 9
    # residual blocks, 4 transposed convs, 5 fusions and the head, at a
    # raw Kaiming init: as Depth Anything V2's head test, under 4e-2
    assert _rel(got, want) < 4e-2, _rel(got, want)


def test_the_train_step_takes_the_model_path(device):
    model = init_weights(DepthProLarge(dtype=torch.bfloat16),
                         torch.Generator().manual_seed(5)).to(device)
    with torch.no_grad():
        model.head[4].weight.mul_(0.1)
        model.head[4].bias.fill_(3.0)
    state = training.create_train_state(model)
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    h = w = 1536
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
              dav2.LAUNCHES["attention"], dp.LAUNCHES["tiles"])
    _, metrics = training.train_step(state, batch, torch.tensor(5.0, device=device), config)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and int(state.step) == 1
    assert dense_conv.LAUNCHES == before[0]
    assert {k: v - before[1][k] for k, v in warp_sample.LAUNCHES.items()} == {
        "warp_sample_fwd": 1, "warp_sample_bwd": 1}
    assert block_engine.LAUNCHES == before[2]
    # 763 tensors, 647 M elements: one C call of the optimizer, nothing restrided
    assert len(state.params) == 763 and sum(p.numel() for p in state.params) < 2**30
    assert sgd_update.LAUNCHES["sgd_update"] == before[3] + 1
    assert sgd_update.RESTRIDED == before[4]
    # the patch encoder's one call over the pair's 70 tiles and the image
    # encoder's, a block each
    assert dav2.LAUNCHES["attention"] == before[5] + 48
    assert dp.LAUNCHES["tiles"] == before[6] + 70
