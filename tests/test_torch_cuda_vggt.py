"""VGGT (``models/vggt.py``) on the card: its attention in the fused
kernels at a frame's 1,115 tokens and a pair's 2,230, a full-width cut of
it against the plain reference ``tests/reference_vggt.py`` (float32, TF32
off), a replayed train step against eager ones and the counters it
advances, and the spans against the counters.

Marked ``cuda``: needs a CUDA device, and skips without one (decided in a
fixture, so every worker collects the same tests). Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_vggt.py
"""
import copy
import math

import pytest
import torch

import chip_smoke
import reference_vggt as ref
from endoscopydepthestimation_pytorch_tpu_torch import step_graph, training
from endoscopydepthestimation_pytorch_tpu_torch.models import init_weights
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.models import vggt
from endoscopydepthestimation_pytorch_tpu_torch.ops import sgd_update
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

FUSED_OPS = ("aten::_scaled_dot_product_flash_attention",
             "aten::_scaled_dot_product_cudnn_attention")
BF16 = training.TrainConfig(lr_step_size=4, compute_dtype=torch.bfloat16)
H, W = 420, 518  # 30x37 patches, 1,115 tokens a frame


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class Eager(step_graph.CudaGraphs):
    def engages(self, device):
        return False


def _four_pairs(dtype=torch.bfloat16) -> vggt.VGGT:
    """VGGT-1B at full width cut to 4 DINOv2 blocks and 4 frame/global
    pairs, the head reading each pair; depth = 3 exp(0.1 conv), LayerScale
    1 (the init's 0.01 leaves the aggregator nearly silent)."""
    model = init_weights(vggt.VGGT(depth=4, layer_idx=(0, 1, 2, 3), dtype=dtype),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        head = model.depth_head.scratch.output_conv2[2]
        head.weight.mul_(0.1)
        head.bias.fill_(math.log(3.0))
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(1.0)
    return model


@pytest.mark.parametrize("views,batch", [(1, 8), (2, 4)])
def test_attention_runs_a_fused_kernel_at_a_frame_and_a_pair(device, views, batch):
    """A full-width aggregator block with QK-norm and RoPE over 8 frames of
    1,115 tokens (frame-wise) and over 4 sequences of 2,230 (global): the
    fused kernel forward and backward, never the math path."""
    block = init_weights(dav2.Block(1024, 16, 4.0, 0.01, qk_norm=True, eps=1e-5),
                         torch.Generator().manual_seed(1)).to(device)
    rope = tuple(t.to(device, torch.bfloat16).repeat(views, 1)
                 for t in vggt.rope_tables(30, 37, 5, 64))
    x = torch.randn(batch, views * 1115, 1024, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.nn.attention.sdpa_kernel(dav2.FUSED_ATTENTION):
            out = block(x, rope)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert any(op in ops for op in FUSED_OPS), sorted(ops)
    assert "aten::_scaled_dot_product_attention_math" not in ops
    assert torch.isfinite(x.grad).all()


def test_a_full_width_cut_matches_the_reference(device):
    port = _four_pairs(torch.float32)
    want = ref.VGGT(1024, 4, 16, 4.0, 4, (0, 1, 2, 3), 256, (256, 512, 1024, 1024), 518)
    want.load_state_dict(port.state_dict(), strict=True)
    low = _four_pairs()
    low.load_state_dict(port.state_dict())
    low, want = low.to(device), want.to(device)
    x = torch.rand(4, 3, H, W, device=device, generator=torch.Generator(device).manual_seed(2))
    with torch.no_grad():
        got, expect = low(x * 2 - 1, views=2), want(x * 2 - 1)
    # bfloat16 (2^-9 relative a rounding) through 4 + 8 blocks and the head:
    # within a few percent of the depth's spread over a frame about its level
    gap = float((got - expect).abs().mean() / (expect - expect.mean()).abs().mean())
    assert got.shape == (4, 1, H, W) and gap < 0.1, gap


def _batches(device, n):
    return [chip_smoke.synthetic_batch(1, H, W, seed, device) for seed in range(1, n + 1)]


def test_a_replay_is_within_eager_spread_and_advances_the_counters(device, monkeypatch):
    """Attention's backward and the bilinear resizes' sum with atomics, so
    from one state a replay's loss terms equal an eager step's bit for bit
    and its update lies as near an eager step's as a second eager step's,
    or within 0.1% of the update's norm; a replay advances ``vggt.LAUNCHES``
    by one step's counts."""
    graphed = training.create_train_state(_four_pairs().to(device))
    batches = _batches(device, 3)
    dcl = torch.tensor(0.1, device=device)
    for batch in batches[:2]:  # eager, then the capture and its replay
        training.train_step(graphed, batch, dcl, BF16)
    torch.cuda.synchronize()
    eager = []
    for _ in range(2):
        state = training.create_train_state(copy.deepcopy(graphed.model))
        with torch.no_grad():
            for a, b in zip([*state.momentum, state.count, state.step],
                            [*graphed.momentum, graphed.count, graphed.step]):
                a.copy_(b)
        eager.append(state)
    start = [p.detach().clone() for p in graphed.params]
    before, counts = dict(step_graph.GRAPHED), dict(vggt.LAUNCHES)
    _, got = training.train_step(graphed, batches[2], dcl, BF16)
    assert step_graph.GRAPHED["replays"] == before["replays"] + 1
    assert {k: v - counts[k] for k, v in vggt.LAUNCHES.items()} == {
        "frame_attention": 4, "global_attention": 4, "views": 2}
    with monkeypatch.context() as m:
        m.setattr(step_graph, "BACKEND", Eager())
        want = [training.train_step(state, batches[2], dcl, BF16)[1] for state in eager]
    torch.cuda.synchronize()
    for k in ("loss", "sparse_flow_loss", "depth_consistency_loss", "scale_std"):
        assert torch.equal(got[k], want[0][k]) and torch.equal(want[1][k], want[0][k]), k

    def update(state):
        return torch.cat([(p.detach() - s).flatten() for p, s in zip(state.params, start)])

    graph_update, first, second = update(graphed), update(eager[0]), update(eager[1])
    gap, spread = (graph_update - first).norm(), (second - first).norm()
    print(f"update norm {float(first.norm()):.6e}: replay - eager {float(gap):.6e}, "
          f"eager - eager {float(spread):.6e}")
    assert gap <= 2 * spread + 1e-3 * first.norm()


def test_the_spans_equal_the_counters_on_an_eager_step(device, monkeypatch):
    state = training.create_train_state(_four_pairs().to(device))
    batch = _batches(device, 1)[0]
    counts, calls = dict(vggt.LAUNCHES), dav2.LAUNCHES["attention"]
    restrided = sgd_update.RESTRIDED
    with monkeypatch.context() as m:
        m.setattr(step_graph, "BACKEND", Eager())
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            training.train_step(state, batch, torch.tensor(5.0, device=device), BF16)
            torch.cuda.synchronize()
    advanced = {k: v - counts[k] for k, v in vggt.LAUNCHES.items()}
    records = profiling.sessions()[-1].records
    unit = max(r.unit for r in records)
    spans = [(r.name, r.parent) for r in records if r.unit == unit]
    # one forward: one of each span under forward, the counters one
    # forward's (a frame and a global call a pair of blocks, both frames)
    for name in ("patch_embed", "aggregator", "depth_head"):
        assert spans.count((name, "forward")) == 1, (name, spans)
    assert advanced == {"frame_attention": 4, "global_attention": 4, "views": 2}
    assert dav2.LAUNCHES["attention"] - calls == 4
    assert sgd_update.RESTRIDED == restrided  # every gradient in its parameter's layout
