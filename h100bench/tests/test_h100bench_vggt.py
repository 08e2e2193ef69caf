"""The driver that came with VGGT (``train_step_vggt``) and its metrics, on
the CPU at a size a test run holds, through ``run.py``'s code path
(``cli.run_cell``, the look for a card skipped): a sound run is correct,
a state left unchanged is caught, the new readers read 100% at the bound
and what they are handed, the seeded weights cover every tensor, and
VGGT's counts of operations match what PyTorch's FLOP counter sees of the
port's forward.

    python -m pytest h100bench/tests/test_h100bench_vggt.py -q
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from endoscopydepthestimation_pytorch_tpu_torch import training  # noqa: E402
from harness import cli, registry, roofline_vggt  # noqa: E402
from harness.tracing import Trace  # noqa: E402

CPU = torch.device("cpu")
CELL = "vggt-train-b4-420x518"
# VGGT at a tiny width: 4 heads of 16, 2 DINOv2 blocks and 2 frame/global
# pairs, 56x70 frames (4x5 patches)
TINY = dict(builder="VGGTTiny", embed_dim=64, depth=2, num_heads=4, head_dim=16,
            mlp_ratio=4.0, num_register_tokens=4, special_tokens=5,
            intermediate_layer_idx=[0, 0, 1, 1], features=16, out_channels=[8, 16, 32, 32],
            img_size=42, dim_in=128, dtype="float32")
SMALL = dict(batch=2, height=56, width=70, pool=6, trace_steps=1, check_pairs=2)


def tiny_port(n_classes=1, dtype=torch.float32):
    from endoscopydepthestimation_pytorch_tpu_torch.models import vggt
    t = TINY
    return vggt.VGGT(t["embed_dim"], t["depth"], t["num_heads"], t["mlp_ratio"],
                     t["num_register_tokens"], tuple(t["intermediate_layer_idx"]), t["features"],
                     tuple(t["out_channels"]), t["img_size"], dtype=dtype)


@pytest.fixture(autouse=True)
def tiny_builder(monkeypatch):
    from endoscopydepthestimation_pytorch_tpu_torch import models
    monkeypatch.setattr(models, "VGGTTiny", tiny_port, raising=False)


def run(trace: bool = False, seconds: float = 0.5, seed: int = 2**31 + 95) -> dict:
    return cli.run_cell(registry.Benchmark.load(), CELL, seed, seconds, trace, CPU,
                        time.perf_counter(), config_override=TINY, traffic_override=SMALL,
                        say=lambda s: None)


def _context() -> cli.Context:
    bench = registry.Benchmark.load()
    c = bench.cell(CELL)
    return cli.Context(c, {**bench.config(c.config), **TINY},
                       {**bench.traffic(c.traffic), **SMALL}, bench.limits(CELL),
                       2**31 + 7, CPU, say=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_vggt_cell_runs_and_is_correct(trace):
    res = run(trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == ["depth_rel", "first_update", "change"]
    # float32 against the float32 reference: rounding alone
    assert all(c["value"] < 1e-3 for c in res["checks"].values()), res["checks"]
    if trace:  # no device on the CPU: the device readers read nothing
        assert set(res["metrics"]) == {"mfu.train.vggt", "views_per_s.vggt",
                                       "graphed_share.train.vggt"}
    else:
        assert set(res["metrics"]) == {"train_samples_per_s", "peak_memory_gib", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    real = training.train_step

    def unchanged(state, batch, dcl_weight, config, **kw):
        _, metrics = real(copy.deepcopy(state), batch, dcl_weight, config, **kw)
        return state, metrics

    monkeypatch.setattr(training, "train_step", unchanged)
    res = run()
    assert not res["correct"] and res["checks"]["change"]["value"] == pytest.approx(1.0)


def test_the_seeded_weights_cover_every_tensor_and_condition_the_head():
    import math

    from harness.registry import reference_model
    drv = registry.Benchmark.load().driver("train_step_vggt")
    ctx = _context()
    with torch.device("meta"):
        skeleton = reference_model(ctx.config)
    weights = drv.seeded_state_dict(skeleton, 5, CPU)
    assert set(weights) == set(skeleton.state_dict())
    assert "aggregator.camera_token" in dict(skeleton.named_parameters())  # put back
    for name in ("aggregator.camera_token", "aggregator.register_token",
                 "aggregator.patch_embed.register_tokens"):
        assert 0.01 < float(weights[name].std()) < 0.03, name
    bias = weights[f"{drv.HEAD}.bias"]
    assert torch.allclose(bias, torch.full_like(bias, math.log(3.0)))
    assert torch.equal(weights["aggregator.camera_token"],
                       drv.seeded_state_dict(skeleton, 5, CPU)["aggregator.camera_token"])


def test_the_reference_recomputes_the_blocks_and_takes_the_stacked_pair():
    from harness.registry import reference_model
    ctx = _context()
    assert registry.Benchmark.load().config("vggt_1b")["reference_checkpoint_blocks"] is True
    ctx.config["reference_checkpoint_blocks"] = True
    model = reference_model(ctx.config)
    assert model.checkpoint_blocks and model.aggregator.patch_embed.checkpoint_blocks
    drv = registry.Benchmark.load().driver("train_step_vggt")
    x = torch.rand(4, 3, 56, 70)
    batch = {"color_1": x[:2].permute(0, 2, 3, 1), "color_2": x[2:].permute(0, 2, 3, 1),
             "boundary": torch.ones(2, 56, 70, 1)}
    with torch.no_grad():
        want = model(x).permute(0, 2, 3, 1)
    got = drv.reference_depth(model, batch, None, 1)  # a pair a chunk
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_vggt_flops_match_the_flop_counter():
    """``forward_flops``: the ViT's and the aggregator's matmuls and
    attention and every convolution of the head; PyTorch's FLOP counter
    over the port's forward counts the same matmuls and convolutions (2 a
    multiply-add). It has no count for the CPU's fused attention op, so
    attention's 4 N^2 d a sequence and block is added: 4 frames of 25
    tokens in the patch embedder and the frame blocks, 2 sequences of 50 in
    the global blocks, d 64, 2 blocks each."""
    cfg = {**registry.Benchmark.load().config("vggt_1b"), **TINY}
    model = tiny_port()
    x = torch.zeros(4, 3, 56, 70)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, views=2)
    attention = 4 * 64 * 2 * (4 * 25 ** 2 + 4 * 25 ** 2 + 2 * 50 ** 2)
    assert roofline_vggt.forward_flops(cfg, 2, 56, 70) == counter.get_total_flops() + attention


def test_the_published_step_is_about_66_tflop():
    cfg = registry.Benchmark.load().config("vggt_1b")
    assert roofline_vggt.tokens(cfg, 420, 518) == (1115, 1115)
    step = 3 * roofline_vggt.forward_flops(cfg, 4, 420, 518)
    assert 60e12 < step < 72e12, step
    share = roofline_vggt.aggregator_flops(cfg, 4, 420, 518) / (step / 3)
    assert 0.55 < share < 0.7, share  # the alternating blocks' share of the step


def test_vggt_readers_read_100_at_the_bound_and_what_they_are_handed():
    bench = registry.Benchmark.load()
    ctx = _context()
    ctx.config = bench.config("vggt_1b")  # the published shapes
    ctx.traffic = bench.traffic("train-b4-420x518")
    bound = roofline_vggt.step_attention_bound_s(ctx.config, 4, 420, 518, 2)
    ctx.trace = Trace(device=[("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 0.0, bound),
                              ("nvjet_tst_gemm", bound, 3 * bound)], host=[], units=1,
                      wall_s=4 * bound, spans={})
    assert bench.metric_reader("attn_roofline.vggt").read(ctx) == pytest.approx(100.0)
    assert bench.metric_reader("attn_ms_per_step.vggt").read(ctx) == pytest.approx(1e3 * bound)
    assert 12e-3 < bound < 16e-3, bound  # ~14 ms a step
    ctx.window = {"units": 10, "window_s": 2.0, "views": 80}
    mfu = bench.metric_reader("mfu.train.vggt")
    assert mfu.read(ctx) == pytest.approx(100 * 10 * mfu.step_flops(ctx) / (2.0 * 989e12))
    assert bench.metric_reader("views_per_s.vggt").read(ctx) == pytest.approx(40.0)
    ctx.window = {"units": 10, "window_s": 2.0}  # a program without the counter
    assert bench.metric_reader("views_per_s.vggt").read(ctx) is None
