"""The two drivers that came with Depth Pro (``train_step_depth_pro``) and the
act8 train cell (``train_step_act8``), and their metrics, on the CPU at a
size a test run holds, through ``run.py``'s code path (``cli.run_cell``,
the look for a card skipped): sound runs are correct, a state left
unchanged is caught, the new readers read 100% at the bound and what they
are handed, and Depth Pro's counts of operations match what PyTorch's
FLOP counter sees of the port's forward.

    python -m pytest h100bench/tests -q
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
from harness import cli, registry, roofline_depth_pro  # noqa: E402
from harness.tracing import Trace  # noqa: E402

CPU = torch.device("cpu")
DPRO = "dpro-train-b1-1536x1536"
ACT8 = "fcdn57-train-act8-b8-256x320"
# Depth Pro with the published token arithmetic at a tiny width: 128-pixel
# tiles of a 512-pixel frame at patch 16 (8x8 tokens a tile, 35 tiles,
# merged grids 32, 16, 8)
TINY = dict(builder="DepthProTiny", embed_dim=32, depth=3, num_heads=2, head_dim=16,
            mlp_ratio=4.0, tile_size=128, patch_size=16, img_size=512,
            dims_encoder=[8, 8, 16, 16], decoder_features=8, hook_block_ids=[0, 1],
            merged_grids=[32, 16, 8], dtype="float32")
SMALL = {DPRO: (TINY, dict(batch=1, height=512, width=512, pool=6, trace_steps=1)),
         ACT8: (dict(dtype="float32"), dict(batch=2, height=64, width=64, pool=4,
                                            trace_steps=1))}


def tiny_port(n_classes=1, dtype=torch.float32):
    from endoscopydepthestimation_pytorch_tpu_torch.models import depth_pro
    t = TINY
    return depth_pro.DepthPro(t["embed_dim"], t["depth"], t["num_heads"], t["mlp_ratio"],
                              t["tile_size"], t["patch_size"], tuple(t["dims_encoder"]),
                              t["decoder_features"], tuple(t["hook_block_ids"]), dtype=dtype)


@pytest.fixture(autouse=True)
def tiny_builder(monkeypatch):
    from endoscopydepthestimation_pytorch_tpu_torch import models
    monkeypatch.setattr(models, "DepthProTiny", tiny_port, raising=False)


def run(cell: str, trace: bool = False, seconds: float = 0.5, seed: int = 2**31 + 93) -> dict:
    config, traffic = SMALL[cell]
    return cli.run_cell(registry.Benchmark.load(), cell, seed, seconds, trace, CPU,
                        time.perf_counter(), config_override=config,
                        traffic_override=traffic, say=lambda s: None)


def _context(cell: str) -> cli.Context:
    bench = registry.Benchmark.load()
    config, traffic = SMALL[cell]
    c = bench.cell(cell)
    return cli.Context(c, {**bench.config(c.config), **config},
                       {**bench.traffic(c.traffic), **traffic}, bench.limits(cell),
                       2**31 + 7, CPU, say=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_dpro_cell_runs_and_is_correct(trace):
    res = run(DPRO, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == ["depth_rel", "first_update", "change"]
    # float32 against the float32 reference: rounding alone
    assert all(c["value"] < 1e-3 for c in res["checks"].values()), res["checks"]
    if trace:  # no device on the CPU: the device readers read nothing
        assert set(res["metrics"]) == {"mfu.train.dpro", "tiles_per_s.dpro"}
    else:
        assert set(res["metrics"]) == {"train_samples_per_s", "peak_memory_gib", "setup_s"}


def _unchanged(monkeypatch):
    real = training.train_step

    def unchanged(state, batch, dcl_weight, config, **kw):
        _, metrics = real(copy.deepcopy(state), batch, dcl_weight, config, **kw)
        return state, metrics

    monkeypatch.setattr(training, "train_step", unchanged)


@pytest.mark.parametrize("cell", [DPRO, ACT8])
def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch, cell):
    _unchanged(monkeypatch)
    res = run(cell)
    assert not res["correct"] and res["checks"]["change"]["value"] == pytest.approx(1.0)


def test_the_act8_cell_runs_and_is_correct():
    res = run(ACT8)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(registry.Benchmark.load().limits(ACT8))
    assert set(res["metrics"]) == {"peak_memory_gib", "setup_s"}
    traced = run(ACT8, trace=True)
    assert set(traced["metrics"]) == {"train_samples_per_s.act8"}


def test_the_act8_driver_builds_the_act8_network():
    from endoscopydepthestimation_pytorch_tpu_torch.ops import act8
    ctx = _context(ACT8)
    drv = registry.Benchmark.load().driver("train_step_act8").Driver(ctx)
    drv.setup()
    blocks = [m for m in drv.state.model.modules() if hasattr(m, "store")]
    assert blocks and all(m.store == "act8" for m in blocks)
    assert act8.BWD_MODE == "replay"


def test_the_reference_recomputes_the_vit_blocks_in_its_check():
    from harness.registry import reference_model
    ctx = _context(DPRO)
    assert ctx.config["reference_checkpoint_blocks"] is True
    assert reference_model(ctx.config).checkpoint_blocks is True


def test_depth_pro_flops_match_the_flop_counter():
    """``forward_flops``: the ViTs' matmuls and attention and every
    convolution; PyTorch's FLOP counter over the port's forward counts the
    same matmuls and convolutions (2 a multiply-add). It has no count for
    the CPU's fused attention op, so attention's 4 N^2 d a sequence and
    block (70 + 2 sequences of 65 tokens, d 32, 3 blocks) is added."""
    cfg = {**registry.Benchmark.load().config("depth_pro"), **TINY}
    model = tiny_port()
    x = torch.zeros(2, 3, 512, 512)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    attention = 4 * 65 ** 2 * 32 * 72 * 3
    assert roofline_depth_pro.forward_flops(cfg, 2) == counter.get_total_flops() + attention


def test_the_published_step_is_about_113_tflop():
    cfg = registry.Benchmark.load().config("depth_pro")
    assert roofline_depth_pro.sequences(cfg, 2) == (70, 2)
    step = 3 * roofline_depth_pro.forward_flops(cfg, 2)
    assert 110e12 < step < 116e12, step


def test_dpro_readers_read_100_at_the_bound_and_what_they_are_handed():
    bench = registry.Benchmark.load()
    ctx = _context(DPRO)
    ctx.config = bench.config("depth_pro")  # the published shapes
    ctx.traffic = bench.traffic("train-b1-1536x1536")
    bound = roofline_depth_pro.step_attention_bound_s(ctx.config, 2, 2)
    ctx.trace = Trace(device=[("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 0.0, bound),
                              ("nvjet_tst_gemm", bound, 3 * bound)], host=[], units=1,
                      wall_s=4 * bound, spans={})
    assert bench.metric_reader("attn_roofline.dpro").read(ctx) == pytest.approx(100.0)
    assert bench.metric_reader("attn_ms_per_step.dpro").read(ctx) == pytest.approx(1e3 * bound)
    assert 8e-3 < bound < 9e-3  # 8.4 ms a step at N = 577
    ctx.window = {"units": 10, "window_s": 2.0, "tiles": 700}
    mfu = bench.metric_reader("mfu.train.dpro")
    assert mfu.read(ctx) == pytest.approx(100 * 10 * mfu.step_flops(ctx) / (2.0 * 989e12))
    assert bench.metric_reader("tiles_per_s.dpro").read(ctx) == pytest.approx(350.0)
    ctx.window = {"units": 10, "window_s": 2.0}  # a program without the counter
    assert bench.metric_reader("tiles_per_s.dpro").read(ctx) is None
