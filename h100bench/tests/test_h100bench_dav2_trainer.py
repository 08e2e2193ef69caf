"""The two drivers that came with Depth Anything V2 (``train_step_dpt``) and
the whole trainer (``trainer_cli``), and their metrics, on the CPU at a
size a test run holds, through ``run.py``'s code path (``cli.run_cell``,
the look for a card skipped): sound runs are correct, a state left
unchanged and the float8 control are caught, the new readers read 100%
at the bound and the span time they are handed, and the attention and
head counts match a hand count.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from endoscopydepthestimation_pytorch_tpu_torch import training  # noqa: E402
from endoscopydepthestimation_pytorch_tpu_torch.utils.profiling import (  # noqa: E402
    Session, SpanRecord)
from harness import cli, registry, roofline, roofline_attention  # noqa: E402
from harness.tracing import Trace  # noqa: E402

CPU = torch.device("cpu")
DAV2 = "dav2l-train-b8-518x644"
TRAINER = "fcdn57-trainer-b8-256x320"
TINY = dict(builder="DepthAnythingV2Tiny", embed_dim=64, depth=4, num_heads=4, head_dim=16,
            mlp_ratio=4.0, layer_idx=[0, 1, 2, 3], features=16, out_channels=[8, 16, 32, 32],
            img_size=42, dtype="float32")
SMALL = {DAV2: (TINY, dict(batch=2, height=56, width=70, pool=4, trace_steps=1,
                           check_pairs=1)),
         # FC-DenseNet-57 whole at 64x64 b2 from one 256x256 sequence
         TRAINER: (dict(dtype="float32"), dict(batch=2, height=64, width=64,
                                               adjacent_range=[1, 3], sequences=1, frames=8,
                                               raw_height=256, raw_width=256, points=300,
                                               num_workers=2, num_pre_workers=1,
                                               time_steps=2, trace_steps=1))}


@pytest.fixture(autouse=True)
def tiny_builder(monkeypatch):
    """The port's builder that ``TINY`` names: Depth Anything V2 at its
    sizes."""
    from endoscopydepthestimation_pytorch_tpu_torch import models
    sizes = {k: TINY[k] for k in ("embed_dim", "depth", "num_heads", "mlp_ratio", "layer_idx",
                                  "features", "out_channels", "img_size")}
    monkeypatch.setattr(models, "DepthAnythingV2Tiny", lambda n_classes, dtype:
                        models.DepthAnythingV2(**sizes, dtype=dtype), raising=False)


def run(cell: str, tmp_path: Path, trace: bool = False, seconds: float = 0.5,
        seed: int = 2**31 + 91) -> dict:
    config, traffic = SMALL[cell]
    if cell == TRAINER:
        traffic = {**traffic, "root": str(tmp_path)}
    return cli.run_cell(registry.Benchmark.load(), cell, seed, seconds, trace, CPU,
                        time.perf_counter(), config_override=config,
                        traffic_override=traffic, say=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_dav2_cell_runs_and_is_correct(tmp_path, trace):
    res = run(DAV2, tmp_path, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == ["depth_rel", "first_update", "change"]
    # float32 against the chunked float32 reference: rounding alone
    assert all(c["value"] < 1e-3 for c in res["checks"].values()), res["checks"]
    if not trace:
        assert set(res["metrics"]) == {"train_samples_per_s", "peak_memory_gib", "setup_s"}


def test_a_dav2_step_that_leaves_the_state_unchanged_is_caught(tmp_path, monkeypatch):
    real = training.train_step

    def unchanged(state, batch, dcl_weight, config, **kw):
        import copy
        _, metrics = real(copy.deepcopy(state), batch, dcl_weight, config, **kw)
        return state, metrics

    monkeypatch.setattr(training, "train_step", unchanged)
    res = run(DAV2, tmp_path)
    assert not res["correct"] and res["checks"]["change"]["value"] == pytest.approx(1.0)


def test_the_chunked_reference_is_the_whole_batch_reference(tmp_path):
    """Chunks of pairs with their gradients added give the whole batch's
    step: the loss is a mean over pairs and no layer couples rows."""
    bench = registry.Benchmark.load()
    config, traffic = SMALL[DAV2]
    cell = bench.cell(DAV2)
    ctx = cli.Context(cell, {**bench.config(cell.config), **config},
                      {**bench.traffic(cell.traffic), **traffic}, bench.limits(DAV2),
                      2**31 + 3, CPU, say=lambda s: None)
    drv = bench.driver("train_step_dpt").Driver(ctx)
    drv.setup()
    drv.release()
    one = drv.reference_readings()
    drv.traffic = {**drv.traffic, "check_pairs": traffic["batch"]}
    whole = drv.reference_readings()
    assert one["losses"] == pytest.approx(whole["losses"], rel=1e-5)
    for name, value in whole["first_update"].items():
        assert one["first_update"][name] == pytest.approx(value, rel=1e-4, abs=1e-9), name
    checks = bench.driver("train_step_dpt").compare(
        drv.reference_readings(quant=__import__("reference.fcdensenet").fcdensenet.fp8_round),
        one, ctx.limits)[0]
    # the control: Q, K, V and every matmul's and convolution's input in
    # float8 e4m3 fail at least one limit
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]


def test_the_trainer_cell_runs_train_main_and_is_correct(tmp_path, monkeypatch):
    from endoscopydepthestimation_pytorch_tpu_torch import train
    seen = []
    real = training.train_step

    def recording(state, batch, *args, **kw):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(state, batch, *args, **kw)

    monkeypatch.setattr(training, "train_step", recording)
    validated = []
    real_eval = training.eval_step

    def recording_eval(state, batch, *args, **kw):
        validated.append({k: v.clone() for k, v in batch.items()})
        return real_eval(state, batch, *args, **kw)

    monkeypatch.setattr(training, "eval_step", recording_eval)
    calls = []
    main = train.main
    monkeypatch.setattr(train, "main", lambda argv: calls.append(argv) or main(argv))
    bench = registry.Benchmark.load()
    config, traffic = SMALL[TRAINER]
    cell = bench.cell(TRAINER)
    ctx = cli.Context(cell, {**bench.config(cell.config), **config},
                      {**bench.traffic(cell.traffic), **traffic, "root": str(tmp_path)},
                      bench.limits(TRAINER), 2**31 + 5, CPU, say=lambda s: None)
    drv = bench.driver("trainer_cli").Driver(ctx)
    drv.setup()
    # the check's batches rebuilt from SEED are the ones the first call trained on
    rebuilt = drv.batches()
    assert len(rebuilt) == 3 and len(drv.program["losses"]) == 3
    for got, want in zip(seen[:3], rebuilt):
        assert set(want) <= set(got)
        assert all(torch.equal(got[k], want[k]) for k in want)
    validated.clear()
    window = drv.window(0.5)
    assert window["units"] >= 2 and window["failed"] == 0
    assert "--log_interval" in calls[0] and "--load_trained_model" in calls[-1]
    # the validation batches rebuilt are the ones the window's call validated on
    rebuilt = drv.validation_batches()
    assert len(rebuilt) == len(validated) > 0
    for got, want in zip(validated, rebuilt):
        assert set(want) <= set(got)
        assert all(torch.equal(got[k], want[k]) for k in want)
    drv.release()
    checks = drv.check()
    assert all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
    # the window's validation SFL is the one its checkpoint records
    assert drv.program["validation_sfl"] == pytest.approx(
        float(str(drv.window_checkpoint).rsplit("_", 1)[1].removesuffix(".pt")))
    assert not (tmp_path / drv.root.name).exists()  # the data root is gone


def test_the_trainer_cell_through_run_cell(tmp_path):
    res = run(TRAINER, tmp_path)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"peak_memory_gib", "setup_s"}
    assert list(res["checks"]) == ["loss", "change", "bn_stats_change", "validation_sfl"]


def test_attention_counts_match_a_hand_count():
    # one call at 2 images, 3 heads, 5 tokens of 4, bf16
    counts = roofline_attention.attention_counts(2, 3, 5, 4, 2)
    assert counts["fwd"][1] == 4 * 2 * 3 * 5 * 5 * 4 == 2400  # QK^T and PV
    assert counts["bwd"][1] == 10 * 2 * 3 * 5 * 5 * 4
    rows = 2 * 3 * 5
    assert counts["fwd"][0] == 2 * 4 * rows * 4 + 4 * rows  # Q, K, V, O; the lse
    assert counts["bwd"][0] == 2 * 8 * rows * 4 + 4 * rows  # Q K V O dO in, dQ dK dV out
    cfg = registry.Benchmark.load().config("depth_anything_v2_vitl")
    assert roofline_attention.tokens(cfg, 518, 644) == 37 * 46 + 1 == 1703
    # the step: 24 blocks, a forward and a backward each, at 2B = 16
    n, d = 1703, 64
    one = (4 + 10) * 16 * 16 * n * n * d / 989e12  # compute-bound at this shape
    assert roofline_attention.step_attention_bound_s(cfg, 16, 518, 644, 2) == \
        pytest.approx(24 * one)


def test_encoder_and_head_flops_match_a_hand_count():
    cfg = dict(patch_size=14, embed_dim=8, depth=2, mlp_ratio=4.0, features=4,
               out_channels=[2, 2, 4, 4])
    r, q = 2, 3  # a 28x42 input
    n = r * q + 1
    embed = 2 * r * q * 3 * 14 * 14 * 8
    block = 2 * n * 8 * (24 + 8 + 64) + 4 * n * n * 8
    assert roofline_attention.encoder_flops(cfg, 1, 28, 42) == embed + 2 * block
    projects = 2 * r * q * 8 * (2 + 2 + 4 + 4)
    resize = 2 * r * q * 2 * 2 * 16 + 2 * r * q * 2 * 2 * 4 + 2 * (1 * 2) * 4 * 4 * 9
    rn = 2 * 9 * 4 * (8 * 12 * 2 + 4 * 6 * 2 + 2 * 3 * 4 + 1 * 2 * 4)
    fusion = (2 * 2 * 9 * 16 * (1 * 2) + 2 * 16 * (2 * 3)                # refinenet4: 1 unit
              + 4 * 2 * 9 * 16 * (2 * 3) + 2 * 16 * (4 * 6)               # refinenet3
              + 4 * 2 * 9 * 16 * (4 * 6) + 2 * 16 * (8 * 12)              # refinenet2
              + 4 * 2 * 9 * 16 * (8 * 12) + 2 * 16 * (16 * 24))            # refinenet1
    out = 2 * 9 * 4 * 2 * (16 * 24) + 2 * 9 * 2 * 32 * (28 * 42) + 2 * 32 * (28 * 42)
    assert roofline_attention.head_flops(cfg, 1, 28, 42) == projects + resize + rn + fusion + out


def _ctx(cell):
    bench = registry.Benchmark.load()
    c = bench.cell(cell)
    return cli.Context(c, bench.config(c.config), bench.traffic(c.traffic), {}, 1, CPU), bench


def test_dav2_readers_read_100_at_the_bound_and_what_they_are_handed(monkeypatch):
    ctx, bench = _ctx(DAV2)
    attn = bench.metric_reader("attn_roofline.dav2l")
    bound = attn.step_bound_s(ctx)
    ctx.trace = Trace(device=[("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 0.0, bound),
                              ("flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel", 1.0, 1.0 + bound / 2),
                              ("void cudnn::fusion::compute_dot_do_o_specialized<true, 64>(void "
                               "const*)", 1.5 + bound / 2, 1.5 + bound),
                              ("at::native::vectorized_elementwise_kernel", 3.0, 4.0)],
                      host=[], units=2, wall_s=5.0, spans={})
    assert attn.read(ctx) == pytest.approx(100.0)
    assert bench.metric_reader("attn_ms_per_step.dav2l").read(ctx) == pytest.approx(
        1e3 * bound)
    assert bench.metric_reader("idle_share.train.dav2l").read(ctx) == pytest.approx(
        100 * (1 - (2 * bound + 1.0) / 5.0))
    assert bench.metric_reader("launches_per_step.train.dav2l").read(ctx) == 2
    ctx.window = {"units": 10, "window_s": 2.0}
    mfu = bench.metric_reader("mfu.train.dav2l")
    assert mfu.read(ctx) == pytest.approx(100 * 10 * mfu.step_flops(ctx) / (2.0 * 989e12))
    assert 78e12 < mfu.step_flops(ctx) < 82e12  # about 80 TFLOP a step
    # the spans: two traced steps, each an encoder and a head span under forward
    ms = 1_000_000
    records = []
    for unit in (1, 2):
        t = unit * 1000 * ms
        records += [SpanRecord("encoder", "forward", unit, t + 1 * ms, t + 4 * ms),
                    SpanRecord("dpt_head", "forward", unit, t + 4 * ms, t + 5 * ms),
                    SpanRecord("forward", "train_step", unit, t, t + 6 * ms),
                    SpanRecord("train_step", None, unit, t, t + 900 * ms)]
    ctx.trace = Trace(device=[("k", 1.0, 1.5), ("k", 2.0, 2.5)], host=[], units=2,
                      wall_s=2.0, spans={})
    from harness import port_spans
    monkeypatch.setattr(port_spans, "port_sessions", lambda: [Session(0, records)])
    assert bench.metric_reader("host_ms.encoder.dav2l").read(ctx) == pytest.approx(3.0)
    assert bench.metric_reader("host_ms.dpt_head.dav2l").read(ctx) == pytest.approx(1.0)
    monkeypatch.setattr(port_spans, "port_sessions", lambda: [])
    ctx.trace = Trace(device=[("k", 0.0, 1.0)], host=[], units=1, wall_s=1.0, spans={})
    assert bench.metric_reader("host_ms.encoder.dav2l").read(ctx) is None
    ctx.trace = Trace(device=[("k", 0.0, 1.0)], host=[], units=1, wall_s=1.0, spans={})
    assert attn.read(ctx) is None  # no attention kernel ran: no share


def test_trainer_rate_reader_reads_the_window():
    ctx, bench = _ctx(TRAINER)
    ctx.window = {"metrics": {"trainer_samples_per_s": 42.5}}
    assert bench.metric_reader("trainer_samples_per_s.fcdn57").read(ctx) == 42.5
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12


def test_the_trainer_check_leaves_out_biases_whose_gradient_cancels(tmp_path):
    """A conv bias whose every path runs through a train-mode BatchNorm
    sums terms that cancel to float32's rounding; one that also reaches
    the head without a BatchNorm (the first conv) still cancels beyond
    bfloat16's; the head's own bias does not. ``compare`` leaves out
    what cancels beyond the program's rounding, and nothing at float32's."""
    bench = registry.Benchmark.load()
    config, traffic = SMALL[TRAINER]
    cell = bench.cell(TRAINER)
    ctx = cli.Context(cell, {**bench.config(cell.config), **config},
                      {**bench.traffic(cell.traffic), **traffic, "root": str(tmp_path)},
                      bench.limits(TRAINER), 2**31 + 9, CPU, say=lambda s: None)
    module = bench.driver("trainer_cli")
    drv = module.Driver(ctx)
    drv.setup()
    drv.window(0.5)
    drv.release()
    drv.read_back()
    ref = drv.reference_readings()
    kappa = ref["cancellation"]
    assert kappa["denseBlocksDown.3.layers.0.conv.bias"] > 1e6  # BatchNorms only
    assert kappa["firstconv.bias"] > 2**8 > kappa["finalConv.bias"]
    bf16 = module.compare(drv.program, ref, ctx.limits, 2.0**-8)[1]["change"]
    f32 = module.compare(drv.program, ref, ctx.limits, 2.0**-24)[1]["change"]
    assert " 0 cancelling" not in bf16 and " 0 cancelling" in f32
    assert module.rounding_unit({"dtype": "bfloat16"}) == 2.0**-8
