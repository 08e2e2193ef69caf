"""What decides ``correct``, on the CPU at a size a test run holds: the
plain reference against the port in float32, and whole runs of each cell
(the harness's look for a card skipped) that must come out not correct
with the timed path broken underneath, or with the control (the
reference in float8 e4m3) in the program's place.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from endoscopydepthestimation_pytorch_tpu_torch import models, serving, training  # noqa: E402
from harness import cli, registry, synthetic  # noqa: E402
from reference import fcdensenet as ref_net  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(builder="FCDenseNet", down_blocks=[1, 2], up_blocks=[2, 1], bottleneck_layers=1,
            growth_rate=4, out_chans_first_conv=8, dtype="float32")
TRAIN = "fcdn57-train-b8-256x320"
LIVE = "fcdn57-live-b1-256x320"
OFFLINE = "fcdn57-offline-b8-512x576"
# each cell at a size the CPU holds: a tiny net for the train cells, the
# whole FCDenseNet-57 (DepthPredictor builds it) on small frames
SMALL = {TRAIN: (TINY, dict(batch=4, height=32, width=40, pool=4, trace_steps=1)),
         "fcdn103-train-b8-256x320": (TINY, dict(batch=4, height=32, width=40, pool=4,
                                                 trace_steps=1)),
         LIVE: (dict(dtype="float32"), dict(height=32, width=32, pool=4, warmup_frames=2,
                                           trace_frames=1)),
         OFFLINE: (dict(dtype="float32"), dict(height=32, width=32, pool=8, batch=4,
                                              warmup_batches=1, trace_batches=1))}


def run(cell: str, seconds: float = 0.6, seed: int = 2**31 + 77) -> dict:
    bench = registry.Benchmark.load()
    if cell == OFFLINE:
        # out of BENCHMARK.json (too noisy a host for any bound, PERF.md);
        # its files stay, run here as a later entry would name them
        spec = copy.deepcopy(bench.spec)
        spec["workloads"].append({"name": OFFLINE, "config": "fcdensenet57",
                                  "traffic": "offline-b8-512x576", "chips": 1})
        bench = registry.Benchmark(spec)
    config, traffic = SMALL[cell]
    return cli.run_cell(bench, cell, seed, seconds, False, CPU, time.perf_counter(),
                        config_override=config, traffic_override=traffic,
                        say=lambda s: None)


def _weights(cfg, seed=3, conditioned=False):
    with torch.device("meta"):
        skeleton = ref_net.build(cfg)
    return synthetic.seeded_state_dict(skeleton, seed, CPU, conditioned)


def test_reference_forward_matches_the_port_in_f32():
    cfg = {**registry.Benchmark.load().config("fcdensenet57"), **TINY}
    weights = _weights(cfg)
    port = models.FCDenseNet(cfg["down_blocks"], cfg["up_blocks"], cfg["bottleneck_layers"],
                             cfg["growth_rate"], cfg["out_chans_first_conv"], 1)
    port.load_state_dict(weights, strict=True)
    ref = ref_net.build(cfg)
    ref.load_state_dict(weights, strict=True)
    x = torch.rand(2, 3, 32, 64, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        got, want = port.eval()(x), ref.eval()(x)
    # f32 sums in another order; the depth |conv| has entries near 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("cell", [TRAIN, LIVE, OFFLINE])
def test_sound_runs_are_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if cell == TRAIN:
        # the port in f32 against the reference: rounding, which in the
        # boundary mask's constant border also decides which of a max-pool
        # window's near-equal values takes the gradient (3e-3 of a leaf
        # here; 3e-5 with the mask all ones)
        assert all(c["value"] < 1e-2 for c in res["checks"].values()), res["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    real = training.train_step

    def unchanged(state, batch, dcl_weight, config, **kw):
        import copy
        _, metrics = real(copy.deepcopy(state), batch, dcl_weight, config, **kw)
        return state, metrics

    monkeypatch.setattr(training, "train_step", unchanged)
    res = run(TRAIN)
    assert not res["correct"]
    assert res["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    real = training.train_step

    def half(state, batch, dcl_weight, config, **kw):
        rows = batch["color_1"].shape[0] // 2
        return real(state, {k: v[:rows] for k, v in batch.items()}, dcl_weight, config, **kw)

    monkeypatch.setattr(training, "train_step", half)
    assert not run(TRAIN)["correct"]


def test_a_live_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    real = serving.DepthPredictor.predict_frame
    calls = {"n": 0}

    def altered(self, frame):
        depth = real(self, frame)
        calls["n"] += 1
        if calls["n"] == 2 + 5:  # after the 2 warm-up frames: frame 4, a repeat
            depth = depth * 1.001
        return depth

    monkeypatch.setattr(serving.DepthPredictor, "predict_frame", altered)
    res = run(LIVE, seconds=3.0)
    assert not res["correct"] and res["checks"]["repeat_mismatch"]["value"] == 1


def test_a_first_answer_altered_is_caught_by_the_reference(monkeypatch):
    real = serving.DepthPredictor.predict_frame
    calls = {"n": 0}

    def altered(self, frame):
        depth = real(self, frame)
        calls["n"] += 1
        return depth * 1.05 if calls["n"] == 2 + 1 else depth  # frame 1's first answer

    monkeypatch.setattr(serving.DepthPredictor, "predict_frame", altered)
    res = run(LIVE)
    assert not res["correct"] and not res["checks"]["depth_rel"]["value"] <= \
        res["checks"]["depth_rel"]["limit"]


def test_half_an_offline_batch_left_out_is_caught(monkeypatch):
    real = serving.DepthPredictor._dispatch

    def half(self, colors):
        depth = real(self, colors)
        depth[depth.shape[0] // 2:] = 0.0
        return depth

    monkeypatch.setattr(serving.DepthPredictor, "_dispatch", half)
    assert not run(OFFLINE)["correct"]


def _train_readings(quant=None):
    """The program's side of a tiny train cell replaced by the reference
    computed with ``quant``."""
    bench = registry.Benchmark.load()
    config, traffic = SMALL[TRAIN]
    cell = bench.cell(TRAIN)
    ctx = cli.Context(cell, {**bench.config(cell.config), **config},
                      {**bench.traffic(cell.traffic), **traffic}, bench.limits(TRAIN),
                      2**31 + 5, CPU, say=lambda s: None)
    drv = bench.driver("train_step").Driver(ctx)
    drv.setup()
    drv.release()
    ref = drv.reference_readings()
    low = drv.reference_readings(quant=ref_net.fp8_round)
    return bench.driver("train_step").compare(low, ref, ctx.limits)[0]


def test_the_train_control_fails_a_limit():
    checks = _train_readings()
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]


def test_the_serving_control_fails_the_limit():
    from harness.compare import masked_rel
    from harness.serving import Serving
    from reference import serving as ref_serving
    bench = registry.Benchmark.load()
    config, traffic = SMALL[LIVE]
    cell = bench.cell(LIVE)
    ctx = cli.Context(cell, {**bench.config(cell.config), **config},
                      {**bench.traffic(cell.traffic), **traffic}, bench.limits(LIVE),
                      2**31 + 9, CPU, say=lambda s: None)
    srv = Serving(ctx)
    keys = list(range(traffic["pool"]))
    ref = srv.reference_depths(keys)
    low = srv.reference_depths(keys, quant=ref_net.fp8_round)
    mask = ref_serving.boundary(srv.sequence.mask_boundary)
    worst = max(masked_rel(low[k], ref[k], mask) for k in keys)
    assert worst > ctx.limits["depth_rel"], worst
    assert np.isfinite(worst)
