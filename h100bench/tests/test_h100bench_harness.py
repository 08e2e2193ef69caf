"""The benchmark's harness on the CPU: every cell resolves to its files,
``BENCHMARK.json`` keeps to the contract's shapes, the kernels' counts
match a hand count, nothing of JAX may load, and a new configuration,
mix, driver and metric run as new files alone.

    python -m pytest h100bench/tests -q
"""
from __future__ import annotations

import json
import math
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import cli, env, registry, roofline  # noqa: E402
from harness.readers import matcher  # noqa: E402
from harness.tracing import Trace, short_name  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
C57 = dict(down_blocks=[4] * 5, up_blocks=[4] * 5, bottleneck_layers=4, growth_rate=12,
           out_chans_first_conv=48, n_classes=1)


@pytest.fixture(scope="module")
def bench():
    return registry.Benchmark.load()


def test_every_cell_resolves_to_its_files(bench):
    for name, cell in bench.cells.items():
        config = bench.config(cell.config)
        traffic = bench.traffic(cell.traffic)
        assert config["name"] == cell.config
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert hasattr(bench.driver(traffic["driver"]), "Driver")
        assert bench.limits(name)
        assert (BENCH / config["reference"]).is_file()
        e2e = bench.end_to_end_of(name)
        assert "setup_s" in {m.name for m in e2e} and len(e2e) >= 2
        layers = bench.per_layer_of(name)
        assert layers, name
        for m in layers:
            assert callable(bench.metric_reader(m.name).read)
            assert m.moves in {e.name for e in e2e}, (name, m.name)


def test_a_reader_is_found_by_the_metric_name_then_by_its_stem(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "share.py").write_text("KIND = 'stem'\n")
    (tmp_path / "metrics" / "share.train.py").write_text("KIND = 'own'\n")
    bench = registry.Benchmark({"workloads": [], "end_to_end": [], "per_layer": []},
                               bench_dir=tmp_path)
    assert bench.metric_reader("share.train").KIND == "own"
    assert bench.metric_reader("share.live").KIND == "stem"
    # the longest prefix that has a file
    assert bench.metric_reader("share.train.fcdn57").KIND == "own"
    assert bench.metric_reader("share.live.fcdn57").KIND == "stem"
    with pytest.raises(FileNotFoundError):
        bench.metric_reader("other.live")


def test_benchmark_json_keeps_the_contract_shapes(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["h100bench"] and spec["command"][1] == "h100bench/run.py"
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/") and (BENCH.parent / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
    metrics = spec["end_to_end"] + spec["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    every = [m["name"] for m in metrics] + [w["name"] for w in spec["workloads"]]
    assert len(every) == len(set(every))


def test_k1_count_matches_a_hand_count():
    # one K1 launch at b1 256x320, C = 48 in, F = 12 out, bf16
    n_bytes, ops = roofline.k1_counts(256 * 320, 48, 12, 2)
    pixels = 81920
    assert ops == 2 * 9 * 48 * 12 * pixels == 849346560
    # x (48 ch) in, y (12 ch) out, 3x3x48x12 weights, bf16; scale, shift
    # (48 each) and bias (12) f32
    assert n_bytes == 2 * (pixels * 48 + pixels * 12 + 9 * 48 * 12) + 4 * (48 + 48 + 12)
    assert roofline.bound_s(n_bytes, ops, "bfloat16") == max(n_bytes / 3.35e12,
                                                            ops / 989e12)


def test_engine_counts_match_a_hand_count():
    # the first layer of FCDenseNet-57's first block at 2B = 16 256x320
    pixels, c, f = 16 * 256 * 320, 48, 12
    counts = roofline.engine_layer_counts(pixels, c, f, 2)
    macs = pixels * 9 * c * f
    assert all(ops == 2 * macs for _, ops in counts.values())
    w = 9 * c * f
    assert counts["fwd"][0] == 2 * (pixels * 60 + w) + 4 * (96 + 12 + 24)
    assert counts["dinput"][0] == 2 * (pixels * (24 + 144) + w) + 4 * (192 + 36)
    assert counts["dweight"][0] == 2 * pixels * 72 + 4 * (96 + 24 + w)


def test_warp_counts_match_a_hand_count():
    q = 16 * 256 * 320
    counts = roofline.warp_counts(q)
    # K2: a 2-channel image, px, py read, 2 channels written, f32
    assert counts["fwd"] == (4 * q * 6, q * 26)
    # K3: channel 0 of the image and of g, px, py read; dimg (2), dpx, dpy written
    assert counts["bwd"] == (4 * q * 8, q * 30)


def test_forward_flops_match_a_hand_count():
    # a net small enough to count by hand: 1 down block of 1 layer, a
    # 1-layer bottleneck, 1 up block of 1 layer; growth 2, 4 first channels
    cfg = dict(down_blocks=[1], up_blocks=[1], bottleneck_layers=1, growth_rate=2,
               out_chans_first_conv=4, n_classes=1)
    b, h, w = 1, 4, 6
    p, q = h * w, (h // 2) * (w // 2)
    first = 2 * 9 * 3 * 4 * p
    down = 2 * 9 * 4 * 2 * p + 2 * 6 * 6 * p           # layer 4 -> 2, TD 6 -> 6
    neck = 2 * 9 * 6 * 2 * q                            # layer 6 -> 2 at h/2
    up = 2 * 9 * 2 * 2 * p + 2 * 9 * (2 + 6) * 2 * p    # TU 2 -> 2 at h, layer 8 -> 2
    head = 2 * (8 + 2) * 1 * p
    assert roofline.forward_conv_flops(cfg, b, h, w) == first + down + neck + up + head
    assert len(roofline.dense_layer_shapes(C57, 256, 320)) == 44


def test_roofline_readers_read_100_at_the_bound(bench):
    """A trace whose engine, sampler and K1 kernels take exactly their
    bounds reads 100%: the readers count each traced unit's launches once."""
    cell = bench.cell("fcdn57-train-b8-256x320")
    ctx = cli.Context(cell, bench.config(cell.config), bench.traffic(cell.traffic), {},
                      1, torch.device("cpu"))
    engine = registry.load_module(BENCH / "metrics" / "engine_roofline.py")
    warp = registry.load_module(BENCH / "metrics" / "warp_roofline.py")
    e, w = engine.step_bound_s(ctx), warp.step_bound_s(ctx)
    ctx.trace = Trace(device=[("dinput_mma_kernel<8, true>", 0.0, 3 * e),
                              ("warp_sample_fwd_kernel", 10.0, 10.0 + 3 * w)],
                      host=[], units=3, wall_s=20.0, spans={})
    assert engine.read(ctx) == pytest.approx(100.0)
    assert warp.read(ctx) == pytest.approx(100.0)
    cell = bench.cell("fcdn57-live-b1-256x320")
    ctx = cli.Context(cell, bench.config(cell.config), bench.traffic(cell.traffic), {},
                      1, torch.device("cpu"))
    k1 = bench.metric_reader("k1_roofline.live")
    one = k1.forward_bound_s(ctx)
    ctx.trace = Trace(device=[("conv3x3_fwd_mma_kernel<8, 8, false>", 0.0, 2 * one)],
                      host=[], units=2, wall_s=1.0, spans={})  # 2 frames at batch 1
    assert k1.read(ctx) == pytest.approx(100.0)


def test_no_jax_check_compares_whole_top_level_names():
    assert env.forbidden_modules(["endoscopydepthestimation_pytorch_tpu_torch.ops",
                                  "endoscopydepthestimation_pytorch_tpu_torch",
                                  "jaxtyping", "numpy"]) == []
    assert env.forbidden_modules(["endoscopydepthestimation_pytorch_tpu.ops"]) == [
        "endoscopydepthestimation_pytorch_tpu.ops"]
    assert env.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib"]


def test_kernel_name_maps():
    engine = registry.load_module(BENCH / "metrics" / "engine_roofline.py").ENGINE
    warp = registry.load_module(BENCH / "metrics" / "warp_roofline.py").WARP
    other = registry.load_module(BENCH / "metrics" / "torch_ops_ms_per_step.train.py")
    names = {"void conv3x3_fwd_mma_kernel<8, 8, true>(__nv_bfloat16 const*, int)": "e",
             "void dinput_mma_kernel<8, true>(float*)": "e",
             "void dweight_mma_kernel<8, 8>(float*)": "e",
             "sum_partials_kernel(float const*, float*, int, int)": "e",
             "warp_sample_fwd_kernel(float const*)": "w",
             "void warp_sample_bwd_kernel<2>(float const*)": "w",
             "dimg_kernel(long long const*)": "w", "max_grad_kernel(float const*)": "w",
             "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"
             "<float>>(int, float)": "t"}
    for name, kind in names.items():
        assert engine(name) == (kind == "e"), name
        assert warp(name) == (kind == "w"), name
        assert other.PORT_KERNELS(name) == (kind != "t"), name
    assert not matcher([r"\bfwd_kernel<"])("dense_conv_fwd_kernel(float const*)")


def test_trace_reduction_takes_the_union_and_names_gaps():
    trace = Trace(device=[("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("k1", 3.0, 4.0)],
                  host=[("aten::add", 1.4, 3.2), ("aten::copy_", 2.0, 2.5)],
                  units=2, wall_s=5.0, spans={})
    assert trace.busy_s == pytest.approx(2.5)
    brk = trace.breakdown()
    assert brk["device_ops"][0] == ["k1", 2.0]
    assert brk["idle_gaps"] == [["aten::add > aten::copy_", 1.5]]
    lone = Trace(device=[("k1", 0.0, 1.0), ("k1", 3.0, 4.0)], host=[("aten::mul", 0.5, 1.2)],
                 units=1, wall_s=4.0, spans={})
    assert lone.breakdown()["idle_gaps"] == [["between ops, after aten::mul", 2.0]]
    assert short_name("void at::native::(anonymous namespace)::k<4>(float*)") == "at::native::k<4>"


def _new_files(root: Path):
    """A benchmark with a new configuration, mix, driver and metric added
    as files and entries, nothing else changed."""
    dst = root / "h100bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (dst / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "reference": "reference/fcdensenet.py", "builder": "FCDenseNet",
        "down_blocks": [1], "up_blocks": [1], "bottleneck_layers": 1, "growth_rate": 2,
        "out_chans_first_conv": 4, "n_classes": 1, "dtype": "float32"}))
    (dst / "traffic" / "forward-b2.json").write_text(json.dumps(
        {"driver": "plain_forward", "batch": 2, "height": 8, "width": 8}))
    (dst / "drivers" / "plain_forward.py").write_text('''
import time
import torch
from harness.compare import Check
from harness.registry import reference_model

class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
    def setup(self):
        self.model = reference_model(self.ctx.config).eval()
        t = self.ctx.traffic
        self.x = torch.ones(t["batch"], 3, t["height"], t["width"])
    def window(self, seconds):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.model(self.x)
            n += 1
        dt = time.perf_counter() - t0
        return {"metrics": {"forwards_per_s": n / dt}, "attempted": n, "failed": 0,
                "units": n, "window_s": dt}
    def traced_units(self):
        self.model(self.x)
        return 1
    def release(self):
        pass
    def check(self):
        return [Check("finite", 0.0, self.ctx.limits["finite"])]
''')
    (dst / "metrics" / "forwards_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.window['units'])\n")
    (dst / "limits" / "tiny-forward.json").write_text(json.dumps({"limits": {"finite": 0}}))
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                            "file": "h100bench/configs/tiny.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny-forward", "config": "tiny",
                              "traffic": "forward-b2", "chips": 1, "why": "a test"})
    spec["end_to_end"].insert(0, {"name": "forwards_per_s", "unit": "forwards/s",
                                  "better": "higher", "bound": 0.05,
                                  "source": "host_clock", "workloads": ["tiny-forward"]})
    spec["per_layer"].append({"name": "forwards_seen", "unit": "forwards",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole forward", "moves": "forwards_per_s",
                              "workloads": ["tiny-forward"]})
    return registry.Benchmark(spec, bench_dir=dst)


def test_new_config_mix_driver_and_metric_are_new_files_only(tmp_path):
    bench = _new_files(tmp_path)
    for trace in (False, True):
        res = cli.run_cell(bench, "tiny-forward", 7, 0.2, trace, torch.device("cpu"),
                           time.perf_counter(), say=lambda s: None)
        assert res["correct"] and list(res)[-1] == "checks"
        wanted = {"forwards_seen"} if trace else {"forwards_per_s", "setup_s"}
        assert set(res["metrics"]) == wanted
        assert all(math.isfinite(m["value"]) for m in res["metrics"].values())
    # the files that were there are unchanged
    for p in BENCH.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert (tmp_path / "h100bench" / p.relative_to(BENCH)).read_bytes() == p.read_bytes()
