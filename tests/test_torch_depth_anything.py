"""Depth Anything V2 in the port (``models/depth_anything.py``) on the CPU,
against the plain reference ``tests/reference_depth_anything.py``, on
seeded random weights at a small size (embed 64, 4 heads, 4 blocks all
taken, DPT features 16, out_channels 8/16/32/32, a 3x3 stored position
grid, inputs 56x70: 4x5 patches): the forward, three ``train_step``s
against the benchmark's reference objective, the position embedding's
interpolation, the full-size network's parameters and names on the meta
device, the trainer's refusals, and the trainer, the evaluate CLI and
``DepthPredictor`` through the normal path.
"""
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import reference_depth_anything as ref
from endoscopydepthestimation_pytorch_tpu_torch import evaluate, models, serving, train, training
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

from torch_sfm_sequence import write_sequence

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "h100bench" / "configs" / "depth_anything_v2_vitl.json").read_text())
TINY = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0, layer_idx=[0, 1, 2, 3],
            features=16, out_channels=[8, 16, 32, 32], img_size=42)
HEAD = "depth_head.scratch.output_conv2.2"  # the final 1x1 conv
HYPER = json.loads((REPO / "h100bench" / "traffic" / "train-b8-256x320.json").read_text())["hyper"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


objective = _load("h100bench_reference_objective", REPO / "h100bench/reference/objective.py")
synthetic = _load("h100bench_harness_synthetic", REPO / "h100bench/harness/synthetic.py")


def tiny_port(dtype=torch.float32, **_flags) -> dav2.DepthAnythingV2:
    return dav2.DepthAnythingV2(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in TINY.items()}, dtype=dtype)


tiny_port.crop_multiple = dav2.PATCH  # as the full-size builder's


def seeded(seed: int = 0, conditioned: bool = False) -> dav2.DepthAnythingV2:
    model = models.init_weights(tiny_port(), torch.Generator().manual_seed(seed))
    if conditioned:  # depth = relu(3 + 0.1 conv): away from the objective's 1/z pole
        with torch.no_grad():
            head = dict(model.named_modules())[HEAD]
            head.weight.mul_(0.1)
            head.bias.fill_(3.0)
    return model


def _reference(port: torch.nn.Module) -> ref.DepthAnythingV2:
    model = ref.build(TINY)
    model.load_state_dict(port.state_dict(), strict=True)
    return model


def test_forward_matches_the_reference():
    port = seeded(1)
    x = torch.rand(3, 3, 56, 70, generator=torch.Generator().manual_seed(2)) * 2 - 1
    before = dav2.LAUNCHES["attention"]
    with torch.no_grad():
        got = port(x)
        want = _reference(port)(x)
    assert dav2.LAUNCHES["attention"] - before == TINY["depth"]
    assert got.shape == (3, 1, 56, 70) and got.dtype == torch.float32
    # float32 on both sides; sums in another order (SDPA against the
    # written-out softmax, channels_last convolutions): a few ulps of the
    # depth's largest value, which the head's ReLU puts near 0 elsewhere
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_bfloat16_forward_stays_near_the_reference():
    port = seeded(3)
    x = torch.rand(2, 3, 56, 70, generator=torch.Generator().manual_seed(4)) * 2 - 1
    low = tiny_port(torch.bfloat16)
    low.load_state_dict(port.state_dict())
    with torch.no_grad():
        got, want = low(x), _reference(port)(x)
    # bfloat16 activations (8 bits of mantissa, 2^-9 relative a rounding)
    # through 4 blocks and the head: within a few percent of the f32 depth
    rel = float((got - want).abs().mean() / want.abs().mean())
    assert got.dtype == torch.float32 and rel < 0.05, rel


@pytest.mark.parametrize("rows,cols", [(4, 5), (5, 3), (3, 3)])
def test_position_embedding_interpolates_a_non_square_grid(rows, cols):
    pos = torch.randn(1, 1 + 3 * 3, 8, generator=torch.Generator().manual_seed(5))
    got = dav2.interpolate_pos_embed(pos, rows, cols)
    assert got.shape == (1, 1 + rows * cols, 8)
    torch.testing.assert_close(got, ref.position_embedding(pos, rows, cols), rtol=0, atol=0)
    assert torch.equal(got[:, 0], pos[:, 0])  # the class position is kept
    if (rows, cols) == (3, 3):
        assert torch.equal(got, pos)
    else:
        # the scale factors carry DINOv2's offset of 0.1: resizing to the
        # size alone samples elsewhere
        plain = torch.nn.functional.interpolate(
            pos[:, 1:].reshape(1, 3, 3, 8).permute(0, 3, 1, 2), size=(rows, cols),
            mode="bicubic").permute(0, 2, 3, 1).reshape(1, rows * cols, 8)
        assert not torch.allclose(got[:, 1:], plain)


def test_full_size_network_matches_the_configuration():
    with torch.device("meta"):
        model = models.DepthAnythingV2Large(dtype=torch.bfloat16)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == CONFIG["parameters"]
    assert len(params) == CONFIG["parameter_tensors"]
    upstream = {k.format(i=i) for k in CONFIG["upstream_keys"]
                for i in (range(CONFIG["depth"]) if "{i}" in k else [0])}
    assert len(upstream) == CONFIG["upstream_tensors"]
    assert set(model.state_dict()) == upstream - set(dav2.UNUSED_UPSTREAM_KEYS)
    assert set(dav2.UNUSED_UPSTREAM_KEYS) <= upstream
    # the published count is the port's plus the two unused tensors
    unused = 1024 + 2 * (256 * 256 * 9 + 256)
    assert CONFIG["parameters"] + unused == CONFIG["parameters_upstream"]
    assert round(CONFIG["parameters_upstream"] / 1e6, 1) == 335.3


def test_an_upstream_checkpoint_loads_with_the_unused_keys_left_out():
    port = seeded(6)
    upstream = dict(port.state_dict())
    upstream["pretrained.mask_token"] = torch.zeros(1, TINY["embed_dim"])
    for k in dav2.UNUSED_UPSTREAM_KEYS[1:]:
        upstream[k] = torch.zeros(())
    fresh = tiny_port()
    dav2.load_upstream_state_dict(fresh, upstream)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                port.state_dict().values()))
    with pytest.raises(KeyError):
        dav2.load_upstream_state_dict(fresh, port.state_dict())


def test_three_train_steps_match_the_reference_objective():
    port = seeded(7, conditioned=True)
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    batches = synthetic.train_batches(3, 2, 56, 70, 2**31 + 11, torch.device("cpu"))
    config = training.TrainConfig(compute_dtype=torch.float32, **HYPER)
    state = training.create_train_state(port)
    dcl = torch.tensor(HYPER["dcl_weight"])
    losses, first = [], None
    for batch in batches:
        _, metrics = training.train_step(state, batch, dcl, config)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = [m.clone() for m in state.momentum]
    model = ref.build(TINY)
    model.load_state_dict(initial, strict=True)
    out = objective.train_steps(model, batches, HYPER)
    # float32 against float32: the objective's sums, the sampler (the
    # port's plain twin against four gathers) and attention in another
    # order; the clipped gradient passes that through 4 blocks and back
    np.testing.assert_allclose(losses, out["losses"], rtol=2e-5)
    names = [n for n, _ in port.named_parameters()]
    scale = max(float(g.norm()) for g in out["first_update"].values())
    for name, got in zip(names, first):
        want = out["first_update"][name]
        assert float((got - want).norm()) <= 1e-4 * max(float(want.norm()), 1e-2 * scale), name
    for name, p in port.named_parameters():
        change = p.detach() - initial[name]
        ref_change = dict(model.named_parameters())[name].detach() - initial[name]
        assert float((change - ref_change).norm()) <= 1e-3 * float(ref_change.norm()) + 1e-9, name


def test_the_forward_opens_its_spans_under_forward():
    port = seeded(8, conditioned=True)
    batch = synthetic.train_batches(1, 1, 56, 70, 5, torch.device("cpu"))[0]
    state = training.create_train_state(port)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        training.train_step(state, batch, torch.tensor(5.0),
                            training.TrainConfig(compute_dtype=torch.float32))
    records = profiling.sessions()[-1].records
    unit = max(r.unit for r in records)
    spans = {(r.name, r.parent) for r in records if r.unit == unit}
    assert {("encoder", "forward"), ("dpt_head", "forward")} <= spans


def _trainer_argv(data, out, *extra):
    return ["--adjacent_range", "1", "3", "--id_range", "1", "2",
            "--input_size", "70", "70", "--batch_size", "2", "--num_iter", "4",
            "--number_epoch", "0", "--display_interval", "1", "--log_interval", "1",
            "--num_workers", "2", "--num_pre_workers", "1",
            "--training_patient_id", "1", "--testing_patient_id", "1",
            "--validation_patient_id", "1", "--compute_dtype", "float32",
            "--architecture", "depth_anything_v2_vitl", "--network_downsampling", "14",
            "--training_data_root", str(data), "--training_result_root", str(out),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra,message", [
    (("--act8",), "applies only to FC-DenseNet"),
    (("--remat",), "applies only to FC-DenseNet"),
    (("--block_engine",), "applies only to FC-DenseNet"),
    (("--network_downsampling", "64"), "crops whose sides are multiples of 14"),
    (("--input_size", "64", "64"), "crops whose sides are multiples of 14")])
def test_trainer_refuses_what_the_architecture_cannot_take(tmp_path, extra, message):
    with pytest.raises(ValueError, match=message):
        train.main(_trainer_argv(tmp_path / "none", tmp_path / "out", *extra))
    assert not (tmp_path / "out").exists()  # refused before anything was written


@pytest.mark.parametrize("architecture,downsampling,size,ok", [
    ("depth_anything_v2_vitl", 14, (518, 644), True),
    ("depth_anything_v2_vitl", 28, (70, 84), True),
    ("depth_anything_v2_vitl", 64, (518, 644), False),
    ("depth_anything_v2_vitl", 14, (256, 320), False),
    ("fcdensenet57", 64, (256, 320), True),  # no crop_multiple: any crop
    ("unet", 14, (70, 70), True)])
def test_the_crop_rule_is_the_builders(architecture, downsampling, size, ok):
    if ok:
        models.check_crop(architecture, downsampling, size)
    else:
        with pytest.raises(ValueError, match="crops whose sides are multiples of 14"):
            models.check_crop(architecture, downsampling, size)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the trainer on the tiny network (2 steps of b2, then
    validation and a checkpoint), on a 72x72 sequence (raw 288x288,
    downsampled by 4) whose crop, rounded up to a multiple of 14, is
    70x70."""
    root = tmp_path_factory.mktemp("dav2")
    folder = write_sequence(root / "data", seed=9, height=288, width=288)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.ARCHITECTURES, "depth_anything_v2_vitl", tiny_port)
        init = models.init_weights
        # the head conditioned as the step tests do
        mp.setattr(train, "init_weights",
                   lambda m, g: _condition(init(m, g)))
        before = dav2.LAUNCHES["attention"]
        with contextlib.redirect_stdout(io.StringIO()):
            run = train.main(_trainer_argv(root / "data", root / "out"))
        attention = dav2.LAUNCHES["attention"] - before
    return root, folder, run, attention


def _condition(model):
    with torch.no_grad():
        head = dict(model.named_modules())[HEAD]
        head.weight.mul_(0.1)
        head.bias.fill_(3.0)
    return model


def test_trainer_trains_it_through_train_step(trained):
    _, _, run, attention = trained
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert isinstance(run.state.model, dav2.DepthAnythingV2)
    assert int(run.state.step) == 2 and len(run.checkpoints) == 1
    # 2 train forwards and at least one validation forward, 4 blocks each
    assert attention >= 3 * TINY["depth"] and attention % TINY["depth"] == 0
    saved = torch.load(run.checkpoints[0], map_location="cpu", weights_only=True)["model"]
    assert {k.removeprefix("module.") for k in saved} == set(run.state.model.state_dict())


def test_evaluate_and_the_predictor_serve_it(trained, monkeypatch):
    root, folder, run, _ = trained
    monkeypatch.setitem(models.ARCHITECTURES, "depth_anything_v2_vitl", tiny_port)
    argv = ["--adjacent_range", "1", "3", "--id_range", "1", "2", "--input_size", "70", "70",
            "--batch_size", "1", "--num_workers", "1", "--num_pre_workers", "1",
            "--testing_patient_id", "1", "--load_all_frames",
            "--trained_model_path", str(run.checkpoints[0]), "--sequence_root", str(folder),
            "--evaluation_result_root", str(root / "eval"),
            "--evaluation_data_root", str(root / "data"), "--phase", "test",
            "--architecture", "depth_anything_v2_vitl", "--network_downsampling", "14",
            "--device", "cpu"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = evaluate.main(argv)
    assert result.frames > 0 and len(list(result.log_root.glob("*.ply"))) == result.frames
    assert re.search(r"depth range \[", printed.getvalue())
    with pytest.raises(ValueError, match="crops whose sides are multiples of 14"):
        evaluate.main([a if a != "14" else "64" for a in argv])

    sequence = chip_smoke.synthetic_sequence(56, 70)
    predictor = serving.DepthPredictor(run.checkpoints[0], sequence, batch_size=1,
                                       downsampling=1.0, device="cpu", dtype=torch.float32,
                                       architecture="depth_anything_v2_vitl")
    frame = np.random.RandomState(3).randint(
        0, 256, (56 + 2 * chip_smoke.MARGIN, 70 + 2 * chip_smoke.MARGIN, 3)).astype(np.uint8)
    depth = predictor.predict_frame(frame)
    model = tiny_port()
    ckpt.load_any_checkpoint(run.checkpoints[0], model)
    colors = torch.from_numpy(predictor.prepare(frame))[None]
    boundary = predictor._boundary[:1]
    with torch.no_grad():
        want = model.eval()((colors * boundary).permute(0, 3, 1, 2))[0, 0] * boundary[0, ..., 0]
    assert depth.shape == (56, 70)
    np.testing.assert_allclose(depth, want.numpy(), rtol=1e-6, atol=1e-6)
