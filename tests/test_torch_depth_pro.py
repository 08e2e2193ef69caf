"""Depth Pro in the port (``models/depth_pro.py``) on the CPU, against the
plain reference ``tests/reference_depth_pro.py``, on seeded random weights
at a tiny geometry that keeps the published one's token arithmetic (the
patch 16, so the decoder's x16 of upsampling returns the input's size;
128-pixel tiles of a 512-pixel image, 8x8 tokens a tile, so 25 + 9 + 1
tiles and paddings 1 and 2 give 32x32 and 16x16 grids; embed 32, 2 heads,
3 blocks, hooks 0 and 1, encoder dims 8/8/16/16, decoder features 8):
the forward, three ``train_step``s against the benchmark's reference
objective, split and merge at the tiny and the published geometry, the
full-size network on the meta device against the configuration, the
fixed input size, the trainer's refusals, the trainer and
``DepthPredictor`` through the normal path; and the shared ViT's forward
and train steps bitwise what they were before its patch size became an
argument (Depth Anything V2's path).
"""
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import reference_depth_pro as ref
from endoscopydepthestimation_pytorch_tpu_torch import evaluate, models, serving, train, training
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_pro as dp
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

from torch_sfm_sequence import write_sequence

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "h100bench" / "configs" / "depth_pro.json").read_text())
TINY = dict(embed_dim=32, depth=3, num_heads=2, mlp_ratio=4.0, tile_size=128, patch_size=16,
            dims_encoder=[8, 8, 16, 16], decoder_features=8, hook_block_ids=[0, 1])
SIDE = 4 * TINY["tile_size"]
HEAD = "head.4"  # the final 1x1 conv
HYPER = json.loads((REPO / "h100bench" / "traffic" / "train-b8-256x320.json").read_text())["hyper"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


objective = _load("h100bench_reference_objective", REPO / "h100bench/reference/objective.py")
synthetic = _load("h100bench_harness_synthetic", REPO / "h100bench/harness/synthetic.py")


def tiny_port(dtype=torch.float32, **flags) -> dp.DepthPro:
    dav2.refuse_fcdensenet_flags("Depth Pro", 1, flags)
    t = TINY
    return dp.DepthPro(t["embed_dim"], t["depth"], t["num_heads"], t["mlp_ratio"],
                       t["tile_size"], t["patch_size"], tuple(t["dims_encoder"]),
                       t["decoder_features"], tuple(t["hook_block_ids"]), dtype=dtype)


tiny_port.input_size = (SIDE, SIDE)  # as the full-size builder's


def _condition(model):
    """depth = relu(3 + 0.1 conv): away from the objective's 1/z pole."""
    with torch.no_grad():
        head = dict(model.named_modules())[HEAD]
        head.weight.mul_(0.1)
        head.bias.fill_(3.0)
    return model


def seeded(seed: int = 0, conditioned: bool = False) -> dp.DepthPro:
    model = models.init_weights(tiny_port(), torch.Generator().manual_seed(seed))
    return _condition(model) if conditioned else model


def _reference(port: torch.nn.Module) -> ref.DepthPro:
    model = ref.build(TINY)
    model.load_state_dict(port.state_dict(), strict=True)
    return model


def _colors(batch: int, seed: int) -> torch.Tensor:
    return torch.rand(batch, 3, SIDE, SIDE, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def test_forward_matches_the_reference():
    port = seeded(1, conditioned=True)
    x = _colors(2, 2)
    before = dav2.LAUNCHES["attention"], dp.LAUNCHES["tiles"]
    with torch.no_grad():
        got = port(x)
        want = _reference(port)(x)
    # one batched call of the patch encoder over the 35 tiles a frame, one
    # of the image encoder: two attention calls a block
    assert dav2.LAUNCHES["attention"] - before[0] == 2 * TINY["depth"]
    assert dp.LAUNCHES["tiles"] - before[1] == 35 * 2
    assert got.shape == (2, 1, SIDE, SIDE) and got.dtype == torch.float32
    # float32 on both sides; sums in another order (SDPA against the
    # written-out softmax, channels_last convolutions, tiles merged in
    # NHWC against NCHW): a few ulps of the depth's largest value
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_the_checkpointed_reference_is_the_reference():
    port = seeded(2, conditioned=True)
    x = _colors(1, 3)
    plain, kept = _reference(port), _reference(port)
    kept.checkpoint_blocks = True
    grads = []
    for model in (plain, kept):
        out = model(x)
        grads.append(torch.autograd.grad(out.square().mean(), list(model.parameters())))
        assert torch.equal(out, plain(x))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bfloat16_forward_stays_near_the_reference():
    port = seeded(3, conditioned=True)
    x = _colors(1, 4)
    low = tiny_port(torch.bfloat16)
    low.load_state_dict(port.state_dict())
    with torch.no_grad():
        got, want = low(x), _reference(port)(x)
    # bfloat16 activations (2^-9 relative a rounding) through 3 blocks,
    # the decoder and the head: within a few percent of the depth's
    # spread over the frame about its level
    gap = float((got - want).abs().mean() / (want - want.mean()).abs().mean())
    assert got.dtype == torch.float32 and gap < 0.1, gap


@pytest.mark.parametrize("side,tile,patch", [(SIDE, 128, 16), (1536, 384, 16)])
def test_merge_of_split_is_the_token_grid(side, tile, patch):
    """Tiles of an image whose pixels hold their own (image, row, col)
    patch coordinates, read at each tile's patch corners and merged,
    give the whole image's patch grid: 96x96 and 48x48 at the published
    geometry."""
    batch, grid = 2, tile // patch
    ys, xs = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    for level, (scale, overlap, padding) in enumerate([(1, 0.25, grid // 8),
                                                      (2, 0.5, grid // 4)]):
        s = side // scale
        image = torch.stack([torch.stack([torch.full((s, s), b), ys[:s, :s] // patch,
                                          xs[:s, :s] // patch]) for b in range(batch)])
        tiles = dp.split(image, tile, overlap)
        steps = dp.tile_steps(s, tile, overlap)
        assert steps == (5, 3)[level] and tiles.shape == (steps ** 2 * batch, 3, tile, tile)
        tokens = tiles[:, :, ::patch, ::patch].permute(0, 2, 3, 1).contiguous()
        merged = dp.merge(tokens, batch, padding)
        assert merged.shape == (batch, s // patch, s // patch, 3)
        want = image[:, :, ::patch, ::patch].permute(0, 2, 3, 1)
        assert torch.equal(merged, want)
        # the reference's merge, on NCHW grids, agrees
        assert torch.equal(ref.merge(tokens.permute(0, 3, 1, 2), batch, padding),
                           want.permute(0, 3, 1, 2))
    if side == 1536:
        assert (merged.shape[1], padding) == (48, 6)


def test_full_size_network_matches_the_configuration():
    with torch.device("meta"):
        model = models.DepthProLarge(dtype=torch.bfloat16)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == CONFIG["parameters"]
    assert len(params) == CONFIG["parameter_tensors"]
    enc = model.encoder
    assert enc.patch_encoder.patch == 16 and enc.patch_encoder.pos_embed.shape == (1, 577, 1024)
    assert (dp.tile_steps(1536, 384, 0.25), dp.tile_steps(768, 384, 0.5)) == (5, 3)
    upstream = {k.format(i=i, enc=e) for k in CONFIG["upstream_keys"]
                for i in (range(CONFIG["depth"]) if "{i}" in k else [0])
                for e in (("patch_encoder", "image_encoder") if "{enc}" in k else [0])}
    assert set(model.state_dict()) == upstream - set(dp.UNUSED_UPSTREAM_KEYS)
    assert set(dp.UNUSED_UPSTREAM_KEYS) <= upstream
    # the published count is the port's plus the deepest block's resnet1
    assert CONFIG["parameters"] + 2 * (256 * 256 * 9 + 256) == CONFIG["parameters_upstream"]
    with torch.device("meta"), pytest.raises(ValueError, match="1536x1536 inputs only"):
        model(torch.zeros(1, 3, 1536, 1024))


def test_three_train_steps_match_the_reference_objective():
    port = seeded(7, conditioned=True)
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    batches = synthetic.train_batches(3, 1, SIDE, SIDE, 2**31 + 13, torch.device("cpu"))
    config = training.TrainConfig(compute_dtype=torch.float32, **HYPER)
    state = training.create_train_state(port)
    dcl = torch.tensor(HYPER["dcl_weight"])
    losses, first = [], None
    before = dp.LAUNCHES["tiles"]
    for batch in batches:
        _, metrics = training.train_step(state, batch, dcl, config)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = [m.clone() for m in state.momentum]
    assert dp.LAUNCHES["tiles"] - before == 3 * 70  # a pair's two frames a step
    model = _reference(seeded(7, conditioned=True))
    model.load_state_dict(initial, strict=True)
    out = objective.train_steps(model, batches, HYPER)
    # float32 against float32: the objective's sums over 512x512 frames,
    # the sampler and attention in another order. Against the reference
    # in float64 both sides' first updates read up to 6.6e-4 of a leaf's
    # norm (the image encoder's LayerNorm weights, the pooled position
    # embedding; seed 7), so the two may differ by twice that, and by no
    # more than 2e-3
    np.testing.assert_allclose(losses, out["losses"], rtol=2e-5)
    names = [n for n, _ in port.named_parameters()]
    scale = max(float(g.norm()) for g in out["first_update"].values())
    for name, got in zip(names, first):
        want = out["first_update"][name]
        assert float((got - want).norm()) <= 2e-3 * max(float(want.norm()), 1e-2 * scale), name
    # the change over three steps, also within what float32 can hold of
    # it: each step rounds p - lr m to the parameter's spacing (the patch
    # embedding's changes are ~160 spacings)
    for name, p in port.named_parameters():
        change = p.detach() - initial[name]
        ref_change = dict(model.named_parameters())[name].detach() - initial[name]
        spacing = float(np.linalg.norm(np.spacing(initial[name].numpy())))
        assert float((change - ref_change).norm()) <= (1e-3 * float(ref_change.norm())
                                                       + 2 * spacing), name


def test_the_forward_opens_its_spans_under_forward():
    port = seeded(8, conditioned=True)
    batch = synthetic.train_batches(1, 1, SIDE, SIDE, 5, torch.device("cpu"))[0]
    state = training.create_train_state(port)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        training.train_step(state, batch, torch.tensor(5.0),
                            training.TrainConfig(compute_dtype=torch.float32))
    records = profiling.sessions()[-1].records
    unit = max(r.unit for r in records)
    spans = {(r.name, r.parent) for r in records if r.unit == unit}
    assert {("patch_encoder", "forward"), ("image_encoder", "forward"),
            ("decoder", "forward")} <= spans


def _trainer_argv(data, out, *extra):
    return ["--adjacent_range", "1", "3", "--id_range", "1", "2",
            "--input_size", str(SIDE), str(SIDE), "--input_downsampling", "1",
            "--batch_size", "2", "--num_iter", "4",
            "--number_epoch", "0", "--display_interval", "1", "--log_interval", "1",
            "--num_workers", "2", "--num_pre_workers", "1",
            "--training_patient_id", "1", "--testing_patient_id", "1",
            "--validation_patient_id", "1", "--compute_dtype", "float32",
            "--architecture", "depth_pro", "--network_downsampling", "16",
            "--training_data_root", str(data), "--training_result_root", str(out),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra,message", [
    (("--act8",), "applies only to FC-DenseNet, not to Depth Pro"),
    (("--remat",), "applies only to FC-DenseNet, not to Depth Pro"),
    (("--block_engine",), "applies only to FC-DenseNet, not to Depth Pro"),
    (("--input_size", "256", "320"), "takes 1536x1536 inputs only"),
    (("--input_size", "1536", "1535"), "takes 1536x1536 inputs only")])
def test_trainer_refuses_what_the_architecture_cannot_take(tmp_path, extra, message):
    argv = _trainer_argv(tmp_path / "none", tmp_path / "out", *extra)
    if "--input_size" not in extra:
        at = argv.index("--input_size")
        argv[at + 1:at + 3] = ["1536", "1536"]
    with pytest.raises(ValueError, match=message):
        train.main(argv)
    assert not (tmp_path / "out").exists()  # refused before anything was written


def test_evaluate_refuses_another_size(tmp_path):
    argv = ["--adjacent_range", "1", "3", "--id_range", "1", "2", "--input_size", "256", "320",
            "--testing_patient_id", "1", "--trained_model_path", str(tmp_path / "none.pt"),
            "--sequence_root", str(tmp_path / "none"),
            "--evaluation_result_root", str(tmp_path / "eval"),
            "--evaluation_data_root", str(tmp_path / "none"), "--phase", "test",
            "--architecture", "depth_pro", "--device", "cpu"]
    with pytest.raises(ValueError, match="depth_pro takes 1536x1536 inputs only"):
        evaluate.main(argv)
    assert not (tmp_path / "eval").exists()  # refused before anything was written


@pytest.mark.parametrize("architecture,size,ok", [
    ("depth_pro", (1536, 1536), True),
    ("depth_pro", (768, 768), False),
    ("depth_pro", (1536, 1920), False),
    ("depth_anything_v2_vitl", (518, 644), True),  # no fixed size
    ("fcdensenet57", (256, 320), True)])
def test_the_fixed_size_rule_is_the_builders(architecture, size, ok):
    assert models.fixed_input_size(architecture) == (
        (1536, 1536) if architecture == "depth_pro" else None)
    if ok:
        models.check_crop(architecture, 14 if "anything" in architecture else 64, size)
    else:
        with pytest.raises(ValueError, match="depth_pro takes 1536x1536 inputs only"):
            models.check_crop(architecture, 64, size)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the trainer on the tiny network (2 steps of b2, then
    validation and a checkpoint), on a sequence of raw 544x544 frames read
    at --input_downsampling 1, whose crop (the mask's box, rounded to 16)
    is the 512x512 the tiny network takes."""
    root = tmp_path_factory.mktemp("dpro")
    folder = write_sequence(root / "data", seed=9, height=SIDE + 32, width=SIDE + 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.ARCHITECTURES, "depth_pro", tiny_port)
        init = models.init_weights
        mp.setattr(train, "init_weights", lambda m, g: _condition(init(m, g)))
        before = dp.LAUNCHES["tiles"]
        with contextlib.redirect_stdout(io.StringIO()):
            run = train.main(_trainer_argv(root / "data", root / "out"))
        tiles = dp.LAUNCHES["tiles"] - before
    return root, folder, run, tiles


def test_trainer_trains_it_through_train_step(trained):
    _, _, run, tiles = trained
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert isinstance(run.state.model, dp.DepthPro)
    assert int(run.state.step) == 2 and len(run.checkpoints) == 1
    # 2 train forwards of 2 pairs and at least one validation forward:
    # 35 tiles a frame
    assert tiles >= 3 * 4 * 35 and tiles % 35 == 0
    saved = torch.load(run.checkpoints[0], map_location="cpu", weights_only=True)["model"]
    assert {k.removeprefix("module.") for k in saved} == set(run.state.model.state_dict())


def test_the_predictor_resizes_to_the_one_size_and_back(trained, monkeypatch):
    _, _, run, _ = trained
    monkeypatch.setitem(models.ARCHITECTURES, "depth_pro", tiny_port)
    sequence = chip_smoke.synthetic_sequence(40, 48)
    predictor = serving.DepthPredictor(run.checkpoints[0], sequence, batch_size=1,
                                       downsampling=1.0, device="cpu", dtype=torch.float32,
                                       architecture="depth_pro")
    frame = np.random.RandomState(3).randint(
        0, 256, (40 + 2 * chip_smoke.MARGIN, 48 + 2 * chip_smoke.MARGIN, 3)).astype(np.uint8)
    before = dp.LAUNCHES["tiles"]
    depth = predictor.predict_frame(frame)
    assert dp.LAUNCHES["tiles"] - before == 35
    model = tiny_port()
    ckpt.load_any_checkpoint(run.checkpoints[0], model)
    colors = torch.from_numpy(predictor.prepare(frame))[None]
    boundary = predictor._boundary[:1]
    x = (colors * boundary).permute(0, 3, 1, 2)
    with torch.no_grad():
        big = model.eval()(torch.nn.functional.interpolate(
            x, size=(SIDE, SIDE), mode="bilinear", align_corners=False))
        want = torch.nn.functional.interpolate(big, size=(40, 48), mode="bilinear",
                                               align_corners=False)[0, 0] * boundary[0, ..., 0]
    assert depth.shape == (40, 48)
    np.testing.assert_allclose(depth, want.numpy(), rtol=1e-6, atol=1e-6)


# -- the shared ViT, Depth Anything V2's path, before and after --------------

DAV2_TINY = dict(embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0, layer_idx=(0, 1, 2, 3),
                 features=16, out_channels=(8, 16, 32, 32), img_size=42)


def _forward_before(self, x, take):
    """``DinoVisionTransformer.forward`` as it was before the patch size
    became a constructor argument and the raw taps were added (the module
    constant ``PATCH`` and the normed taps only), on the CPU."""
    b = x.shape[0]
    rows, cols = x.shape[-2] // dav2.PATCH, x.shape[-1] // dav2.PATCH
    patches = dav2._conv(x, self.patch_embed.proj)
    patches = patches.permute(0, 2, 3, 1).reshape(b, rows * cols, -1)
    tokens = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), patches], 1)
    tokens = tokens + dav2.interpolate_pos_embed(self.pos_embed, rows, cols).to(x.dtype)
    out = []
    for i, block in enumerate(self.blocks):
        tokens = block(tokens)
        if i in take:
            out.append(dav2._layer_norm(tokens, self.norm)[:, 1:])
    return out


def _dav2_run(dtype, forward=None):
    """Depth Anything V2's tiny network: a forward, then three train steps;
    its depth, losses and final parameters and momentum."""
    with pytest.MonkeyPatch.context() as mp:
        if forward is not None:
            mp.setattr(dav2.DinoVisionTransformer, "forward", forward)
        model = models.init_weights(dav2.DepthAnythingV2(**DAV2_TINY, dtype=dtype),
                                    torch.Generator().manual_seed(11))
        _condition_dav2(model)
        x = torch.rand(2, 3, 56, 70, generator=torch.Generator().manual_seed(12)) * 2 - 1
        with torch.no_grad():
            depth = model(x)
        state = training.create_train_state(model)
        config = training.TrainConfig(compute_dtype=dtype, **HYPER)
        losses = []
        for batch in synthetic.train_batches(3, 2, 56, 70, 2**31 + 17, torch.device("cpu")):
            _, metrics = training.train_step(state, batch, torch.tensor(HYPER["dcl_weight"]),
                                             config)
            losses.append(metrics["loss"])
        return depth, torch.stack(losses), list(state.params), list(state.momentum)


def _condition_dav2(model):
    with torch.no_grad():
        head = dict(model.named_modules())["depth_head.scratch.output_conv2.2"]
        head.weight.mul_(0.1)
        head.bias.fill_(3.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depth_anything_v2_is_bitwise_what_it_was(dtype):
    now = _dav2_run(dtype)
    before = _dav2_run(dtype, _forward_before)
    assert torch.equal(now[0], before[0]) and torch.equal(now[1], before[1])
    assert all(torch.equal(a, b) for a, b in zip(now[2], before[2]))
    assert all(torch.equal(a, b) for a, b in zip(now[3], before[3]))
