"""VGGT in the port (``models/vggt.py``) on the CPU, against the plain
reference ``tests/reference_vggt.py``, on seeded random weights at a tiny
size (embed 64, 4 heads of 16, 2 DINOv2 blocks and 2 frame/global pairs,
head features 16, pairs at 56x70, 4x5 patches): the forward, the first
gradient and three ``train_step``s against the benchmark's reference
objective; the cross-frame dependence; the 2-D RoPE's properties and its
tables' source; pairs kept whole by row splits; the full network on the
meta device against the configuration; the trainer, the evaluate CLI and
``DepthPredictor`` through the normal path; and Depth Anything V2's and
Depth Pro's forwards and gradients bitwise what they were before the
shared ViT code gained its options (seeded digests taken on the tree
before).
"""
import contextlib
import hashlib
import importlib.util
import io
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
import reference_vggt as ref
from endoscopydepthestimation_pytorch_tpu_torch import evaluate, models, serving, train, training
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything as dav2
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_pro as dp
from endoscopydepthestimation_pytorch_tpu_torch.models import vggt
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import profiling

from torch_sfm_sequence import write_sequence

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "h100bench" / "configs" / "vggt_1b.json").read_text())
TINY = dict(embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, num_register_tokens=4,
            intermediate_layer_idx=[0, 0, 1, 1], features=16, out_channels=[8, 16, 32, 32],
            img_size=42)
H, W = 56, 70
HEAD = "depth_head.scratch.output_conv2.2"  # the final 1x1 conv: depth = exp(channel 0)
HYPER = json.loads((REPO / "h100bench" / "traffic" / "train-b8-256x320.json").read_text())["hyper"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


objective = _load("h100bench_reference_objective", REPO / "h100bench/reference/objective.py")
synthetic = _load("h100bench_harness_synthetic", REPO / "h100bench/harness/synthetic.py")


def tiny_port(dtype=torch.float32, **flags) -> vggt.VGGT:
    dav2.refuse_fcdensenet_flags("VGGT", 1, flags)
    t = TINY
    return vggt.VGGT(t["embed_dim"], t["depth"], t["num_heads"], t["mlp_ratio"],
                     t["num_register_tokens"], tuple(t["intermediate_layer_idx"]), t["features"],
                     tuple(t["out_channels"]), t["img_size"], dtype=dtype)


tiny_port.crop_multiple = dav2.PATCH  # as the full-size builder's


def _condition(model):
    """depth = 3 exp(0.1 conv): away from the objective's 1/z pole, and the
    aggregator's LayerScale and tokens drawn away from their near-zero init
    so that the blocks and the other frame move the depth."""
    with torch.no_grad():
        head = dict(model.named_modules())[HEAD]
        head.weight.mul_(0.1)
        head.bias.fill_(math.log(3.0))
        g = torch.Generator().manual_seed(99)
        for name, p in model.named_parameters():
            if name.endswith(".gamma") and "patch_embed" not in name:
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            elif name.endswith(("camera_token", "register_token", "register_tokens")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
            elif "_norm." in name:  # q_norm, k_norm
                p.add_(torch.randn(p.shape, generator=g) * 0.2)
    return model


def seeded(seed: int = 0) -> vggt.VGGT:
    return _condition(models.init_weights(tiny_port(), torch.Generator().manual_seed(seed)))


def _reference(port: torch.nn.Module) -> ref.VGGT:
    model = ref.build(TINY)
    model.load_state_dict(port.state_dict(), strict=True)
    return model


def _colors(frames: int, seed: int) -> torch.Tensor:
    return torch.rand(frames, 3, H, W, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def _counts():
    return dict(vggt.LAUNCHES), dav2.LAUNCHES["attention"]


def test_forward_matches_the_reference():
    port = seeded(1)
    x = _colors(4, 2)  # 2 pairs, view-major
    before = _counts()
    with torch.no_grad():
        got = port(x, views=2)
        want = _reference(port)(x)
    after = _counts()
    depth = TINY["depth"]
    assert {k: v - before[0][k] for k, v in after[0].items()} == {
        "frame_attention": depth, "global_attention": depth, "views": 4}
    assert after[1] - before[1] == depth  # the patch embedder's blocks
    assert got.shape == (4, 1, H, W) and got.dtype == torch.float32
    # float32 on both sides; sums in another order (SDPA against the
    # written-out softmax, the RoPE from tables against from its angles,
    # channels_last convolutions) through exp: a few ulps of the depth's
    # largest value
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    with torch.no_grad():
        depth_conf = port(x, views=2, confidence=True)
        conf = 1.0 + torch.exp(_reference(port).logits(x)[:, 1:])
    assert torch.equal(depth_conf[0], got)
    torch.testing.assert_close(depth_conf[1], conf, rtol=1e-5, atol=1e-5 * float(conf.max()))


def test_the_first_gradient_matches_the_reference():
    port = seeded(2)
    model = _reference(port)
    x = _colors(4, 3)
    grads = []
    for net in (port, model):
        names, params = zip(*net.named_parameters())
        out = net(x, views=2)
        grads.append(dict(zip(names, torch.autograd.grad(out.log().square().mean(), params))))
    # float32 against float32 through 2 + 4 blocks and the head: a leaf's
    # gradient within 1e-4 of its norm, or of 1e-3 of the largest leaf's
    # for a leaf whose gradient is near 0 (conf's row of the last conv)
    got, want = grads
    assert set(got) == set(want)
    scale = max(float(g.norm()) for g in want.values())
    for name, b in want.items():
        assert float((got[name] - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-3 * scale), name


def test_the_checkpointed_reference_is_the_reference():
    port = seeded(3)
    plain, kept = _reference(port), _reference(port)
    kept.checkpoint_blocks = True
    x = _colors(4, 4)
    grads = []
    for model in (plain, kept):
        out = model(x)
        grads.append(torch.autograd.grad(out.square().mean(), list(model.parameters())))
        assert torch.equal(out, plain(x))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bfloat16_forward_stays_near_the_reference():
    port = seeded(4)
    x = _colors(4, 5)
    low = tiny_port(torch.bfloat16)
    low.load_state_dict(port.state_dict())
    with torch.no_grad():
        got, want = low(x, views=2), _reference(port)(x)
    # bfloat16 activations (2^-9 relative a rounding) through 6 blocks and
    # the head: within a few percent of the depth's spread over the frame
    gap = float((got - want).abs().mean() / (want - want.mean()).abs().mean())
    assert got.dtype == torch.float32 and gap < 0.1, gap


def test_three_train_steps_match_the_reference_objective():
    port = seeded(7)
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    batches = synthetic.train_batches(3, 2, H, W, 2**31 + 13, torch.device("cpu"))
    config = training.TrainConfig(compute_dtype=torch.float32, **HYPER)
    state = training.create_train_state(port)
    dcl = torch.tensor(HYPER["dcl_weight"])
    losses, first = [], None
    before = vggt.LAUNCHES["views"]
    for batch in batches:
        _, metrics = training.train_step(state, batch, dcl, config)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = [m.clone() for m in state.momentum]
    assert vggt.LAUNCHES["views"] - before == 3 * 4  # 2 pairs of 2 frames a step
    model = _reference(seeded(7))
    model.load_state_dict(initial, strict=True)
    out = objective.train_steps(model, batches, HYPER)
    # float32 against float32: the objective's sums over 56x70 frames, the
    # sampler and attention in another order. A leaf's first update within
    # 2e-3 of its norm, or of 1e-2 of the largest leaf's (conf's row of the
    # last conv gets no gradient)
    np.testing.assert_allclose(losses, out["losses"], rtol=2e-5)
    names = [n for n, _ in port.named_parameters()]
    scale = max(float(g.norm()) for g in out["first_update"].values())
    for name, got in zip(names, first):
        want = out["first_update"][name]
        assert float((got - want).norm()) <= 2e-3 * max(float(want.norm()), 1e-2 * scale), name
    # the change over three steps, within what float32 can hold of it
    for name, p in port.named_parameters():  # noqa: B007
        change = p.detach() - initial[name]
        ref_change = dict(model.named_parameters())[name].detach() - initial[name]
        spacing = float(np.linalg.norm(np.spacing(initial[name].numpy())))
        assert float((change - ref_change).norm()) <= (1e-3 * float(ref_change.norm())
                                                       + 2 * spacing), name


def test_frame_2_moves_frame_1s_depth_and_not_in_depth_anything():
    port = seeded(8)
    x = _colors(4, 9)
    moved = x.clone()
    moved[2:] = _colors(2, 10)  # frame 2 of both pairs
    with torch.no_grad():
        a, b = port(x, views=2), port(moved, views=2)
        alone = port(x, views=1)
    # frame 1's depth depends on its partner through global attention, in
    # every pair; as one-view sequences it does not
    for i in range(2):
        assert float((a[i] - b[i]).abs().max()) > 1e-3 * float(a[i].abs().max())
    with torch.no_grad():
        assert torch.equal(port(moved, views=1)[:2], alone[:2])
    dav = models.init_weights(dav2.DepthAnythingV2(64, 4, 4, 4.0, (0, 1, 2, 3), 16,
                                                   (8, 16, 32, 32), 42),
                              torch.Generator().manual_seed(11))
    with torch.no_grad():
        assert torch.allclose(dav(x)[:2], dav(moved)[:2], rtol=0, atol=1e-6)


def test_one_view_global_attention_is_frame_attention():
    """With one view a global block sees the same (frames, P, C) tokens and
    the same positions as a frame block: a global block given the frame
    block's weights computes what the frame block does, and each frame's
    depth is the reference's for that frame alone."""
    port = seeded(12)
    with torch.no_grad():
        for frame, glob in zip(port.aggregator.frame_blocks, port.aggregator.global_blocks):
            glob.load_state_dict(frame.state_dict())
    x = _colors(3, 13)
    tokens = torch.randn(3, 5 + 20, TINY["embed_dim"], generator=torch.Generator().manual_seed(1))
    rope = tuple(t for t in vggt.rope_tables(4, 5, 5, 16))
    block = port.aggregator.frame_blocks[0]
    with torch.no_grad():
        frame = block(tokens, rope)
        glob = port.aggregator.global_blocks[0](tokens.view(3, 25, -1), rope)
        assert torch.equal(frame, glob)
        got = port(x, views=1)
        want = torch.cat([_reference(port)(x[i:i + 1], views=1) for i in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _rotated(vec: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """One head vector (d,) at every position of a rows x cols grid and 5
    special tokens: (P, d) after the port's RoPE."""
    d = vec.shape[0]
    tables = vggt.rope_tables(rows, cols, 5, d)
    return dav2.rotate_pairs(vec.expand(5 + rows * cols, d), tables)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope_preserves_norms_and_scores_depend_on_offsets_only(head_dim):
    rows, cols = 6, 7
    g = torch.Generator().manual_seed(head_dim)
    q, k = torch.randn(head_dim, generator=g, dtype=torch.float64), \
        torch.randn(head_dim, generator=g, dtype=torch.float64)
    rq, rk = _rotated(q, rows, cols), _rotated(k, rows, cols)
    # a rotation in every channel pair: norms kept (float32 tables)
    torch.testing.assert_close(rq.norm(dim=-1), q.norm().expand(rq.shape[0]), rtol=1e-6, atol=0)
    scores = rq[5:] @ rk[5:].T
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    offsets = {}
    for i in range(rows * cols):
        for j in range(rows * cols):
            offsets.setdefault((int(r[i] - r[j]), int(c[i] - c[j])), []).append(
                float(scores[i, j]))
    spread = max(max(v) - min(v) for v in offsets.values())
    # q.k after RoPE is a function of the offset of the positions alone,
    # to the float32 tables' rounding at angles up to 8 radians
    assert spread < 1e-5 * float(q.norm() * k.norm()), spread
    # and it is the reference's, which turns by the angles themselves
    pos = torch.cat([torch.zeros(5, 2, dtype=torch.long),
                     torch.stack([r + 1, c + 1], -1)])[None]
    want = ref.rope_2d(q.float().expand(1, 1, 5 + rows * cols, head_dim), pos)[0, 0]
    torch.testing.assert_close(rq.float(), want, rtol=0, atol=1e-5 * float(q.norm()))


class _NoReadback(TorchDispatchMode):
    """Raises on any op that copies a tensor's value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith(("_local_scalar_dense", "item")):
            raise AssertionError(f"{func} reads a tensor back to the host")
        return func(*args, **(kwargs or {}))


def test_the_rope_tables_come_from_the_grid_alone():
    port = seeded(14)
    x = _colors(4, 15)
    vggt._TABLES.clear()
    with torch.no_grad(), _NoReadback():
        port(x, views=2)
    # built from the integers (rows, cols) and the head size, once per
    # device and dtype, the global blocks' repeated over the views
    assert {k[:-2] for k in vggt._TABLES if k[0] == "rope"} == {
        ("rope", 4, 5, 5, 16), ("rope", 4, 5, 5, 16, 2)}
    cos, sin = vggt.rope_tables(4, 5, 5, 16)
    assert cos.dtype == sin.dtype == torch.float32 and cos.shape == (25, 16)
    assert torch.equal(cos[:5], torch.ones(5, 16))  # the special tokens at (0, 0)
    # with the probe, a plain read is caught
    with pytest.raises(AssertionError, match="host"), _NoReadback():
        int(x.max())


def test_row_splits_keep_pairs_whole():
    """``grad_accum``'s microbatches (rows m::n) and a rank's rows (a
    contiguous slice) hold whole pairs, so each pair's depth is the one the
    whole batch gives it."""
    port = seeded(16)
    batch = synthetic.train_batches(1, 4, H, W, 17, torch.device("cpu"))[0]
    with torch.no_grad():
        d1, d2 = training._forward_pair(port, batch)
        for rows in (slice(0, 4, 2), slice(1, 4, 2), slice(0, 2), slice(2, 4)):
            p1, p2 = training._forward_pair(port, {k: v[rows] for k, v in batch.items()})
            torch.testing.assert_close(p1, d1[rows], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(p2, d2[rows], rtol=1e-5, atol=1e-6)
    # a grad_accum=2 step's update is the mean of its two microbatches'
    config = training.TrainConfig(compute_dtype=torch.float32, **HYPER)
    dcl = torch.tensor(HYPER["dcl_weight"])
    state = training.create_train_state(seeded(16))
    training.train_step(state, batch, dcl, config, grad_accum=2)
    grads = []
    for m in range(2):
        model = seeded(16)
        d1, d2 = training._forward_pair(model.train(), {k: v[m::2] for k, v in batch.items()})
        loss, _ = training.compute_losses(d1, d2, {k: v[m::2] for k, v in batch.items()},
                                          config.sfl_weight, dcl, config.zero_division_epsilon)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    mean = [0.5 * (a + b) for a, b in zip(*grads)]
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in mean)))
    factor = 1.0 if norm < config.grad_clip_norm else config.grad_clip_norm / norm
    for got, g in zip(state.momentum, mean):
        torch.testing.assert_close(got, g * factor, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("views", [1, 2])
def test_every_gradient_comes_back_in_its_parameters_layout(views):
    """The optimizer's kernel reads a gradient that is its parameter's
    layout or a dense permutation of it, and copies anything else first
    (``ops/sgd_update.RESTRIDED``): the camera and register tokens, taken
    a view at a time, must come back dense too."""
    from endoscopydepthestimation_pytorch_tpu_torch.ops import sgd_update
    low = tiny_port(torch.bfloat16)
    low.load_state_dict(seeded(19).state_dict())
    names, params = zip(*low.named_parameters())
    out = low(_colors(4, 20).contiguous(memory_format=torch.channels_last), views=views)
    grads = torch.autograd.grad(out.log().mean(), params)
    copied = [n for n, p, g in zip(names, params, grads)
              if sgd_update._layout(tuple(p.shape), p.stride(), g.stride()) is sgd_update._COPY]
    assert copied == []


def test_full_size_network_matches_the_configuration():
    with torch.device("meta"):
        model = models.VGGT1B(dtype=torch.bfloat16)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == CONFIG["parameters"] == 941_765_858
    assert len(params) == CONFIG["parameter_tensors"]
    assert sum(CONFIG["parameters_by_part"].values()) == CONFIG["parameters"]
    agg = model.aggregator
    assert agg.patch_embed.pos_embed.shape == (1, 1 + 37 * 37, 1024)
    assert agg.camera_token.shape == (1, 2, 1, 1024)
    assert agg.register_token.shape == (1, 2, 4, 1024)
    assert agg.patch_embed.register_tokens.shape == (1, 4, 1024)
    assert agg.frame_blocks[0].norm1.eps == 1e-5 and agg.patch_embed.blocks[0].norm1.eps == 1e-6
    assert agg.frame_blocks[0].attn.q_norm.normalized_shape == (64,)
    assert agg.frame_blocks[0].ls1.init_values == 0.01
    upstream = {k.format(i=i) for k in CONFIG["upstream_keys"]
                for i in (range(CONFIG["depth"]) if "{i}" in k else [0])}
    assert set(model.state_dict()) == upstream - set(vggt.UNUSED_UPSTREAM_KEYS)
    assert set(vggt.UNUSED_UPSTREAM_KEYS) <= upstream
    # one C call of the optimizer takes it: under 2^30 elements
    assert CONFIG["parameters"] < 2**30
    with torch.device("meta"):
        out = model(torch.zeros(8, 3, 420, 518), views=2)
        assert out.shape == (8, 1, 420, 518)
        with pytest.raises(ValueError, match="multiples of 14"):
            model(torch.zeros(2, 3, 420, 512), views=2)
        with pytest.raises(ValueError, match="whole sequences"):
            model(torch.zeros(3, 3, 420, 518), views=2)


def test_the_forward_opens_its_spans_under_forward():
    port = seeded(18)
    batch = synthetic.train_batches(1, 1, H, W, 5, torch.device("cpu"))[0]
    state = training.create_train_state(port)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        training.train_step(state, batch, torch.tensor(5.0),
                            training.TrainConfig(compute_dtype=torch.float32))
    records = profiling.sessions()[-1].records
    unit = max(r.unit for r in records)
    spans = {(r.name, r.parent) for r in records if r.unit == unit}
    assert {("patch_embed", "forward"), ("aggregator", "forward"),
            ("depth_head", "forward")} <= spans


# -- the trainer, the evaluate CLI and the predictor ---------------------------

def _trainer_argv(data, out, *extra):
    return ["--adjacent_range", "1", "3", "--id_range", "1", "2",
            "--input_size", "70", "70", "--batch_size", "2", "--num_iter", "4",
            "--number_epoch", "0", "--display_interval", "1", "--log_interval", "1",
            "--num_workers", "2", "--num_pre_workers", "1",
            "--training_patient_id", "1", "--testing_patient_id", "1",
            "--validation_patient_id", "1", "--compute_dtype", "float32",
            "--architecture", "vggt_1b", "--network_downsampling", "14",
            "--training_data_root", str(data), "--training_result_root", str(out),
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra,message", [
    (("--act8",), "applies only to FC-DenseNet, not to VGGT"),
    (("--remat",), "applies only to FC-DenseNet, not to VGGT"),
    (("--block_engine",), "applies only to FC-DenseNet, not to VGGT"),
    (("--network_downsampling", "64"), "crops whose sides are multiples of 14"),
    (("--input_size", "420", "512"), "crops whose sides are multiples of 14")])
def test_trainer_refuses_what_the_architecture_cannot_take(tmp_path, extra, message):
    argv = _trainer_argv(tmp_path / "none", tmp_path / "out", *extra)
    with pytest.raises(ValueError, match=message):
        train.main(argv)
    assert not (tmp_path / "out").exists()  # refused before anything was written


def test_the_published_input_passes_the_crop_rule():
    models.check_crop("vggt_1b", 14, (420, 518))
    assert models.fixed_input_size("vggt_1b") is None


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the trainer on the tiny network (2 steps of 2 pairs,
    then validation and a checkpoint), on a 72x72 sequence (raw 288x288,
    downsampled by 4) whose crop, rounded up to a multiple of 14, is
    70x70."""
    root = tmp_path_factory.mktemp("vggt")
    folder = write_sequence(root / "data", seed=9, height=288, width=288)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.ARCHITECTURES, "vggt_1b", tiny_port)
        init = models.init_weights
        mp.setattr(train, "init_weights", lambda m, g: _condition(init(m, g)))
        before = dict(vggt.LAUNCHES)
        with contextlib.redirect_stdout(io.StringIO()):
            run = train.main(_trainer_argv(root / "data", root / "out"))
        counts = {k: v - before[k] for k, v in vggt.LAUNCHES.items()}
    return root, folder, run, counts


def test_trainer_trains_it_through_train_step(trained):
    _, _, run, counts = trained
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert isinstance(run.state.model, vggt.VGGT)
    assert int(run.state.step) == 2 and len(run.checkpoints) == 1
    # 2 train forwards of 2 pairs and at least one validation forward; a
    # frame and a global call a pair of blocks a forward
    assert counts["views"] >= 3 * 4 and counts["views"] % 2 == 0
    assert counts["frame_attention"] == counts["global_attention"] >= 3 * TINY["depth"]
    saved = torch.load(run.checkpoints[0], map_location="cpu", weights_only=True)["model"]
    assert {k.removeprefix("module.") for k in saved} == set(run.state.model.state_dict())


def test_evaluate_and_the_predictor_serve_it(trained, monkeypatch):
    root, folder, run, _ = trained
    monkeypatch.setitem(models.ARCHITECTURES, "vggt_1b", tiny_port)
    argv = ["--adjacent_range", "1", "3", "--id_range", "1", "2", "--input_size", "70", "70",
            "--batch_size", "1", "--num_workers", "1", "--num_pre_workers", "1",
            "--testing_patient_id", "1", "--load_all_frames",
            "--trained_model_path", str(run.checkpoints[0]), "--sequence_root", str(folder),
            "--evaluation_result_root", str(root / "eval"),
            "--evaluation_data_root", str(root / "data"), "--phase", "test",
            "--architecture", "vggt_1b", "--network_downsampling", "14", "--device", "cpu"]
    printed = io.StringIO()
    before = vggt.LAUNCHES["views"]
    with contextlib.redirect_stdout(printed):
        result = evaluate.main(argv)
    assert result.frames > 0 and len(list(result.log_root.glob("*.ply"))) == result.frames
    assert vggt.LAUNCHES["views"] - before == result.frames  # a frame a forward
    assert re.search(r"depth range \[", printed.getvalue())

    sequence = chip_smoke.synthetic_sequence(H, W)
    predictor = serving.DepthPredictor(run.checkpoints[0], sequence, batch_size=1,
                                       downsampling=1.0, device="cpu", dtype=torch.float32,
                                       architecture="vggt_1b")
    frame = np.random.RandomState(3).randint(
        0, 256, (H + 2 * chip_smoke.MARGIN, W + 2 * chip_smoke.MARGIN, 3)).astype(np.uint8)
    depth = predictor.predict_frame(frame)
    model = tiny_port()
    ckpt.load_any_checkpoint(run.checkpoints[0], model)
    colors = torch.from_numpy(predictor.prepare(frame))[None]
    boundary = predictor._boundary[:1]
    with torch.no_grad():
        # a frame is a one-view sequence: the reference's own one-view forward
        want = _reference(model)((colors * boundary).permute(0, 3, 1, 2), views=1)[0, 0]
    assert depth.shape == (H, W)
    np.testing.assert_allclose(depth, (want * boundary[0, ..., 0]).numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# -- the shared ViT code: Depth Anything V2 and Depth Pro as they were -------

# sha256 (first 16 hex digits) of each network's depth and the gradients of
# mean(depth^2), one CPU thread, seeded as ``_digests`` seeds them, taken on
# the tree before the shared ViT code gained its VGGT options
DIGESTS = {"dav2l.float32": "580f6b25a797e1f0", "dav2l.bfloat16": "56ecde9309c3d6a3",
           "dpro.float32": "af5e22b2da8f4be4", "dpro.bfloat16": "8de6904dcb259048"}


def _digest(name: str, dtype: torch.dtype) -> str:
    if name == "dav2l":
        model = dav2.DepthAnythingV2(embed_dim=64, depth=4, num_heads=4, layer_idx=(0, 1, 2, 3),
                                     features=16, out_channels=(8, 16, 32, 32), img_size=42,
                                     dtype=dtype)
        x = torch.rand(2, 3, 56, 70, generator=torch.Generator().manual_seed(21)) * 2 - 1
        head = "depth_head.scratch.output_conv2.2"
    else:
        model = dp.DepthPro(32, 2, 2, 4.0, 128, 16, (8, 8, 16, 16), 8, (0, 1), dtype=dtype)
        x = torch.rand(1, 3, 512, 512, generator=torch.Generator().manual_seed(22)) * 2 - 1
        head = "head.4"
    models.init_weights(model, torch.Generator().manual_seed(23))
    with torch.no_grad():
        conv = dict(model.named_modules())[head]
        conv.weight.mul_(0.1)
        conv.bias.fill_(3.0)
    depth = model(x)
    grads = torch.autograd.grad(depth.square().mean(), list(model.parameters()))
    h = hashlib.sha256(depth.detach().numpy().tobytes())
    for g in grads:
        h.update(g.float().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_depth_anything_and_depth_pro_are_bitwise_what_they_were(key):
    name, dtype = key.split(".")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one summation order
    try:
        assert _digest(name, getattr(torch, dtype)) == DIGESTS[key]
    finally:
        torch.set_num_threads(threads)
