"""The port's evaluation CLI (``python -m
endoscopydepthestimation_pytorch_tpu_torch.evaluate``) against the JAX
package's root ``evaluate.py``, on the CPU in f32.

Both CLIs load one reference-format ``.pt``, written once by the JAX
package's ``export_torch_checkpoint`` from a seeded FCDenseNet-57 with
non-trivial BN statistics and the conditioned head (x0.1, bias +3, as
tests/test_torch_training.py explains), and read one seeded synthetic SfM
sequence (tests/torch_sfm_sequence.py: 8 frames, a 64x64 crop). JAX runs
its packed XLA conv at this size, the port K1's plain version: the same
function in f32. Validation at batch 3 (batches of 3, 3 and a ragged 2),
then the test phase in RGB and in HSV; one run of each CLI per phase
(module-scoped). Tolerances: ``metrics.json`` and each batch's printed
loss at rtol 1e-4; PLY xyz at rtol 1e-4 / atol 1e-5 and colors equal;
PNGs of equal shape with >= 99.9% of the pixels within 1 level (a depth
colormap level or an HSV flow level flips where f32 noise crosses a
quantization step).

Beside the CLI: the modules it reads (``point_cloud_from_depth``,
``validation_panel``, ``write_depth_outputs``, ``pad_batch_to``) against
JAX's, and ``SfMDataset`` against the JAX loader bit for bit in the
validation and test phases, in RGB and in HSV.
"""
import contextlib
import io
import json
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import evaluate as jevaluate
from endoscopydepthestimation_pytorch_tpu.data import dataset as jdataset
from endoscopydepthestimation_pytorch_tpu.data import native as jnative
from endoscopydepthestimation_pytorch_tpu.models import FCDenseNet57 as JaxFCDenseNet57
from endoscopydepthestimation_pytorch_tpu.parallel import pad_batch_to as jpad_batch_to
from endoscopydepthestimation_pytorch_tpu.utils import checkpoint as jckpt
from endoscopydepthestimation_pytorch_tpu.utils import pointcloud as jpointcloud
from endoscopydepthestimation_pytorch_tpu.utils import visualization as jviz
from endoscopydepthestimation_pytorch_tpu_torch import evaluate
from endoscopydepthestimation_pytorch_tpu_torch.data import dataset, readers
from endoscopydepthestimation_pytorch_tpu_torch.parallel import pad_batch_to
from endoscopydepthestimation_pytorch_tpu_torch.utils import plyio, pointcloud
from endoscopydepthestimation_pytorch_tpu_torch.utils import visualization as viz

from test_torch_training import _conditioned
from torch_port_cases import seeded_jax_state
from torch_sfm_sequence import write_sequence

N_FRAMES = 8
BATCH = 3  # 8 frames: batches of 3, 3 and 2


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_rasterizer():
    """The JAX loader on its numpy rasterizer (bit for bit its native
    one), so that no two test workers build the JAX package's native
    library at once."""
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    yield
    jnative._lib, jnative._tried = saved


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    folder = write_sequence(root / "data", seed=5, n_frames=N_FRAMES)
    state = _conditioned(seeded_jax_state(JaxFCDenseNet57(n_classes=1), (1, 64, 64, 3),
                                          seed=11))
    checkpoint = root / "model.pt"
    jckpt.export_torch_checkpoint(checkpoint, state, epoch=3)
    return root, folder, checkpoint


def _argv(sequence, out, phase, *extra):
    root, folder, checkpoint = sequence
    return ["--adjacent_range", "1", "3", "--id_range", "1", "2",
            "--input_size", "64", "64", "--batch_size", str(BATCH),
            "--num_workers", "2", "--num_pre_workers", "1",
            "--testing_patient_id", "1", "--load_all_frames",
            "--trained_model_path", str(checkpoint), "--sequence_root", str(folder),
            "--evaluation_result_root", str(out),
            "--evaluation_data_root", str(root / "data"), "--phase", phase, *extra]


def _run(main, argv):
    """Run one CLI; returns (its result folder, what it printed, what it
    returned)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = main(argv)
    text = printed.getvalue()
    (log_root,) = re.findall(r"^Results at (.+)$", text, re.M)
    return Path(log_root), text, result


@pytest.fixture(scope="module")
def runs(sequence):
    """{phase: (JAX (result folder, output, None), port's (..., EvalRun))}."""
    root = sequence[0]
    out = {}
    for phase, extra in (("validation", ()), ("test", ()),
                         ("test_hsv", ("--use_hsv_colorspace",))):
        argv = lambda who: _argv(sequence, root / who / phase, phase.split("_")[0],
                                 *extra)
        out[phase] = (_run(jevaluate.main, argv("jax")),
                      _run(evaluate.main, argv("port") + ["--device", "cpu"]))
    return out


def _losses(text):
    return [float(v) for v in re.findall(r"^batch \d+: loss (\S+)$", text, re.M)]


def _assert_clouds_match(got_path, want_path):
    got, want = plyio.read_ply_vertices(got_path), plyio.read_ply_vertices(want_path)
    assert got.dtype.names == want.dtype.names and got.shape == want.shape
    assert got.shape[0] > 0
    for axis in "xyz":
        np.testing.assert_allclose(got[axis], want[axis], rtol=1e-4, atol=1e-5,
                                   err_msg=axis)
    for channel in ("red", "green", "blue"):
        assert np.array_equal(got[channel], want[channel]), channel


def _assert_images_match(got_path, want_path):
    got, want = cv2.imread(str(got_path)), cv2.imread(str(want_path))
    assert got is not None and want is not None
    assert got.shape == want.shape
    close = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1) <= 1
    assert close.mean() >= 0.999, f"{got_path.name}: {close.mean():.5f} within 1 level"


def test_validation_metrics_and_losses_match_jax(runs):
    (jroot, jtext, _), (root, text, run) = runs["validation"]
    got = json.loads((root / "metrics.json").read_text())
    assert run.log_root == root and run.metrics == got
    assert run.frames == N_FRAMES and len(run.ms) == 3
    want = json.loads((jroot / "metrics.json").read_text())
    assert sorted(got) == sorted(want) == ["abs_rel", "sigma_1.25", "sigma_1.25^2",
                                           "sigma_1.25^3"]
    for key, value in want.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
    assert len(_losses(text)) == len(_losses(jtext)) == 3  # 3, 3 and the ragged 2
    np.testing.assert_allclose(_losses(text), _losses(jtext), rtol=1e-4)
    # the JAX CLI's folder name, stamped with the month, day, hour and minute
    name = r"depth_estimation_evaluation_run_\d+_\d+_\d+_\d+_test_id_1"
    assert re.fullmatch(name, root.name) and re.fullmatch(name, jroot.name)


def test_validation_clouds_and_boards_match_jax(runs):
    (jroot, _, _), (root, _, _) = runs["validation"]
    for batch in range(3):
        _assert_clouds_match(root / f"{batch}.ply", jroot / f"{batch}.ply")
        _assert_images_match(root / f"{batch}.png", jroot / f"{batch}.png")
    # two 6-panel rows of 3 samples (2 in the last batch) at 64x64
    assert cv2.imread(str(root / "0.png")).shape == (12 * 68, 3 * 66 + 2, 3)


@pytest.mark.parametrize("phase", ["test", "test_hsv"])
def test_test_phase_matches_jax(runs, phase):
    (jroot, _, _), (root, text, run) = runs[phase]
    names = sorted(p.stem for p in jroot.glob("*.ply"))
    assert len(names) == N_FRAMES
    assert sorted(p.stem for p in root.glob("*.ply")) == names
    assert sorted(p.stem for p in root.glob("*.png")) == names
    for name in names:
        _assert_clouds_match(root / f"{name}.ply", jroot / f"{name}.ply")
        _assert_images_match(root / f"{name}.png", jroot / f"{name}.png")
    assert len(re.findall(r"^frame \d+: depth range", text, re.M)) == N_FRAMES
    assert run.metrics is None and run.frames == len(run.ms) == N_FRAMES


def test_hsv_run_shows_the_frames_colors(runs):
    """The HSV run converts its HSV input back with HSV2BGR_FULL: its
    cloud colors are the RGB run's up to the HSV round trip's quantization
    (<= 4 levels; a swapped conversion is off by far more), while its
    depth, predicted from HSV input, is not the RGB run's."""
    rgb, hsv = runs["test"][1][0], runs["test_hsv"][1][0]
    for name in sorted(p.stem for p in rgb.glob("*.ply")):
        a, b = (plyio.read_ply_vertices(r / f"{name}.ply") for r in (rgb, hsv))
        assert a.shape == b.shape
        for channel in ("red", "green", "blue"):
            diff = np.abs(a[channel].astype(int) - b[channel].astype(int))
            assert diff.max() <= 4, (name, channel)
        assert not np.allclose(a["z"], b["z"])


def test_packed_conv_raises(sequence, tmp_path):
    for flag in ("--packed_conv", "--no-packed_conv"):
        with pytest.raises(ValueError, match="ROADMAP"):
            evaluate.main(_argv(sequence, tmp_path / "out", "test", flag, "--device", "cpu"))
    assert not (tmp_path / "out").exists()


def test_evaluate_runs_on_the_card_unless_asked_for_the_cpu(sequence, tmp_path,
                                                             monkeypatch):
    argv = _argv(sequence, tmp_path / "out", "test")
    assert evaluate.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(argv)


def test_missing_checkpoint_raises(sequence, tmp_path):
    argv = _argv(sequence, tmp_path / "out", "test", "--device", "cpu")
    argv[argv.index("--trained_model_path") + 1] = str(tmp_path / "missing.pt")
    with pytest.raises(OSError, match="could not be found"):
        evaluate.main(argv)


# ---------------------------------------------------------------------------
# the modules the CLI reads
# ---------------------------------------------------------------------------

def _depth_case(seed=0, h=20, w=24):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    color = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = (rng.rand(h, w) > 0.3).astype(np.float32)
    k = np.array([[30.0, 0, w / 2 + 0.3], [0, 28.0, h / 2 - 0.2], [0, 0, 1]])
    return depth, color, mask, k


@pytest.mark.parametrize("downsampling,thresholds", [
    (1, (None, None)), (3, (None, None)), (1, (60, 200)), (2, (100, 120))])
def test_point_cloud_from_depth_matches_jax(downsampling, thresholds):
    depth, color, mask, k = _depth_case()
    got = pointcloud.point_cloud_from_depth(depth, color, mask, k, downsampling,
                                            *thresholds)
    want = jpointcloud.point_cloud_from_depth(depth, color, mask, k, downsampling,
                                              *thresholds)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] > 0 and np.array_equal(got, want)


def test_validation_panel_matches_jax():
    rng = np.random.RandomState(1)
    b, h, w = 2, 16, 20
    args = (rng.uniform(-1, 1, (b, h, w, 3)), rng.uniform(0, 2, (b, h, w, 1)),
            rng.uniform(0.5, 2, (b, h, w, 1)), rng.uniform(0, 2, (b, h, w, 1)),
            rng.randn(b, h, w, 2), rng.randn(b, h, w, 2),
            (rng.rand(b, h, w, 1) > 0.2).astype(np.float32))
    args = tuple(a.astype(np.float32) for a in args)
    for is_hsv in (False, True):
        got = viz.validation_panel(*args, is_hsv=is_hsv)
        want = jviz.validation_panel(*args, is_hsv=is_hsv)
        assert len(got) == len(want) == 6
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and np.array_equal(g, w_)


@pytest.mark.parametrize("is_hsv", [False, True])
def test_write_depth_outputs_matches_jax(tmp_path, is_hsv):
    rng = np.random.RandomState(2)
    b, h, w = 2, 12, 16
    colors = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    depths = rng.uniform(0.5, 2, (b, h, w, 1)).astype(np.float32)
    boundaries = (rng.rand(b, h, w, 1) > 0.2).astype(np.float32)
    k = np.tile(np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]]), (b, 1, 1))
    viz.write_depth_outputs(tmp_path / "port", colors, depths, boundaries, k,
                            prefix="v_", is_hsv=is_hsv, point_cloud_downsampling=2)
    jviz.write_depth_outputs(tmp_path / "jax", colors, depths, boundaries, k,
                             prefix="v_", is_hsv=is_hsv, point_cloud_downsampling=2)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 6 and sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        got, want = ((tmp_path / who / name).read_bytes() for who in ("port", "jax"))
        assert got == want, name


@pytest.mark.parametrize("rows", [1, 3, 4])
def test_pad_batch_to_matches_jax(rows):
    rng = np.random.RandomState(rows)
    batch = {"color_1": rng.randn(rows, 4, 5, 3).astype(np.float32),
             "intrinsic": rng.randn(rows, 3, 3).astype(np.float32),
             "names": [f"{i:08d}" for i in range(rows)]}
    got, want = pad_batch_to(batch, 4), jpad_batch_to(batch, 4)
    assert sorted(got) == sorted(want) and got["_valid"] == want["_valid"] == rows
    assert got["names"] == want["names"] == batch["names"]
    for key in ("color_1", "intrinsic"):
        assert got[key].shape[0] == 4 and np.array_equal(got[key], want[key])
        assert np.array_equal(got[key][rows:], np.repeat(batch[key][-1:], 4 - rows, 0))


@pytest.mark.parametrize("phase,is_hsv", [("validation", False), ("test", False),
                                          ("validation", True), ("test", True)])
def test_dataset_matches_jax(sequence, tmp_path, phase, is_hsv):
    """The evaluate CLI's dataset: the validation phase through
    ``BatchLoader(shuffle=False, drop_last=False)`` and the test phase
    sample by sample, every array equal bit for bit, and the names."""
    root, folder, _ = sequence
    files = readers.get_filenames_from_frame_indexes(
        folder, readers.read_visible_view_indexes(folder))
    kw = dict(image_file_names=files,
              folder_list=readers.get_parent_folder_names(root / "data", [1, 2]),
              adjacent_range=[1, 3], transform=None, downsampling=4.0,
              network_downsampling=64, inlier_percentage=0.995, visible_interval=30,
              use_store_data=False, phase=phase, is_hsv=is_hsv, num_pre_workers=1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want_set = jdataset.SfMDataset(store_data_root=tmp_path / "jax",
                                   use_native_rasterizer=False, **kw)
    got_set = dataset.SfMDataset(store_data_root=tmp_path / "port", **kw)
    if phase == "validation":
        want = list(jdataset.BatchLoader(want_set, BATCH, shuffle=False, drop_last=False,
                                         num_workers=2))
        got = list(dataset.BatchLoader(got_set, BATCH, shuffle=False, drop_last=False,
                                       num_workers=2))
        assert [len(b["color_1"]) for b in got] == [3, 3, 2]
    else:
        want = [want_set[i] for i in range(len(want_set))]
        got = [got_set[i] for i in range(len(got_set))]
        assert len(got) == N_FRAMES
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert g[key].dtype == value.dtype and np.array_equal(g[key], value), key
            else:
                assert g[key] == value, key
