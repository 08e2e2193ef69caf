"""The port's data path against the JAX package's, on the CPU, on a seeded
synthetic SfM sequence (tests/torch_sfm_sequence.py: 8 frames of raw
256x256, 300 points; a 64x64 crop at downsampling 4).

Readers, the precompute (``SequenceData`` field by field) and the
precompute pickle are held equal to the JAX package's (the pickle read
across in both directions); the native rasterizer equal bit for bit to
the numpy ``rasterize_pair``; ``TrainingAugmentation`` and ``BatchLoader``
batches equal bit for bit to the JAX loader's for the same seed and
epoch (the JAX loader on its numpy rasterizer, so that no two test
workers build the JAX package's native library at once). The slice as a
whole: each package's first batch through one f32 train step from the
same weights, loss, SFL and DCL at rtol 1e-4 (as
``test_grad_accum_2_matches_jax`` holds them).
"""
import copy
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopydepthestimation_pytorch_tpu import training as jtraining
from endoscopydepthestimation_pytorch_tpu.data import augment as jaugment
from endoscopydepthestimation_pytorch_tpu.data import dataset as jdataset
from endoscopydepthestimation_pytorch_tpu.data import preprocess as jpreprocess
from endoscopydepthestimation_pytorch_tpu.data import readers as jreaders
from endoscopydepthestimation_pytorch_tpu.models.fcdensenet import FCDenseNet as JaxFCDenseNet
from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.data import (augment, dataset, native,
                                                           preprocess, rasterizer, readers)
from endoscopydepthestimation_pytorch_tpu_torch.models import FCDenseNet
from endoscopydepthestimation_pytorch_tpu_torch.parallel import device_prefetch
from endoscopydepthestimation_pytorch_tpu_torch.utils import plyio

from test_torch_training import (CONFIG, DCL, JCONFIG, TINY, TINY_ARCH, _conditioned,
                                 _port_model)
from torch_port_cases import seeded_jax_state
from torch_sfm_sequence import write_sequence

PRE = dict(downsampling=4.0, network_downsampling=64, is_hsv=False,
           inlier_percentage=0.99, visible_interval=30)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sfm")
    write_sequence(root, seed=3)
    return root


@pytest.fixture(scope="module")
def folder(data_root):
    (folder,) = readers.get_parent_folder_names(data_root, [1, 2])
    return folder


@pytest.fixture(scope="module")
def sequences(folder):
    """(JAX, port) ``SequenceData`` of the sequence."""
    args = (folder, *PRE.values(), 64, 64)
    return jpreprocess.preprocess_sequence(*args), preprocess.preprocess_sequence(*args)


READERS = {
    "selected_indexes": lambda m, f: m.read_selected_indexes(f),
    "visible_view_indexes": lambda m, f: m.read_visible_view_indexes(f),
    "intrinsics": lambda m, f: m.read_camera_intrinsic_per_view(f),
    "view_indexes_per_point": lambda m, f: m.read_view_indexes_per_point(
        f, m.read_visible_view_indexes(f), 300),
    "poses": lambda m, f: m.get_extrinsic_matrix_and_projection_matrix(
        m.read_pose_data(f), m.read_camera_intrinsic_per_view(f)[0], 8),
    "point_cloud": lambda m, f: m.read_point_cloud(f / "structure.ply"),
    "color_files": lambda m, f: m.get_color_file_names_by_bag(f.parents[1], 1, 1, 1),
    "folders": lambda m, f: m.get_parent_folder_names(f.parents[1], [1, 2]),
    "visible_count": lambda m, f: m.get_visible_count_per_point(
        m.read_view_indexes_per_point(f, m.read_visible_view_indexes(f), 300)),
    "quaternion": lambda m, f: [m.quaternion_matrix(q) for q in
                                np.random.RandomState(0).randn(6, 4)],
    "ratio_split": lambda m, f: m.get_color_file_names(f.parents[1], (0.5, 0.25, 0.25)),
    "visible_image_indexes": lambda m, f: m.read_visible_image_path_list(f.parents[1]),
    "frame_files": lambda m, f: m.get_filenames_from_frame_indexes(f, [5, 1, 3]),
}


def _assert_same(got, want, what):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_same(g, w, what)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), what
    else:
        assert type(got) is type(want) and got == want, what


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_match_jax(folder, name):
    _assert_same(READERS[name](readers, folder), READERS[name](jreaders, folder), name)


def test_sequence_sees_its_points(sequences):
    """The writer's scene keeps almost every point clean and puts labels
    into every frame, so the dataset never has to resample."""
    _, seq = sequences
    assert seq.crop_positions == [0, 64, 0, 64]
    assert seq.clean_point_list.mean() > 0.9
    assert (seq.view_indexes_per_point > 0.5).sum(0).min() >= 150


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(preprocess.SequenceData)])
def test_precompute_matches_jax(sequences, field):
    want, got = (getattr(s, field) for s in sequences)
    _assert_same(got, want, field)


def test_precompute_pickle_crosses_between_packages(sequences, folder, tmp_path):
    """Both packages write the same pickle (the reference's 14-element
    layout of plain lists, arrays and dicts), and each reads the other's."""
    want, got = sequences
    ours, theirs = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    preprocess.save_precompute(ours, {str(folder): got}, 4.0, 64, 0.99)
    jpreprocess.save_precompute(theirs, {str(folder): want}, 4.0, 64, 0.99)
    assert ours.read_bytes() == theirs.read_bytes()
    for loaded in (jpreprocess.load_precompute(ours, [folder])[str(folder)],
                   preprocess.load_precompute(theirs, [folder])[str(folder)]):
        for field in dataclasses.fields(preprocess.SequenceData):
            _assert_same(getattr(loaded, field.name), getattr(want, field.name), field.name)


def test_precompute_in_spawned_workers_matches_in_process(tmp_path):
    """Two sequences through a pool of two spawned processes give what one
    process gives."""
    write_sequence(tmp_path, seed=4, segment=1)
    write_sequence(tmp_path, seed=5, segment=2, first_frame=20)
    folders = readers.get_parent_folder_names(tmp_path, [1, 2])
    assert len(folders) == 2
    pooled = preprocess.run_precompute(folders, *PRE.values(), num_workers=2)
    alone = preprocess.run_precompute(folders, *PRE.values(), num_workers=1)
    assert sorted(pooled) == sorted(alone) == sorted(str(f) for f in folders)
    for key in alone:
        for field in dataclasses.fields(preprocess.SequenceData):
            _assert_same(getattr(pooled[key], field.name), getattr(alone[key], field.name),
                         field.name)


def _pair_args(seq, a, b, clean=True):
    return dict(pair_extrinsics=[seq.extrinsics[a], seq.extrinsics[b]],
                pair_projections=[seq.projections[a], seq.projections[b]],
                pair_indexes=[seq.visible_view_indexes[a], seq.visible_view_indexes[b]],
                point_cloud=seq.point_cloud, mask_boundary=seq.mask_boundary,
                view_indexes_per_point=seq.view_indexes_per_point,
                clean_point_list=seq.clean_point_list if clean else np.zeros(0, np.float32),
                visible_view_indexes=seq.visible_view_indexes)


@pytest.mark.parametrize("a,b,clean", [(0, 3, True), (7, 4, True), (2, 3, False),
                                       (5, 0, False)])
def test_native_rasterizer_matches_numpy(sequences, a, b, clean):
    """Bit for bit, with the clean-point list and without, and the call is
    counted."""
    _, seq = sequences
    args = _pair_args(seq, a, b, clean)
    before = native.LAUNCHES
    got = native.rasterize_pair_native(**args)
    want = rasterizer.rasterize_pair(**args)
    assert native.LAUNCHES == before + 1
    assert want[0].sum() > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)


def test_native_rasterizer_build_raises_when_gxx_fails(tmp_path, monkeypatch):
    """No silent numpy fallback: a source g++ rejects raises with its
    output, and nothing is left in the build directory."""
    broken = tmp_path / "rasterizer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").iterdir())


def test_training_augmentation_matches_jax():
    """The same RandomState gives the same image in both packages, over
    enough seeds to take every branch."""
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
    for seed in range(60):
        got = augment.TrainingAugmentation(seed)(image)
        want = jaugment.TrainingAugmentation(seed)(image)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), seed


def _loaders(data_root, tmp_path, batch_size=2, num_workers=2):
    files, _, _ = readers.get_color_file_names_by_bag(data_root, 1, 1, 1)
    folders = readers.get_parent_folder_names(data_root, [1, 2])
    kw = dict(image_file_names=files, folder_list=folders, adjacent_range=[1, 3],
              downsampling=4.0, network_downsampling=64, inlier_percentage=0.99,
              visible_interval=30, use_store_data=False, phase="train",
              num_pre_workers=1, num_iter=6)
    want = jdataset.SfMDataset(transform=jaugment.TrainingAugmentation(seed=10085),
                               store_data_root=tmp_path / "jax",
                               use_native_rasterizer=False, **kw)
    got = dataset.SfMDataset(transform=augment.TrainingAugmentation(seed=10085),
                             store_data_root=tmp_path / "port", **kw)
    return (jdataset.BatchLoader(want, batch_size, shuffle=True, num_workers=num_workers),
            dataset.BatchLoader(got, batch_size, shuffle=True, num_workers=num_workers))


def test_batch_loader_matches_jax(data_root, tmp_path):
    """Two epochs, two worker threads: every array key equal bit for bit,
    and the folders and frame names."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want_loader, got_loader = _loaders(data_root, tmp_path)
    epochs = []
    for epoch in (0, 1):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                if isinstance(w[key], list):
                    assert g[key] == w[key], key
                else:
                    assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
        epochs.append(got)
    assert not np.array_equal(epochs[0][0]["color_1"], epochs[1][0]["color_1"])


def test_first_batch_train_step_matches_jax(data_root, tmp_path):
    """The slice as a whole: each package's loader's first batch through
    one f32 train step from the same (conditioned) weights."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want_loader, got_loader = _loaders(data_root, tmp_path)
    jbatch = {k: jnp.asarray(v) for k, v in next(iter(want_loader)).items()
              if isinstance(v, np.ndarray)}
    tbatch = next(device_prefetch(got_loader, "cpu"))
    assert sorted(tbatch) == sorted(jbatch)
    jstate = _conditioned(seeded_jax_state(JaxFCDenseNet(**TINY_ARCH), (4, 64, 64, 3),
                                           seed=6))
    state = training.create_train_state(
        copy.deepcopy(_port_model(jstate, FCDenseNet(**TINY_ARCH), **TINY)))
    _, jm = jax.jit(partial(jtraining.train_step, config=JCONFIG))(
        jax.tree.map(jnp.array, jstate), jbatch, jnp.float32(DCL))
    _, m = training.train_step(state, tbatch, torch.tensor(DCL), CONFIG)
    for key in ("loss", "sparse_flow_loss", "depth_consistency_loss"):
        assert np.isfinite(float(m[key]))
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert int(state.step) == int(state.count) == 1


def test_device_prefetch_on_the_cpu_keeps_the_arrays():
    batches = [{"a": np.arange(6, dtype=np.float32).reshape(2, 3), "names": ["x", "y"]},
               {"a": np.ones((2, 3), np.float32), "names": ["z", "w"]}]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert [sorted(b) for b in got] == [["a"], ["a"]]
    for g, b in zip(got, batches):
        assert g["a"].device.type == "cpu" and np.array_equal(g["a"].numpy(), b["a"])


def test_ply_ascii_roundtrip(tmp_path):
    cloud = np.random.RandomState(1).rand(5, 6) * [1, 1, 1, 255, 255, 255]
    plyio.write_point_cloud(tmp_path / "c.ply", cloud)
    points = plyio.read_point_cloud(tmp_path / "c.ply")
    np.testing.assert_allclose(points[:, :3], cloud[:, :3].astype(np.float32), rtol=1e-6)
    assert (points[:, 3] == 1).all()
