"""The port's EM-tracker suite (``data/tracker.py``) against the JAX
package's, on the same synthetic pose files: twins of the five tracker
tests in tests/test_aux.py, each also held equal to the JAX function's
output (numpy only, so equal bit for bit, files byte for byte)."""
import cv2
import numpy as np
import pytest

from endoscopydepthestimation_pytorch_tpu.data import tracker as jtracker
from endoscopydepthestimation_pytorch_tpu_torch.data import tracker


def _write_tracker_root(root):
    """A pose stream (header + rows 'a,b,c,d,e,x,y,z,qx,qy,qz,qw'), its
    frame indexes (two poses on frame 10, none on 12) and two frames."""
    root.mkdir(parents=True)
    lines = ["header"]
    for i, frame in enumerate([10, 10, 14, 30]):
        lines.append(f"0,0,0,0,0,{i + 1}.0,0.0,0.{i},0.1,0.0,0.{i},1.0")
    (root / "poses").write_text("\n".join(lines) + "\n")
    (root / "pose_corresponding_image_indexes").write_text(
        "\n".join(f"{f}.0, 0.0" for f in [10, 10, 14, 30]) + "\n")
    img = np.zeros((8, 8, 3), np.uint8)
    for frame in [10, 12]:
        cv2.imwrite(str(root / f"{frame:08d}.jpg"), img)
    return root


@pytest.fixture()
def roots(tmp_path):
    return _write_tracker_root(tmp_path / "port"), _write_tracker_root(tmp_path / "jax")


def test_read_pose_messages_and_sync(roots):
    root, jroot = roots
    t, r = tracker.read_pose_messages_from_tracker(root / "poses")
    jt, jr = jtracker.read_pose_messages_from_tracker(jroot / "poses")
    assert len(t) == len(r) == 4
    np.testing.assert_allclose(t[1], [2.0, 0.0, 0.1])
    assert all(np.array_equal(a, b) for a, b in zip(t + r, jt + jr))

    tracker.synchronize_selected_calibration_poses(root)
    jtracker.synchronize_selected_calibration_poses(jroot)
    # frame 10 matched exactly (two poses averaged); frame 12 nearest (14)
    assert (root / "00000010.coords").read_text().startswith("1.50000,")
    names = sorted(p.name for p in jroot.glob("*.coords"))
    assert names == ["00000010.coords", "00000012.coords"]
    assert sorted(p.name for p in root.glob("*.coords")) == names
    for name in names:
        assert (root / name).read_bytes() == (jroot / name).read_bytes(), name


def test_read_initial_pose_file(tmp_path):
    (tmp_path / "init").write_text("7, 1.0, 2.0, 3.0, 1.0, 0.0, 0.0, 0.0\n"
                                   "3, -1.0, 0.5, 2.0, 0.9, 0.1, -0.2, 0.3\n")
    frames, trans, rots = tracker.read_initial_pose_file(tmp_path / "init")
    jframes, jtrans, jrots = jtracker.read_initial_pose_file(tmp_path / "init")
    assert frames == jframes == [3, 7]
    np.testing.assert_allclose(trans["00000007"], [1.0, 2.0, 3.0])
    np.testing.assert_allclose(rots["00000007"], np.diag([1.0, -1.0, -1.0]))
    assert sorted(trans) == sorted(jtrans) and sorted(rots) == sorted(jrots)
    for key in jtrans:
        assert np.array_equal(trans[key], jtrans[key])
        assert np.array_equal(rots[key], jrots[key])


def test_camera_to_tcp_transform(tmp_path):
    values = " ".join(str(float(i) * 1.5 - 2) for i in range(12))
    (tmp_path / "camera_to_tcp").write_text(values + "\n")
    r, t = tracker.read_camera_to_tcp_transform(tmp_path)
    jr, jt = jtracker.read_camera_to_tcp_transform(tmp_path)
    np.testing.assert_allclose(r[0], [-2.0, -0.5, 1.0])
    np.testing.assert_allclose(t[:, 0], [2.5, 8.5, 14.5])
    assert np.array_equal(r, jr) and np.array_equal(t, jt)


@pytest.mark.parametrize("downsampling,thresholds", [(1, (None, None)), (2, (60, 100))])
def test_point_cloud_with_initial_pose_transforms_frame(downsampling, thresholds):
    rng = np.random.RandomState(0)
    depth = rng.uniform(1.0, 2.0, (6, 8)).astype(np.float32)
    color = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
    mask = np.ones((6, 8), np.float32)
    k = np.array([[10.0, 0, 4], [0, 10.0, 3], [0, 0, 1]])
    c, s = np.cos(0.3), np.sin(0.3)
    rotation = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    translation = np.array([100.0, 0.0, 0.0])
    args = (depth, color, mask, k, translation, rotation, downsampling, *thresholds)
    cloud = tracker.point_cloud_from_depth_and_initial_pose(*args)
    want = jtracker.point_cloud_from_depth_and_initial_pose(*args)
    assert cloud.shape[1] == 6 and cloud.shape[0] > 0
    assert (cloud[:, 0] > 50).all()  # shifted into the tracker frame
    assert cloud.dtype == want.dtype and np.array_equal(cloud, want)


@pytest.mark.parametrize("is_hsv", [False, True])
def test_write_test_output_with_initial_pose(tmp_path, is_hsv):
    rng = np.random.RandomState(1)
    colors = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    depths = rng.uniform(1.0, 2.0, (2, 8, 8, 1)).astype(np.float32)
    boundaries = np.ones((2, 8, 8, 1), np.float32)
    k = np.tile(np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]]), (2, 1, 1))
    names = ["00000001", "00000002"]
    poses = dict(translation_dict={n: rng.randn(3) for n in names},
                 rotation_dict={n: np.eye(3) for n in names})
    for fn, out in ((tracker.write_test_output_with_initial_pose, tmp_path / "port"),
                    (jtracker.write_test_output_with_initial_pose, tmp_path / "jax")):
        out.mkdir()
        fn(out, colors, depths, boundaries, k, is_hsv=is_hsv, image_indexes=names, **poses)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(f"test_{kind}_{n}.{ext}" for n in names for kind, ext in
                           (("point_cloud", "ply"), ("color", "jpg"), ("depth", "jpg")))
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
