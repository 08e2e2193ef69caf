"""A frozen copy of ``tests/torch_sfm_sequence.py`` at commit 306000c (the
benchmark reads nothing of the tests).

A seeded synthetic SfM sequence on disk, in the layout the data path
reads (reference README.md:48): ``{:08d}.jpg`` frames, ``motion.yaml``
camera-to-world poses, ``structure.ply`` points, ``undistorted_mask.bmp``,
``selected_indexes``, ``visible_view_indexes``, ``view_indexes_per_point``
and ``camera_intrinsics_per_view``. numpy and cv2 only.

The scene is a gently slanted textured plane 2.8-3.2 in front of a camera
that moves forward and sideways. The points lie on the plane, seen through
the middle frame's pixels, and each point's visible frames are those it
projects into, by the writer's own poses and intrinsics, so every pair of
frames shares most of the points. Each frame is rendered with a brightness
proportional to texture / depth^2 (a light at the camera), so the
precompute's photometric sanity value depth^2 * brightness stays within a
narrow band and keeps most points clean; the writer asserts that every
frame sees at least half of the points. Each pixel's brightness comes
from its ray's hit on the plane (on a grid of at most ~320 columns,
resized up), so the frames agree with the geometry.
"""
from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

PLANE_DEPTH = 3.0
PLANE_SLOPE = (0.05, 0.03)   # dZ/dX, dZ/dY
TRAVEL = (0.15, 0.08, 0.35)  # camera motion over the whole sequence


def _rotation(angle: float, axis) -> np.ndarray:
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _quaternion(r: np.ndarray) -> np.ndarray:
    """[w, x, y, z] of a rotation matrix with w > 0 (small rotations)."""
    w = np.sqrt(max(1.0 + np.trace(r), 1e-12)) / 2
    return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w),
                     (r[1, 0] - r[0, 1]) / (4 * w)])


def _camera_to_world(i: int, n: int):
    t = i / max(n - 1, 1)
    rot = _rotation(np.deg2rad(3.0) * t, (0.3, 1.0, 0.1))
    return rot, np.asarray(TRAVEL) * t


def _plane_hit(origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """lambda along each ray to Z = PLANE_DEPTH + a X + b Y."""
    a, b = PLANE_SLOPE
    normal = np.array([-a, -b, 1.0])
    return (PLANE_DEPTH - normal @ origin) / (dirs @ normal)


def _texture(points: np.ndarray) -> np.ndarray:
    x, y = points[..., 0], points[..., 1]
    return 1.0 + 0.06 * np.sin(7.0 * x + 1.0) * np.sin(5.0 * y) + 0.04 * np.sin(13.0 * (x + y))


def _render(k: np.ndarray, rot: np.ndarray, center: np.ndarray, h: int, w: int):
    """BGR uint8 frame: brightness 150 * texture * (3 / depth)^2."""
    step = max(1, w // 320)
    if step > 1:
        small = _render(k / np.array([[step], [step], [1.0]]), rot, center,
                        h // step, w // step)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    v, u = np.mgrid[:h, :w].astype(np.float64)
    rays = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones_like(u)], -1)
    dirs = rays @ rot.T
    depth = _plane_hit(center, dirs)  # camera z, since rays have z = 1
    world = center + depth[..., None] * dirs
    level = 150.0 * _texture(world) * (PLANE_DEPTH / depth) ** 2
    bgr = level[..., None] * np.array([0.55, 0.7, 1.0])
    return np.clip(np.round(bgr), 0, 255).astype(np.uint8)


def _project(points: np.ndarray, k: np.ndarray, rot: np.ndarray, center: np.ndarray):
    cam = (points - center) @ rot  # world -> camera: R^T (X - c)
    return cam[:, 0] / cam[:, 2] * k[0, 0] + k[0, 2], cam[:, 1] / cam[:, 2] * k[1, 1] + k[1, 2], cam[:, 2]


def write_sequence(root, seed: int = 0, n_frames: int = 8, height: int = 256,
                   width: int = 256, n_points: int = 300, bag: str = "bag_1",
                   segment: int = 1, first_frame: int = 0) -> Path:
    """Write one sequence to ``root/bag/_start_..._segment_<segment>/`` and
    return that folder. ``height`` x ``width`` is the raw frame size;
    ``seed`` draws the points."""
    rng = np.random.RandomState(seed)
    frames = list(range(first_frame, first_frame + n_frames))
    folder = (Path(root) / bag /
              f"_start_{frames[0]:06d}_end_{frames[-1]:06d}_stride_1_segment_{segment}")
    folder.mkdir(parents=True, exist_ok=True)
    k = np.array([[0.8 * width, 0, width / 2], [0, 0.8 * width, height / 2], [0, 0, 1.0]])
    poses = [_camera_to_world(i, n_frames) for i in range(n_frames)]

    # points on the plane, seen through the middle frame's inner pixels
    rot_m, c_m = poses[n_frames // 2]
    u = rng.uniform(0.12, 0.88, n_points) * width
    v = rng.uniform(0.12, 0.88, n_points) * height
    dirs = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones(n_points)], -1) @ rot_m.T
    points = c_m + _plane_hit(c_m, dirs)[:, None] * dirs

    border = max(2, height // 32)
    visible = np.zeros((n_points, n_frames), bool)
    for i, (rot, center) in enumerate(poses):
        pu, pv, z = _project(points, k, rot, center)
        visible[:, i] = ((z > 0) & (pu >= 2 * border) & (pu <= width - 1 - 2 * border)
                         & (pv >= 2 * border) & (pv <= height - 1 - 2 * border))
        cv2.imwrite(str(folder / f"{frames[i]:08d}.jpg"), _render(k, rot, center, height, width))
    seen = visible.sum(0)
    assert seen.min() >= n_points // 2, f"frames see {seen.tolist()} of {n_points} points"

    mask = np.zeros((height, width), np.uint8)
    mask[border:height - border, border:width - border] = 255
    cv2.imwrite(str(folder / "undistorted_mask.bmp"), mask)
    (folder / "selected_indexes").write_text("".join(f"{i}\n" for i in frames))
    (folder / "visible_view_indexes").write_text("".join(f"{i}\n" for i in frames))
    (folder / "camera_intrinsics_per_view").write_text(
        "".join(f"{k[0, 0]:.17e}\n{k[1, 1]:.17e}\n{k[0, 2]:.17e}\n{k[1, 2]:.17e}\n"
                for _ in frames))
    lines = []
    for p in range(n_points):
        lines.append("-1\n")
        lines += [f"{frames[i]}\n" for i in np.flatnonzero(visible[p])]
    (folder / "view_indexes_per_point").write_text("".join(lines))

    yaml = ["header:\n  seq: 0\n  frame_id: world\nposes[]:\n"]
    for i, (rot, center) in enumerate(poses):
        q = _quaternion(rot)
        yaml.append(f"  poses[{i}]:\n    position:\n"
                    + "".join(f"      {a}: {c:.17e}\n" for a, c in zip("xyz", center))
                    + "    orientation:\n"
                    + "".join(f"      {a}: {c:.17e}\n" for a, c in zip("wxyz", q)))
    (folder / "motion.yaml").write_text("".join(yaml))

    vertex = np.zeros(n_points, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    vertex["x"], vertex["y"], vertex["z"] = points.T
    vertex["red"], vertex["green"], vertex["blue"] = 200, 120, 90
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n_points}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n")
    (folder / "structure.ply").write_bytes(header.encode("ascii") + vertex.tobytes())
    return folder
