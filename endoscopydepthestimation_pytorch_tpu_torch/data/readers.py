"""SfM data-model readers: the port's copy of the JAX package's
``data/readers.py`` (:27-236).

Parses the per-sequence directory layout produced by the upstream SfM
pipeline (reference README.md:48): ``{:08d}.jpg`` frames, ``motion.yaml``
world-to-camera poses, ``structure.ply`` sparse points,
``undistorted_mask.bmp``, ``selected_indexes``, ``visible_view_indexes``,
``view_indexes_per_point``, ``camera_intrinsics_per_view``.

Behavioral parity targets are cited per function as reference file:line.
All outputs are plain numpy — device code never touches these.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import yaml

from ..utils.plyio import read_point_cloud  # re-export  # noqa: F401


# ---------------------------------------------------------------------------
# index / intrinsic / visibility files
# ---------------------------------------------------------------------------

def read_selected_indexes(prefix_seq) -> Tuple[int, List[int]]:
    """Frame indexes selected for the sequence + their stride.

    Parity: reference utils.py:137-144.
    """
    with open(str(Path(prefix_seq) / "selected_indexes")) as fp:
        selected = [int(line) for line in fp if line.strip()]
    stride = selected[1] - selected[0]
    return stride, selected


def read_visible_view_indexes(prefix_seq) -> List[int]:
    """Frame indexes that have a valid SfM pose. Reference utils.py:157-163."""
    with open(str(Path(prefix_seq) / "visible_view_indexes")) as fp:
        return [int(line) for line in fp if line.strip()]


def read_camera_intrinsic_per_view(prefix_seq) -> List[np.ndarray]:
    """Per-view 3x4 intrinsic matrices from the 4-lines-per-view file
    (fx, fy, cx, cy). Parity: reference utils.py:166-188.
    """
    with open(str(Path(prefix_seq) / "camera_intrinsics_per_view")) as fp:
        values = [float(line) for line in fp if line.strip()]
    matrices = []
    for i in range(0, len(values) - len(values) % 4, 4):
        k = np.zeros((3, 4))
        k[0, 0] = values[i]
        k[1, 1] = values[i + 1]
        k[0, 2] = values[i + 2]
        k[1, 2] = values[i + 3]
        k[2, 2] = 1.0
        matrices.append(k)
    return matrices


def modify_camera_intrinsic_matrix(intrinsic_matrix: np.ndarray, start_h: int,
                                   start_w: int, downsampling_factor: float) -> np.ndarray:
    """Rescale K by 1/downsampling and shift the principal point by the crop
    offset. Parity: reference utils.py:191-197.
    """
    k = np.copy(intrinsic_matrix)
    k[0, 0] = intrinsic_matrix[0, 0] / downsampling_factor
    k[1, 1] = intrinsic_matrix[1, 1] / downsampling_factor
    k[0, 2] = intrinsic_matrix[0, 2] / downsampling_factor - start_w
    k[1, 2] = intrinsic_matrix[1, 2] / downsampling_factor - start_h
    return k


def read_view_indexes_per_point(prefix_seq, visible_view_indexes: List[int],
                                point_cloud_count: int) -> np.ndarray:
    """Binary (n_points, n_views) visibility matrix from the -1-delimited
    per-point view list. Parity: reference utils.py:213-223.
    """
    vis = np.zeros((point_cloud_count, len(visible_view_indexes)), dtype=np.float64)
    index_of = {v: i for i, v in enumerate(visible_view_indexes)}
    point = -1
    with open(str(Path(prefix_seq) / "view_indexes_per_point")) as fp:
        for line in fp:
            if not line.strip():
                continue
            value = int(line)
            if value < 0:
                point += 1
            else:
                vis[point, index_of[value]] = 1
    return vis


def read_pose_data(prefix_seq) -> Dict:
    """World-to-camera poses from motion.yaml.

    Returns the ``poses[]`` mapping: keys ``poses[i]`` with nested
    position/orientation dicts. Parity: reference utils.py:226-231 (which
    relied on legacy pyyaml<6 dict-unpacking order; we index by key).
    """
    with open(str(Path(prefix_seq) / "motion.yaml")) as stream:
        doc = yaml.safe_load(stream)
    return doc["poses[]"]


# ---------------------------------------------------------------------------
# rigid-body math
# ---------------------------------------------------------------------------

def quaternion_matrix(quaternion) -> np.ndarray:
    """4x4 homogeneous rotation matrix from a [w, x, y, z] quaternion.

    >>> np.allclose(quaternion_matrix([1, 0, 0, 0]), np.identity(4))
    True
    >>> np.allclose(quaternion_matrix([0, 1, 0, 0]), np.diag([1., -1., -1., 1.]))
    True

    Parity: reference utils.py:1358-1382 (transformations.py convention,
    including the near-zero-norm identity fallback).
    """
    q = np.asarray(quaternion, dtype=np.float64)
    n = float(q @ q)
    if n < np.finfo(np.float64).eps * 4.0:
        return np.identity(4)
    w, x, y, z = q * np.sqrt(2.0 / n)
    m = np.identity(4)
    m[0, 0] = 1.0 - (y * y + z * z)
    m[0, 1] = x * y - z * w
    m[0, 2] = x * z + y * w
    m[1, 0] = x * y + z * w
    m[1, 1] = 1.0 - (x * x + z * z)
    m[1, 2] = y * z - x * w
    m[2, 0] = x * z - y * w
    m[2, 1] = y * z + x * w
    m[2, 2] = 1.0 - (x * x + y * y)
    return m


def get_extrinsic_matrix_and_projection_matrix(
        poses: Dict, intrinsic_matrix: np.ndarray,
        visible_view_count: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-view extrinsic E = inv(camera-to-world) and projection P = K @ E.

    Parity: reference utils.py:267-285.
    """
    extrinsics, projections = [], []
    for i in range(visible_view_count):
        pose = poses[f"poses[{i}]"]
        o, p = pose["orientation"], pose["position"]
        rigid = quaternion_matrix([o["w"], o["x"], o["y"], o["z"]])
        rigid[0, 3] = p["x"]
        rigid[1, 3] = p["y"]
        rigid[2, 3] = p["z"]
        extrinsic = np.linalg.inv(rigid)
        extrinsics.append(extrinsic)
        projections.append(np.asarray(intrinsic_matrix) @ extrinsic)
    return extrinsics, projections


# ---------------------------------------------------------------------------
# filesystem discovery
# ---------------------------------------------------------------------------

def get_color_file_names_by_bag(root, training_patient_id, validation_patient_id,
                                testing_patient_id):
    """Glob '*<id>/_start*/0*.jpg' per patient id into train/val/test lists.

    Parity: reference utils.py:39-61.
    """
    root = Path(root)

    def _glob(ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        files = []
        for pid in ids:
            files += list(root.glob("*" + str(pid) + "/_start*/0*.jpg"))
        files.sort()
        return files

    return _glob(training_patient_id), _glob(validation_patient_id), _glob(testing_patient_id)


def get_color_file_names(root, split_ratio=(0.9, 0.05, 0.05)):
    """Ratio-based train/val/test split over all sequence frames (the
    alternative to patient-id splitting). Parity: reference utils.py:64-68.
    """
    root = Path(root)
    files = sorted(root.glob("*/_start*/0*.jpg"))
    a = int(len(files) * split_ratio[0])
    b = int(len(files) * (split_ratio[0] + split_ratio[1]))
    return files[:a], files[a:b], files[b:]


def read_visible_image_path_list(data_root) -> List[int]:
    """All frame indexes appearing in any visible_view_indexes file under
    the tree. Parity: reference utils.py:147-154."""
    indexes = []
    for index_path in Path(data_root).rglob("*visible_view_indexes"):
        with open(str(index_path)) as fp:
            indexes += [int(line) for line in fp if line.strip()]
    return indexes


def get_visible_count_per_point(view_indexes_per_point: np.ndarray) -> np.ndarray:
    """(n_points, 1) appearance counts. Parity: reference utils.py:407-409."""
    return np.sum(view_indexes_per_point, axis=-1).reshape(-1, 1)


def get_parent_folder_names(root, id_range) -> List[Path]:
    """Sequence folders for ids in [id_range[0], id_range[1]).

    Parity: reference utils.py:84-90.
    """
    root = Path(root)
    folders = []
    for i in range(id_range[0], id_range[1]):
        folders += list(root.glob("*" + str(i) + "/_start*/"))
    folders.sort()
    return folders


def get_filenames_from_frame_indexes(sequence_root, frame_index_array) -> List[Path]:
    """Resolve specific {:08d}.jpg frames under a sequence root.

    Parity: reference utils.py:1405-1412.
    """
    sequence_root = Path(sequence_root)
    files = []
    for index in frame_index_array:
        hits = list(sequence_root.rglob(f"{index:08d}.jpg"))
        if hits:
            files.append(hits[0])
    files.sort()
    return files
