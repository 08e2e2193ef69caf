"""EM-tracker pose synchronization and export in the tracker's frame:
the port's copy of the JAX package's ``data/tracker.py`` (numpy and the
file system only).

Aligns electromagnetic-tracker pose streams with recorded video frames
and exports depth predictions in the tracker's world frame; the
reference keeps these in utils.py:1246-1355, 1385-1402, 1747-1897. No
entry point of the port calls it.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .readers import quaternion_matrix
from ..utils.plyio import write_point_cloud


def read_pose_messages_from_tracker(file_path) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """CSV pose stream: skip header; columns 5.. are x,y,z,qx,qy,qz,qw.

    Parity: reference utils.py:1298-1313.
    """
    translations, rotations = [], []
    with open(str(file_path)) as fs:
        for count, line in enumerate(fs):
            if count == 0:
                continue
            array = np.array(line.split(",")[5:], dtype=np.float64)
            translations.append(array[:3])
            qx, qy, qz, qw = array[3:7]
            rotations.append(quaternion_matrix([qw, qx, qy, qz])[:3, :3])
    return translations, rotations


def read_initial_pose_file(file_path):
    """Per-frame initial poses: 'index, x, y, z, qw, qx, qy, qz' lines with
    y/z axes flipped. Parity: reference utils.py:1385-1402."""
    frame_indexes, translations, rotations = [], {}, {}
    with open(str(file_path)) as fs:
        for line in fs:
            array = np.array(line.split(", "), dtype=np.float64)
            idx = int(array[0])
            frame_indexes.append(idx)
            translations[f"{idx:08d}"] = array[1:4]
            rotation = quaternion_matrix(array[4:8])
            rotation[:3, 1] = -rotation[:3, 1]
            rotation[:3, 2] = -rotation[:3, 2]
            rotations[f"{idx:08d}"] = rotation[:3, :3]
    frame_indexes.sort()
    return frame_indexes, translations, rotations


def read_pose_corresponding_image_indexes(file_path) -> np.ndarray:
    """First column of each line = video frame index for that pose.
    Parity: reference utils.py:1747-1756."""
    indexes = []
    with open(str(file_path)) as fs:
        for line in fs:
            indexes.append(int(np.array(line.split(", "), dtype=np.float32)[0]))
    return np.array(indexes, dtype=np.float32)


def read_pose_corresponding_image_indexes_and_time_difference(file_path):
    """Columns 0/1 = frame index / timestamp delta per pose.
    Parity: reference utils.py:1759-1771."""
    indexes, deltas = [], []
    with open(str(file_path)) as fs:
        for line in fs:
            array = np.array(line.split(", "), dtype=np.float32)
            indexes.append(int(array[0]))
            deltas.append(int(array[1]))
    return (np.array(indexes, dtype=np.int32), np.array(deltas, dtype=np.int32))


def _write_coords(path, translation, rotation) -> None:
    with open(str(path), "w") as fs:
        for i in range(3):
            fs.write(f"{translation[i]:.5f},")
        for i in range(3):
            for j in range(3):
                end = "\n" if (i == 2 and j == 2) else ","
                fs.write(f"{rotation[i][j]:.5f}{end}")


def synchronize_selected_calibration_poses(root) -> None:
    """For each calibration jpg under ``root``, find the tracker pose(s)
    recorded against the same frame index (or the nearest frame; flagged
    'bad' beyond 10 frames) and write a ``.coords`` sidecar file.

    Parity: reference utils.py:1774-1843.
    """
    root = Path(root)
    translations, rotations = read_pose_messages_from_tracker(root / "poses")
    frame_indexes = read_pose_corresponding_image_indexes(
        root / "pose_corresponding_image_indexes")

    for image_path in sorted(root.glob("*.jpg")):
        name = str(image_path)
        difference = frame_indexes.astype(np.int32) - int(name[-12:-4])
        zero_indexes = np.where(difference == 0)[0]
        translation = np.zeros(3, dtype=np.float64)
        rotation = np.zeros((3, 3), dtype=np.float64)
        flag = ""
        if zero_indexes.size:
            for idx in zero_indexes:
                translation += translations[idx]
            translation /= zero_indexes.size
            rotation = rotations[zero_indexes[0]]
        else:
            nearest = int(np.argmin(np.abs(difference)))
            if np.min(np.abs(difference)) > 10:
                flag = "bad"
                print(f"no best matches available for image {name}")
            translation = translations[nearest]
            rotation = rotations[nearest]
        _write_coords(name[:-4] + flag + ".coords", translation, rotation)


def synchronize_image_and_poses(root, tolerance_threshold: float = 1.0e6) -> None:
    """Copy calibration frames whose pose timestamp delta is inside the
    tolerance into ``selected_calibration_images/`` with ``.coords``
    sidecars. Parity: reference utils.py:1846-1883."""
    root = Path(root)
    translations, rotations = read_pose_messages_from_tracker(
        root / "bags" / "poses_calibration")
    frame_indexes, deltas = read_pose_corresponding_image_indexes_and_time_difference(
        root / "bags" / "pose_corresponding_image_indexes_calibration")

    selected = np.where(deltas < tolerance_threshold)[0]
    out_root = root / "selected_calibration_images"
    out_root.mkdir(parents=True, exist_ok=True)
    calibration_root = root / "calibration_images"
    for ori_index, pose_index in enumerate(selected):
        frame = int(frame_indexes[pose_index])
        dest = out_root / f"{frame:08d}.jpg"
        if not dest.exists():
            shutil.copyfile(calibration_root / f"{frame:08d}.jpg", dest)
        _write_coords(out_root / f"{frame:08d}.coords",
                      translations[pose_index], rotations[pose_index])


def read_camera_to_tcp_transform(root) -> Tuple[np.ndarray, np.ndarray]:
    """Hand-eye calibration: 12 whitespace-separated values, row-major 3x4.
    Parity: reference utils.py:1886-1896."""
    with open(str(Path(root) / "camera_to_tcp")) as fs:
        for line in fs:
            values = np.array(line.split(" "), dtype=np.float64)
    transform = values.reshape(3, 4)
    return transform[:, :3], transform[:, 3].reshape(3, 1)


def point_cloud_from_depth_and_initial_pose(depth_map, color_img, mask_img,
                                            intrinsic_matrix, translation, rotation,
                                            point_cloud_downsampling: int = 1,
                                            min_threshold=None, max_threshold=None
                                            ) -> np.ndarray:
    """Unproject masked pixels, normalize depth span to 20 units, and move
    the cloud into the tracker's world frame (R p + t). Vectorized;
    parity: reference utils.py:1246-1296.
    """
    depth_map = np.asarray(depth_map).reshape(np.asarray(mask_img).shape[:2])
    mask = np.asarray(mask_img).reshape(depth_map.shape) > 0.5
    height, width = depth_map.shape
    stride = np.zeros_like(mask)
    stride[::point_cloud_downsampling, ::point_cloud_downsampling] = True
    keep = mask & stride
    z = depth_map[keep]
    if z.size == 0:
        return np.zeros((0, 6), np.float32)
    scale = 20.0 / max(float(z.max()) - float(z.min()), 1e-12)

    fx, cx = intrinsic_matrix[0, 0], intrinsic_matrix[0, 2]
    fy, cy = intrinsic_matrix[1, 1], intrinsic_matrix[1, 2]
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    x = (us[keep] - cx) / fx * z
    y = (vs[keep] - cy) / fy * z
    positions = np.stack([x, y, z], axis=0) * scale          # (3, N)
    transformed = np.asarray(rotation) @ positions + np.asarray(translation).reshape(3, 1)

    bgr = np.asarray(color_img).reshape(height, width, -1)[keep]
    r, g, b = bgr[:, 2], bgr[:, 1], bgr[:, 0]
    if min_threshold is not None and max_threshold is not None:
        sel = (np.max(bgr[:, :3], 1) >= max_threshold) & (np.min(bgr[:, :3], 1) <= min_threshold)
        transformed, r, g, b = transformed[:, sel], r[sel], g[sel], b[sel]
    cloud = np.stack([transformed[0], transformed[1], transformed[2],
                      np.uint8(r), np.uint8(g), np.uint8(b)], axis=1)
    return cloud.astype(np.float32).reshape(-1, 6)


def write_test_output_with_initial_pose(results_root, colors, scaled_depths,
                                        boundaries, intrinsics, is_hsv,
                                        image_indexes, translation_dict,
                                        rotation_dict) -> None:
    """Per-frame export in the tracker frame: ``test_point_cloud_*.ply``,
    ``test_color_*.jpg``, ``test_depth_*.jpg``. NHWC inputs.
    Parity: reference utils.py:1316-1355."""
    import cv2
    results_root = Path(results_root)
    colors = np.asarray(colors)
    depths = np.asarray(scaled_depths) * np.asarray(boundaries)
    for j in range(colors.shape[0]):
        color = np.clip(colors[j] * 0.5 + 0.5, 0.0, 1.0)
        color = np.uint8(255 * color)
        if is_hsv:
            color = cv2.cvtColor(color, cv2.COLOR_HSV2BGR_FULL)
        cloud = point_cloud_from_depth_and_initial_pose(
            depths[j], color, np.asarray(boundaries)[j], np.asarray(intrinsics)[j],
            translation=translation_dict[image_indexes[j]],
            rotation=rotation_dict[image_indexes[j]],
            point_cloud_downsampling=1)
        write_point_cloud(results_root / f"test_point_cloud_{image_indexes[j]}.ply", cloud)
        cv2.imwrite(str(results_root / f"test_color_{image_indexes[j]}.jpg"), color)
        d = depths[j, :, :, 0]
        span = max(float(d.max()) - float(d.min()), 1e-12)
        vis = cv2.applyColorMap(np.uint8(np.clip((d - d.min()) / span * 255, 0, 255)),
                                cv2.COLORMAP_JET)
        cv2.imwrite(str(results_root / f"test_depth_{image_indexes[j]}.jpg"), vis)
