"""Preprocessing / precompute pipeline: the port's copy of the JAX
package's ``data/preprocess.py``.

Turns the raw per-sequence SfM directories into the cached, fixed-shape
arrays training needs: cropped masks, rescaled intrinsics, extrinsic /
projection matrices, smoothed point visibility, per-sequence global scale,
and the clean-point (SfM inlier) indicator; and holds the per-sequence
record ``SequenceData`` and the frame loader ``load_color_image`` that
serving uses.

The two-pass precompute (reference dataset.py:25-113, 159-272) fans out
over worker processes made by the ``spawn`` method: a forked child of a
process that has initialised CUDA, or that runs loader or prefetch
threads, can hang or crash, and the trainer may build a dataset at any
point of a run (``chip_smoke.py`` does after its GPU phases). The cache
is the reference's 14-element
``precompute_{downsampling}_{network_downsampling}_{inlier_percentage}.pkl``
(dataset.py:150-155, 309-328) of plain lists, arrays and dicts, so the
JAX package, the reference and the port read each other's files.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from . import readers
from ..utils.plyio import read_point_cloud


# ---------------------------------------------------------------------------
# mask cropping
# ---------------------------------------------------------------------------

def downsample_and_crop_mask(mask: np.ndarray, downsampling_factor: float, divide: int,
                             suggested_h: Optional[int] = None,
                             suggested_w: Optional[int] = None):
    """Resize the undistorted mask by 1/downsampling, tight-crop to the mask
    bounding box rounded up to a multiple of ``divide`` (the network's total
    downsampling), 5x5-erode the result.

    Returns (cropped_mask, start_h, end_h, start_w, end_w).
    Parity: reference utils.py:93-134 (including its use of the pre-padding
    bbox height in the ``suggested_h != h`` comparison).
    """
    downsampled = cv2.resize(mask, (0, 0), fx=1.0 / downsampling_factor,
                             fy=1.0 / downsampling_factor)
    full_h, full_w = downsampled.shape[:2]
    ys, xs = np.where(downsampled == 255)
    h = ys.max() - ys.min()
    w = xs.max() - xs.min()

    increment_h = divide - h % divide
    increment_w = divide - w % divide
    target_h = h + increment_h
    target_w = w + increment_w

    start_h = max(ys.min() - increment_h // 2, 0)
    end_h = start_h + target_h
    start_w = max(xs.min() - increment_w // 2, 0)
    end_w = start_w + target_w

    if suggested_h is not None and suggested_h != h:
        remain_h = suggested_h - target_h
        start_h = max(start_h - remain_h // 2, 0)
        end_h = min(suggested_h + start_h, full_h)
        start_h = end_h - suggested_h
    if suggested_w is not None and suggested_w != w:
        remain_w = suggested_w - target_w
        start_w = max(start_w - remain_w // 2, 0)
        end_w = min(suggested_w + start_w, full_w)
        start_w = end_w - suggested_w

    eroded = cv2.erode(downsampled, np.ones((5, 5), np.uint8), iterations=1)
    cropped = eroded[start_h:end_h, start_w:end_w]
    return cropped, int(start_h), int(end_h), int(start_w), int(end_w)


# ---------------------------------------------------------------------------
# image loading
# ---------------------------------------------------------------------------

def load_color_image(path, start_h, end_h, start_w, end_w, downsampling_factor,
                     is_hsv=False, rgb_mode="bgr") -> np.ndarray:
    """Read a frame, resize by 1/downsampling, crop, convert colorspace.

    Parity: reference utils.py:71-81 / 288-300 / 441-457 (cv2 BGR read,
    INTER_LINEAR resize, HSV_FULL or RGB conversion).
    """
    img = cv2.imread(str(path))
    img = cv2.resize(img, (0, 0), fx=1.0 / downsampling_factor, fy=1.0 / downsampling_factor)
    img = img[start_h:end_h, start_w:end_w, :]
    if is_hsv:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2HSV_FULL)
    elif rgb_mode == "rgb":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def get_color_imgs(prefix_seq, visible_view_indexes, start_h, end_h, start_w, end_w,
                   downsampling_factor, is_hsv=False) -> np.ndarray:
    """Stack all visible frames of a sequence as float32 (N, H, W, 3).

    Parity: reference utils.py:288-300 (BGR unless is_hsv).
    """
    imgs = [load_color_image(Path(prefix_seq) / f"{i:08d}.jpg", start_h, end_h,
                             start_w, end_w, downsampling_factor, is_hsv, rgb_mode="bgr")
            for i in visible_view_indexes]
    return np.asarray(imgs, dtype=np.float32)


# ---------------------------------------------------------------------------
# visibility smoothing / global scale / inlier detection
# ---------------------------------------------------------------------------

def overlapping_visible_view_indexes_per_point(view_indexes_per_point: np.ndarray,
                                               visible_interval: int) -> np.ndarray:
    """Densify per-point visibility: each column becomes the sum of the
    binary visibility over the window [i - interval, i + interval).

    Parity: reference utils.py:29-36 (note the asymmetric window: the right
    edge is exclusive).
    """
    src = np.copy(view_indexes_per_point)
    n_views = src.shape[1]
    out = view_indexes_per_point  # reference mutates in place; we do too
    csum = np.concatenate([np.zeros((src.shape[0], 1), src.dtype), np.cumsum(src, axis=1)], axis=1)
    for i in range(n_views):
        lo = max(0, i - visible_interval)
        hi = min(n_views, i + visible_interval)
        out[:, i] = csum[:, hi] - csum[:, lo]
    return out


def global_scale_estimation(extrinsics, point_cloud) -> float:
    """Per-sequence scale = max(1, ||bbox(camera positions)||, ||bbox(points)||).

    Parity: reference utils.py:234-264 (NaN points skipped).
    """
    trans = np.asarray([np.asarray(e)[:3, 3] for e in extrinsics], dtype=np.float32)
    norm_1 = float(np.linalg.norm(trans.max(axis=0) - trans.min(axis=0), ord=2))

    pts = np.asarray(point_cloud, dtype=np.float32)[:, :3]
    finite = ~np.isnan(pts).any(axis=1)
    finite[0] = True  # reference seeds the bbox with point 0 unconditionally
    pts = pts[finite]
    norm_2 = float(np.linalg.norm(pts.max(axis=0) - pts.min(axis=0), ord=2))
    return max(1.0, norm_1, norm_2)


def compute_sanity_threshold(sanity_array: np.ndarray,
                             inlier_percentage: float) -> Tuple[float, float]:
    """Histogram the per-point sanity value (depth^2 * brightness), grow a
    window around the histogram peak until ``inlier_percentage`` probability
    mass is captured; return the [min, max] inlier band.

    Parity: reference utils.py:303-337 (1000-edge histogram, alternating
    positive/negative window growth).
    """
    bin_edges = np.arange(1000) * np.max(sanity_array) / 1000.0
    hist, bin_edges = np.histogram(sanity_array, bins=bin_edges, density=True)
    mass = hist * np.diff(bin_edges)
    max_index = int(np.argmax(mass))
    total = mass[max_index]
    pos, neg = 1, 1
    n = len(mass)
    while True:
        if max_index + pos < n:
            total += mass[max_index + pos]
            pos += 1
            if total >= inlier_percentage:
                return float(bin_edges[max_index - neg + 1]), float(bin_edges[max_index + pos])
        if max_index - neg >= 0:
            total += mass[max_index - neg]
            neg += 1
            if total >= inlier_percentage:
                return float(bin_edges[max_index - neg + 1]), float(bin_edges[max_index + pos])
        if max_index + pos >= n and max_index - neg < 0:
            return float(np.min(bin_edges)), float(np.max(bin_edges))


def get_clean_point_list(imgs: np.ndarray, point_cloud: np.ndarray,
                         view_indexes_per_point: np.ndarray, mask_boundary: np.ndarray,
                         inlier_percentage: float, projection_matrices,
                         extrinsic_matrices, is_hsv: bool) -> np.ndarray:
    """Photometric SfM-outlier detection: project every point into every
    frame it is visible in, sample bilateral-filtered HSV brightness there,
    and flag the point "contaminated" in frames where depth^2 * brightness
    falls outside the per-frame sanity band. A point is clean if it is
    contaminated in fewer than half of its appearances.

    Returns a float32 0/1 array of shape (n_points,).
    Parity: reference utils.py:340-404.
    """
    points = np.asarray(point_cloud, dtype=np.float64).reshape(-1, 4)
    if inlier_percentage <= 0.0 or inlier_percentage >= 1.0:
        return np.zeros((0,), dtype=np.float32)

    contamination = np.zeros(points.shape[0], dtype=np.int32)
    appearances = np.zeros(points.shape[0], dtype=np.int32)
    height, width = imgs[0].shape[:2]
    flat_mask = np.asarray(mask_boundary).reshape(-1)

    for i in range(len(projection_matrices)):
        img = np.asarray(imgs[i], dtype=np.float32) / 255.0
        if not is_hsv:
            filtered = cv2.bilateralFilter(src=img, d=7, sigmaColor=25, sigmaSpace=25)
            img_hsv = cv2.cvtColor(filtered, cv2.COLOR_BGR2HSV_FULL)
        else:
            bgr = cv2.cvtColor(img, cv2.COLOR_HSV2BGR_FULL)
            filtered = cv2.bilateralFilter(src=bgr, d=7, sigmaColor=25, sigmaSpace=25)
            img_hsv = cv2.cvtColor(filtered, cv2.COLOR_BGR2HSV_FULL)
        brightness = img_hsv.reshape(-1, 3)[:, 2]

        visible = np.where(view_indexes_per_point[:, i] > 0.5)[0]
        cam = points @ np.asarray(extrinsic_matrices[i]).T
        cam = cam / cam[:, 3:4]
        img2d = points @ np.asarray(projection_matrices[i]).T
        img2d = img2d / img2d[:, 2:3]

        vis2d = img2d[visible]
        vis3d = cam[visible]
        in_img = np.where((vis2d[:, 0] <= width - 1) & (vis2d[:, 0] >= 0) &
                          (vis2d[:, 1] <= height - 1) & (vis2d[:, 1] >= 0) &
                          (vis3d[:, 2] > 0))[0]
        locations = (np.round(vis2d[in_img, 0]) +
                     np.round(vis2d[in_img, 1]) * width).astype(np.int32)
        in_mask = np.where(flat_mask[locations] == 255)[0]
        locations = locations[in_mask]
        depths = vis3d[in_img[in_mask], 2]
        sanity = depths ** 2 * brightness[locations]
        appearances[visible[in_img[in_mask]]] += 1
        if sanity.shape[0] < 2:
            continue
        lo, hi = compute_sanity_threshold(sanity, inlier_percentage)
        bad = np.where((sanity <= lo) | (sanity >= hi))[0]
        contamination[visible[in_img[in_mask[bad]]]] += 1

    clean = (contamination < appearances / 2).astype(np.float32)
    return clean


# ---------------------------------------------------------------------------
# per-sequence orchestration
# ---------------------------------------------------------------------------

@dataclass
class SequenceData:
    """Everything the sampler needs about one video sequence."""
    folder: str
    crop_positions: List[int]                 # [start_h, end_h, start_w, end_w]
    selected_indexes: List[int]
    visible_view_indexes: List[int]
    point_cloud: np.ndarray                   # (N, 4) homogeneous
    intrinsic_matrix: np.ndarray              # 3x4 (cropped/downsampled)
    mask_boundary: np.ndarray                 # (H, W) uint8 eroded mask
    view_indexes_per_point: np.ndarray        # (N, n_views) smoothed counts
    extrinsics: List[np.ndarray]              # n_views x 4x4
    projections: List[np.ndarray]             # n_views x 3x4
    clean_point_list: np.ndarray              # (N,) float 0/1
    estimated_scale: float = 1.0


def compute_crop_size(folder, downsampling: float, network_downsampling: int) -> Tuple[int, int]:
    """First-pass worker: cropped mask size for one folder.

    Parity: reference dataset.py:25-33.
    """
    mask = cv2.imread(str(Path(folder) / "undistorted_mask.bmp"), cv2.IMREAD_GRAYSCALE)
    _, start_h, end_h, start_w, end_w = downsample_and_crop_mask(
        mask, downsampling_factor=downsampling, divide=network_downsampling)
    return end_h - start_h, end_w - start_w


def preprocess_sequence(folder, downsampling: float, network_downsampling: int,
                        is_hsv: bool, inlier_percentage: float, visible_interval: int,
                        suggested_h: int, suggested_w: int) -> SequenceData:
    """Second-pass worker: the full per-folder precompute.

    Parity: reference dataset.py:36-113 (same op order and intermediates).
    """
    folder = Path(folder)
    mask = cv2.imread(str(folder / "undistorted_mask.bmp"), cv2.IMREAD_GRAYSCALE)
    cropped_mask, start_h, end_h, start_w, end_w = downsample_and_crop_mask(
        mask, downsampling_factor=downsampling, divide=network_downsampling,
        suggested_h=suggested_h, suggested_w=suggested_w)

    _, selected_indexes = readers.read_selected_indexes(folder)
    visible_view_indexes = readers.read_visible_view_indexes(folder)
    intrinsics = readers.read_camera_intrinsic_per_view(folder)
    intrinsic_matrix = readers.modify_camera_intrinsic_matrix(
        intrinsics[0], start_h=start_h, start_w=start_w, downsampling_factor=downsampling)

    point_cloud = read_point_cloud(folder / "structure.ply")
    view_indexes_per_point = readers.read_view_indexes_per_point(
        folder, visible_view_indexes, point_cloud.shape[0])
    view_indexes_per_point = overlapping_visible_view_indexes_per_point(
        view_indexes_per_point, visible_interval)

    poses = readers.read_pose_data(folder)
    extrinsics, projections = readers.get_extrinsic_matrix_and_projection_matrix(
        poses, intrinsic_matrix=intrinsic_matrix, visible_view_count=len(visible_view_indexes))
    estimated_scale = global_scale_estimation(extrinsics, point_cloud)

    imgs = get_color_imgs(folder, visible_view_indexes, start_h, end_h, start_w, end_w,
                          downsampling_factor=downsampling, is_hsv=is_hsv)
    clean_point_list = get_clean_point_list(
        imgs=imgs, point_cloud=point_cloud, view_indexes_per_point=view_indexes_per_point,
        mask_boundary=cropped_mask, inlier_percentage=inlier_percentage,
        projection_matrices=projections, extrinsic_matrices=extrinsics, is_hsv=is_hsv)

    return SequenceData(
        folder=str(folder), crop_positions=[start_h, end_h, start_w, end_w],
        selected_indexes=selected_indexes, visible_view_indexes=visible_view_indexes,
        point_cloud=point_cloud, intrinsic_matrix=intrinsic_matrix,
        mask_boundary=cropped_mask, view_indexes_per_point=view_indexes_per_point,
        extrinsics=[np.asarray(e) for e in extrinsics],
        projections=[np.asarray(p) for p in projections],
        clean_point_list=clean_point_list, estimated_scale=estimated_scale)


def _preprocess_one(args):
    return preprocess_sequence(*args)


def _pool(num_workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=num_workers,
                               mp_context=multiprocessing.get_context("spawn"))


def precompute_path_for(store_data_root, downsampling, network_downsampling,
                        inlier_percentage, phase: str) -> Path:
    """Cache filename; keyed by the hyperparameters exactly like the
    reference (dataset.py:150-155)."""
    prefix = "evaluate_precompute_" if phase == "Evaluation" else "precompute_"
    return Path(store_data_root) / (
        f"{prefix}{downsampling}_{network_downsampling}_{inlier_percentage}.pkl")


def run_precompute(folder_list, downsampling: float, network_downsampling: int,
                   is_hsv: bool, inlier_percentage: float, visible_interval: int,
                   num_workers: int = 8) -> Dict[str, SequenceData]:
    """Two-pass multiprocess precompute over all sequence folders.

    Pass 1 finds the largest cropped size so every sequence pads to one
    common shape (batching needs it, reference dataset.py:177-210). Pass 2
    does the heavy per-folder work. ``num_workers`` > 1 runs both passes in
    one pool of spawned processes.
    """
    folder_list = [str(f) for f in folder_list]
    num_workers = max(1, min(num_workers, len(folder_list)))
    with contextlib.ExitStack() as stack:
        # one pool for both passes: a spawned worker imports the package first
        run = map if num_workers == 1 else stack.enter_context(_pool(num_workers)).map
        sizes = list(run(compute_crop_size, folder_list,
                         [downsampling] * len(folder_list),
                         [network_downsampling] * len(folder_list)))
        largest_h = max(s[0] for s in sizes)
        largest_w = max(s[1] for s in sizes)
        if largest_h == 0 or largest_w == 0:
            raise IOError("image size calculation failed")
        args = [(f, downsampling, network_downsampling, is_hsv, inlier_percentage,
                 visible_interval, largest_h, largest_w) for f in folder_list]
        results = list(run(_preprocess_one, args))
    return {r.folder: r for r in results}


# ---------------------------------------------------------------------------
# reference-compatible cache
# ---------------------------------------------------------------------------

_PKL_FIELDS = ("crop_positions", "selected_indexes", "visible_view_indexes",
               "point_cloud", "intrinsic_matrix", "mask_boundary",
               "view_indexes_per_point", "extrinsics", "projections",
               "clean_point_list")


def save_precompute(path, sequences: Dict[str, SequenceData], downsampling,
                    network_downsampling, inlier_percentage) -> None:
    """Write the 14-element pickle in the reference's exact layout
    (dataset.py:310-319)."""
    dicts = []
    for name in _PKL_FIELDS:
        d = {}
        for folder, seq in sequences.items():
            value = getattr(seq, name)
            if name == "point_cloud":
                value = [list(p) for p in value]  # reference stores list-of-lists
            d[folder] = value
        dicts.append(d)
    scales = {folder: seq.estimated_scale for folder, seq in sequences.items()}
    payload = dicts[:10] + [downsampling, network_downsampling, inlier_percentage, scales]
    # reference order: crop, selected, visible, point_cloud, intrinsic, mask,
    # view_indexes_per_point, extrinsics, projections, clean, ds, nds, inlier, scale
    # written under a name of this process's, then renamed: the trainer's
    # ranks on one host may write the same file, and a reader never sees
    # a part of one
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_precompute(path, folder_list=None) -> Dict[str, SequenceData]:
    """Load a precompute pickle written by us *or* by the reference
    (dataset.py:321-328). Folder keys recorded on another machine are
    remapped onto ``folder_list`` by matching the trailing two path
    components (bag/sequence)."""
    with open(str(path), "rb") as f:
        (crop, selected, visible, point_cloud, intrinsic, mask, vipp,
         extrinsics, projections, clean, downsampling, network_downsampling,
         inlier_percentage, scales) = pickle.load(f)

    def _suffix(p):
        parts = Path(p).parts
        return tuple(parts[-2:])

    remap = {}
    if folder_list:
        by_suffix = {_suffix(k): k for k in crop.keys()}
        for folder in folder_list:
            key = str(folder)
            if key in crop:
                remap[key] = key
            elif _suffix(key) in by_suffix:
                remap[key] = by_suffix[_suffix(key)]
    else:
        remap = {k: k for k in crop.keys()}

    sequences = {}
    for folder, src in remap.items():
        sequences[folder] = SequenceData(
            folder=folder,
            crop_positions=[int(v) for v in crop[src]],
            selected_indexes=list(selected[src]),
            visible_view_indexes=list(visible[src]),
            point_cloud=np.asarray(point_cloud[src], dtype=np.float32).reshape(-1, 4),
            intrinsic_matrix=np.asarray(intrinsic[src]),
            mask_boundary=np.asarray(mask[src]),
            view_indexes_per_point=np.asarray(vipp[src]),
            extrinsics=[np.asarray(e) for e in extrinsics[src]],
            projections=[np.asarray(p) for p in projections[src]],
            clean_point_list=np.asarray(clean[src], dtype=np.float32),
            estimated_scale=float(scales[src]))
    return sequences


def load_or_run_precompute(store_data_root, folder_list, downsampling,
                           network_downsampling, is_hsv, inlier_percentage,
                           visible_interval, phase, use_store_data: bool,
                           num_workers: int = 8) -> Dict[str, SequenceData]:
    """Cache-or-compute entry point mirroring SfMDataset.__init__'s caching
    decision (reference dataset.py:157-328)."""
    path = precompute_path_for(store_data_root, downsampling, network_downsampling,
                               inlier_percentage, phase)
    if use_store_data and path.exists():
        return load_precompute(path, folder_list)
    sequences = run_precompute(folder_list, downsampling, network_downsampling,
                               is_hsv, inlier_percentage, visible_interval, num_workers)
    save_precompute(path, sequences, downsampling, network_downsampling, inlier_percentage)
    return sequences
