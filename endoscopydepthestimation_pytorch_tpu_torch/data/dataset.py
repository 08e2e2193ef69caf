"""Frame-pair dataset and batched host loader: the port's copy of the JAX
package's ``data/dataset.py`` (``generating_pos_and_increment`` :26,
``SfMDataset`` :50, ``collate`` :199, ``BatchLoader`` :213).

Samples are dicts of fixed-shape NHWC numpy arrays (the reference's
``torch.utils.data.Dataset`` returns an 18-tuple, dataset.py:336-462), and
``BatchLoader`` assembles batches on host threads in place of
``DataLoader(num_workers=...)`` (reference train.py:186-189). The random
numbers are drawn as the JAX loader draws them, so both packages give the
same batches, bit for bit, for the same seed and epoch.
``parallel.prefetch.device_prefetch`` moves the batches to the device.
"""
from __future__ import annotations

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import preprocess
from .augment import TrainingAugmentation, normalize_color
from .native import rasterize_pair_native


def generating_pos_and_increment(idx: int, visible_view_indexes: List[int],
                                 adjacent_range, rng: random.Random):
    """Random adjacent-frame pairing: pick a signed increment in
    [adjacent_range[0], adjacent_range[1]], direction-constrained near the
    ends of the sequence. Parity: reference utils.py:412-438 (same RNG call
    pattern against a ``random.Random``-compatible generator).
    """
    pos = idx % len(visible_view_indexes)
    lo, hi = adjacent_range[0], adjacent_range[1]
    if len(visible_view_indexes) <= 2 * lo:
        lo = len(visible_view_indexes) // 2

    if pos <= lo - 1:
        increment = rng.randint(lo, min(hi, len(visible_view_indexes) - 1 - pos))
    elif pos >= len(visible_view_indexes) - lo:
        increment = -rng.randint(lo, min(hi, pos))
    else:
        if rng.randint(0, 1) == 1:
            increment = rng.randint(lo, min(hi, len(visible_view_indexes) - 1 - pos))
        else:
            increment = -rng.randint(lo, min(hi, pos))
    return pos, increment


class SfMDataset:
    """Frame-pair (train/validation) or single-frame (test) sample source.

    Mirrors the reference ``SfMDataset`` constructor signature and caching
    behavior (dataset.py:116-328) but returns dict samples, NHWC. Pairs are
    rasterized by the native rasterizer.
    """

    def __init__(self, image_file_names, folder_list, adjacent_range=(5, 30),
                 transform=None, downsampling=4.0, network_downsampling=64,
                 inlier_percentage=0.99, visible_interval=30, use_store_data=False,
                 store_data_root=None, phase="train", is_hsv=False,
                 num_pre_workers=8, rgb_mode="rgb", num_iter: Optional[int] = None,
                 seed: int = 10085):
        self.image_file_names = [Path(p) for p in image_file_names]
        self.adjacent_range = list(adjacent_range)
        self.transform = transform
        self.downsampling = downsampling
        self.network_downsampling = network_downsampling
        self.inlier_percentage = inlier_percentage
        self.visible_interval = visible_interval
        self.phase = phase
        self.is_hsv = is_hsv
        self.rgb_mode = rgb_mode
        self.num_iter = num_iter
        self.num_sample = len(self.image_file_names)
        self.rng = random.Random(seed)

        self.sequences = preprocess.load_or_run_precompute(
            store_data_root=store_data_root, folder_list=folder_list,
            downsampling=downsampling, network_downsampling=network_downsampling,
            is_hsv=is_hsv, inlier_percentage=inlier_percentage,
            visible_interval=visible_interval,
            phase="Evaluation" if phase == "Evaluation" else phase,
            use_store_data=use_store_data, num_workers=num_pre_workers)

    def __len__(self):
        return self.num_iter if self.num_iter is not None else len(self.image_file_names)

    def seed(self, seed: int):
        """Per-epoch reseed (reference train.py:231-233)."""
        self.rng = random.Random(seed)
        if isinstance(self.transform, TrainingAugmentation):
            self.transform.reseed(seed)

    # -- sample construction -------------------------------------------------

    def _boundary(self, seq) -> np.ndarray:
        boundary = seq.mask_boundary.astype(np.float32) / 255.0
        boundary = np.where(boundary > 0.9, 1.0, 0.0).astype(np.float32)
        return boundary.reshape(boundary.shape[0], boundary.shape[1], 1)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx)

    def get(self, idx: int, rng: Optional[random.Random] = None,
            aug_rng=None) -> Dict[str, np.ndarray]:
        """Fetch a sample; explicit RNGs make concurrent loading
        deterministic (each worker derives its own streams)."""
        if self.phase in ("train", "validation"):
            return self._get_pair(idx, rng or self.rng, aug_rng)
        return self._get_test(idx)

    def _get_pair(self, idx: int, rng: random.Random,
                  aug_rng=None) -> Dict[str, np.ndarray]:
        while True:
            img_file_name = self.image_file_names[idx % self.num_sample]
            folder = str(img_file_name.parent)
            seq = self.sequences[folder]
            start_h, end_h, start_w, end_w = seq.crop_positions
            pos, increment = generating_pos_and_increment(
                idx, seq.visible_view_indexes, self.adjacent_range, rng)
            frame_name = seq.visible_view_indexes[idx % len(seq.visible_view_indexes)]
            pair_indexes = [seq.visible_view_indexes[pos],
                            seq.visible_view_indexes[pos + increment]]
            pair_extrinsics = [seq.extrinsics[pos], seq.extrinsics[pos + increment]]
            pair_projections = [seq.projections[pos], seq.projections[pos + increment]]

            depth_masks, sparse_depths, flow_masks, flows = rasterize_pair_native(
                pair_extrinsics=pair_extrinsics, pair_projections=pair_projections,
                pair_indexes=pair_indexes, point_cloud=seq.point_cloud,
                mask_boundary=seq.mask_boundary,
                view_indexes_per_point=seq.view_indexes_per_point,
                clean_point_list=seq.clean_point_list,
                visible_view_indexes=seq.visible_view_indexes)
            if depth_masks[0].sum() != 0 and depth_masks[1].sum() != 0:
                break
            # degenerate sample: resample (reference dataset.py:372-375)
            idx = rng.randrange(0, len(self.image_file_names))

        imgs = [preprocess.load_color_image(
            Path(folder) / f"{i:08d}.jpg", start_h, end_h, start_w, end_w,
            self.downsampling, self.is_hsv, self.rgb_mode) for i in pair_indexes]

        # relative motion, translation normalized by the sequence scale
        # (reference dataset.py:384-399)
        relative = np.asarray(pair_extrinsics[0]) @ np.linalg.inv(np.asarray(pair_extrinsics[1]))
        r_1_wrt_2 = relative[:3, :3].astype(np.float32)
        t_1_wrt_2 = (relative[:3, 3].reshape(3, 1) / seq.estimated_scale).astype(np.float32)
        r_2_wrt_1 = r_1_wrt_2.T.copy()
        t_2_wrt_1 = (-r_1_wrt_2.T @ t_1_wrt_2).astype(np.float32)

        sparse_depths = sparse_depths / seq.estimated_scale

        color_1, color_2 = imgs
        if self.phase == "train" and self.transform is not None:
            color_1 = self.transform(color_1, rng=aug_rng)
            color_2 = self.transform(color_2, rng=aug_rng)
        color_1 = normalize_color(color_1)
        color_2 = normalize_color(color_2)

        return {
            "color_1": color_1, "color_2": color_2,
            "sparse_depth_1": sparse_depths[0], "sparse_depth_2": sparse_depths[1],
            "depth_mask_1": depth_masks[0], "depth_mask_2": depth_masks[1],
            "flow_1": flows[0], "flow_2": flows[1],
            "flow_mask_1": flow_masks[0], "flow_mask_2": flow_masks[1],
            "boundary": self._boundary(seq),
            "rotation_1_wrt_2": r_1_wrt_2, "rotation_2_wrt_1": r_2_wrt_1,
            "translation_1_wrt_2": t_1_wrt_2, "translation_2_wrt_1": t_2_wrt_1,
            "intrinsic": seq.intrinsic_matrix[:3, :3].astype(np.float32),
            "folder": folder, "name": frame_name,
        }

    def _get_test(self, idx: int) -> Dict[str, np.ndarray]:
        img_file_name = self.image_file_names[idx]
        folder = str(img_file_name.parent)
        seq = self.sequences[folder]
        start_h, end_h, start_w, end_w = seq.crop_positions
        color = preprocess.load_color_image(img_file_name, start_h, end_h, start_w,
                                            end_w, self.downsampling, self.is_hsv,
                                            self.rgb_mode).astype(np.float32)
        return {
            "color_1": normalize_color(color),
            "boundary": self._boundary(seq),
            "intrinsic": seq.intrinsic_matrix[:3, :3].astype(np.float32),
            "name": img_file_name.name[-12:-4],
        }


_ARRAY_KEYS = ("color_1", "color_2", "sparse_depth_1", "sparse_depth_2",
               "depth_mask_1", "depth_mask_2", "flow_1", "flow_2",
               "flow_mask_1", "flow_mask_2", "boundary",
               "rotation_1_wrt_2", "rotation_2_wrt_1",
               "translation_1_wrt_2", "translation_2_wrt_1", "intrinsic")


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack sample dicts into one batch dict (array fields only; folder and
    name become lists under 'folders'/'names')."""
    batch = {}
    for key in _ARRAY_KEYS:
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples]).astype(np.float32)
    if "folder" in samples[0]:
        batch["folders"] = [s["folder"] for s in samples]
    if "name" in samples[0]:
        batch["names"] = [s["name"] for s in samples]
    return batch


class BatchLoader:
    """Threaded batch producer with bounded prefetch.

    The per-sample work (jpeg decode, rasterize, augment: cv2 and the
    native rasterizer release the GIL) overlaps with device compute.
    ``num_workers`` > 1 builds batches concurrently while results are
    yielded strictly in order; every sample draws from its own
    ``random.Random`` and ``RandomState``, derived from (seed, epoch, its
    position in the epoch), so the batches are the same under any worker
    interleaving.

    Several processes (``process_index`` of ``process_count``, one per
    rank of ``parallel.distributed``): each takes its contiguous
    ``batch_size / process_count`` rows of every global batch of
    ``batch_size`` samples. Every process walks the same global order and
    draws each sample from the RNG stream of its global position, so the
    processes' rows, concatenated in process order, are the batch one
    process would build (JAX data/dataset.py:223-245, 280-296).
    """

    def __init__(self, dataset: SfMDataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, seed: int = 10085, drop_last: bool = True,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in "
                             f"[0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"the global batch_size {batch_size} must divide "
                             f"evenly over {process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        self.shuffle = shuffle
        # more worker threads than cores thrash (GIL and context switches
        # on the numpy-heavy parts); sched_getaffinity reflects the
        # container's CPU quota, cpu_count() does not
        try:
            n_cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            n_cores = os.cpu_count() or num_workers
        self.num_workers = max(1, min(num_workers, n_cores))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return order

    def __iter__(self):
        order = self._index_order()
        n_batches = len(self)
        if (self.process_count > 1 and not self.drop_last
                and len(order) % self.batch_size):
            # a ragged last batch does not split into equal rows per process
            raise ValueError("loading in several processes needs drop_last=True "
                             "or a dataset length divisible by batch_size")
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        base = (self.seed + self._epoch) * 1000003

        def build(b):
            # this process's rows of global batch b, at their global
            # positions (the RNG streams' ids)
            start = b * self.batch_size + self.process_index * self.local_batch_size
            samples = []
            for k, i in enumerate(order[start:start + self.local_batch_size]):
                pos = start + k
                # per-sample RNG streams: deterministic under any worker
                # interleaving
                srng = random.Random(base + pos)
                arng = np.random.RandomState((base + pos) % (2 ** 31 - 1))
                samples.append(self.dataset.get(int(i), srng, arng))
            return collate(samples)

        def produce():
            try:
                if self.num_workers == 1:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        q.put(build(b))
                else:
                    with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                        futures = []
                        for b in range(n_batches):
                            futures.append(pool.submit(build, b))
                            # drain in order as soon as the head is ready
                            while futures and (futures[0].done() or
                                               len(futures) >= self.num_workers + 1):
                                if stop.is_set():
                                    return
                                q.put(futures.pop(0).result())
                        for f in futures:
                            if stop.is_set():
                                return
                            q.put(f.result())
                q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
