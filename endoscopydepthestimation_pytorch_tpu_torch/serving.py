"""Streaming depth inference (JAX package ``serving.py``, ``DepthPredictor``
:54-240).

A trained FCDenseNet-57 (reference-format ``.pt``) behind a double-buffered
pipeline: a host thread decodes and normalizes frame t+1 while the device
runs frame t, and results are read back one batch late, after the next
batch has been dispatched. Same faces as the JAX predictor: (B, H, W, 3)
float32 normalized colors in, (B, H, W) boundary-masked depth out.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import training
from .data import preprocess
from .data.augment import normalize_color
from .models import FCDenseNet57
from .utils import checkpoint as ckpt


class DepthPredictor:
    """Checkpoint-backed depth inference on one sequence's calibration.

    ``sequence`` supplies the crop box and the boundary mask (a
    ``SequenceData``). Parameters and BN statistics stay float32 on
    ``device`` (the CUDA card unless the caller asks for another, such as
    ``"cpu"``); activations run in ``dtype``.
    """

    def __init__(self, checkpoint_path, sequence: preprocess.SequenceData,
                 batch_size: int = 1, downsampling: float = 4.0, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        self.sequence = sequence
        self.batch_size = batch_size
        self.downsampling = downsampling
        self.device = torch.device(device)
        sh, eh, sw, ew = sequence.crop_positions
        self.height, self.width = eh - sh, ew - sw

        model = FCDenseNet57(n_classes=1, dtype=dtype)
        ckpt.load_any_checkpoint(checkpoint_path, model)
        self.model = model.to(self.device).eval()

        boundary = (sequence.mask_boundary.astype(np.float32) / 255.0 > 0.9)
        boundary = boundary.astype(np.float32)[None, :, :, None]
        self._boundary = torch.from_numpy(
            np.repeat(boundary, batch_size, axis=0)).to(self.device)

    # -- host-side frame prep ------------------------------------------------

    def prepare(self, frame) -> np.ndarray:
        """Path or raw BGR frame -> normalized cropped float32 (H, W, 3)."""
        sh, eh, sw, ew = self.sequence.crop_positions
        if isinstance(frame, (str, Path)):
            img = preprocess.load_color_image(frame, sh, eh, sw, ew,
                                              self.downsampling, is_hsv=False,
                                              rgb_mode="rgb")
        elif self.downsampling == 1.0:
            # cv2.resize at scale 1 copies and BGR2RGB flips the channels
            img = np.asarray(frame)[sh:eh, sw:ew, ::-1]
        else:
            import cv2
            img = cv2.resize(np.asarray(frame), (0, 0),
                             fx=1.0 / self.downsampling,
                             fy=1.0 / self.downsampling)
            img = cv2.cvtColor(img[sh:eh, sw:ew], cv2.COLOR_BGR2RGB)
        return normalize_color(img)

    # -- inference -----------------------------------------------------------

    def _dispatch(self, colors: np.ndarray) -> torch.Tensor:
        """Enqueue one batch; returns its masked depth on the device."""
        x = torch.from_numpy(np.ascontiguousarray(colors, np.float32))
        depth = training.predict_step(self.model, x.to(self.device),
                                      self._boundary)
        return (depth * self._boundary)[..., 0]

    def predict_batch(self, colors: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) normalized colors -> (B, H, W) masked depth."""
        return self._dispatch(colors).cpu().numpy()

    def predict_frame(self, frame) -> np.ndarray:
        colors = np.repeat(self.prepare(frame)[None], self.batch_size, axis=0)
        return self.predict_batch(colors)[0]

    def stream(self, frames: Iterable, prefetch: int = 2
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Double-buffered streaming: yields (frame_index, depth (H, W)).

        Host prep runs on a producer thread; device dispatch stays one
        batch ahead of readback.
        """
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch) * self.batch_size)

        def produce():
            for i, frame in enumerate(frames):
                q.put((i, self.prepare(frame)))
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        pending: Optional[Tuple[list, torch.Tensor]] = None
        done = False
        while not done or pending is not None:
            batch_ids, batch_colors = [], []
            while not done and len(batch_ids) < self.batch_size:
                item = q.get()
                if item is None:
                    done = True
                    break
                batch_ids.append(item[0])
                batch_colors.append(item[1])

            dispatched = None
            if batch_ids:
                colors = np.stack(batch_colors)
                if colors.shape[0] < self.batch_size:  # ragged tail: pad
                    pad = np.repeat(colors[-1:], self.batch_size - colors.shape[0], 0)
                    colors = np.concatenate([colors, pad])
                dispatched = (batch_ids, self._dispatch(colors))

            if pending is not None:
                ids, device_depth = pending
                host = device_depth.cpu().numpy()
                for k, frame_id in enumerate(ids):
                    yield frame_id, host[k]
            pending = dispatched
