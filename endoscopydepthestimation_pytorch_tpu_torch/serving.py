"""Streaming depth inference (JAX package ``serving.py``, ``DepthPredictor``
:54-240) and its two deployment artifacts.

A trained network (reference-format ``.pt``; FCDenseNet-57 unless
``architecture`` names another of ``models.ARCHITECTURES``, such as
``depth_anything_v2_vitl``) behind a double-buffered
pipeline: a host thread decodes and normalizes frame t+1 while the device
runs frame t, and results are read back one batch late, after the next
batch has been dispatched. Same faces as the JAX predictor: (B, H, W, 3)
float32 normalized colors in, (B, H, W) boundary-masked depth out.

For deployment a predictor writes the function colors -> masked depth,
with its weights, running BN statistics and boundary baked in, as a
``torch.export`` artifact (``export``, loaded by ``load_exported``; JAX
``export`` and ``load_exported``) or as a bundle for the Python-free
libtorch host ``csrc/serve_host.cpp`` (``export_native_bundle`` and
``build_native_host``; JAX ``export_pjrt_bundle`` and ``build_pjrt_host``).
In both an FC-DenseNet's dense layers stay K1, as the opaque op
``endodepth::fused_dense_conv`` (``ops/dense_conv``).
"""
from __future__ import annotations

import queue
import shutil
import threading
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import training
from .data import preprocess
from .data.augment import normalize_color
from .models import ARCHITECTURES, fixed_input_size
from .ops import _libtorch_build
from .utils import checkpoint as ckpt
from .utils import profiling


def build_native_host() -> Path:
    """Build the libtorch serving host (``csrc/serve_host.cpp``) with g++
    unless it is built; return the binary's path (JAX
    ``build_pjrt_host``). Raises with the compiler's output on failure."""
    return _libtorch_build.host_binary()


def load_exported(path, device="cuda"):
    """Load an artifact written by :meth:`DepthPredictor.export`.

    Returns ``fn(colors) -> depth``: ``(B, H, W, 3)`` float32 normalized
    colors (numpy or a tensor) to ``(B, H, W, 1)`` float32 boundary-masked
    depth on ``device``. It needs torch and ``ops.dense_conv``, which
    registers the K1 op, and no model code or checkpoint machinery. The
    artifact runs on the device it was exported on: ``device`` is the card
    unless the caller asks for the CPU, and without a card it raises.
    """
    from .ops import dense_conv  # noqa: F401  (registers endodepth::fused_dense_conv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_exported: no CUDA device (pass device='cpu' for "
                           "an artifact exported on the CPU)")
    program = torch.export.load(str(path))
    where = {t.device.type for t in (*program.state_dict.values(),
                                     *program.constants.values())
             if isinstance(t, torch.Tensor)}
    if where != {device.type}:
        raise ValueError(f"the artifact was exported on {sorted(where)}, not {device.type}")
    module = program.module()

    def fn(colors) -> torch.Tensor:
        x = torch.as_tensor(colors, dtype=torch.float32, device=device)
        with torch.inference_mode():  # as predict_step; traced under no_grad
            return module(x)

    return fn


class _MaskedDepth(torch.nn.Module):
    """colors (B, H, W, 3) -> predict_step(model, colors, boundary) *
    boundary, (B, H, W, 1) float32: the function the artifacts hold.
    ``predict_step`` runs under inference_mode, which ``torch.export``
    does not trace, so this repeats its two lines for a trace under
    no_grad."""

    def __init__(self, model: torch.nn.Module, boundary: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("boundary", boundary)

    def forward(self, colors: torch.Tensor) -> torch.Tensor:
        x = (colors * self.boundary).permute(0, 3, 1, 2)  # NCHW, channels_last
        return self.model(x).permute(0, 2, 3, 1) * self.boundary


class _Resized(torch.nn.Module):
    """A network that takes one input size only (``models.fixed_input_size``),
    behind bilinear resizes (align_corners False) of the colors to that
    size and of the depth back to the colors' (Depth Pro's ``infer``)."""

    def __init__(self, model: torch.nn.Module, size):
        super().__init__()
        self.model = model
        self.size = tuple(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[-2:])
        if size == self.size:
            return self.model(x)
        depth = self.model(torch.nn.functional.interpolate(
            x, size=self.size, mode="bilinear", align_corners=False))
        return torch.nn.functional.interpolate(depth, size=size, mode="bilinear",
                                               align_corners=False)


class DepthPredictor:
    """Checkpoint-backed depth inference on one sequence's calibration.

    ``sequence`` supplies the crop box and the boundary mask (a
    ``SequenceData``). ``architecture`` is a key of
    ``models.ARCHITECTURES``, the network the checkpoint holds. Parameters
    and BN statistics stay float32 on ``device`` (the CUDA card unless the
    caller asks for another, such as ``"cpu"``); activations run in
    ``dtype``. A network that takes one input size only (Depth Pro's
    1536x1536) sees each frame resized to it, and its depth is resized
    back to the crop. VGGT sees each frame as a sequence of one view
    (``training.predict_step``).
    """

    def __init__(self, checkpoint_path, sequence: preprocess.SequenceData,
                 batch_size: int = 1, downsampling: float = 4.0, *,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 architecture: str = "fcdensenet57"):
        self.sequence = sequence
        self.batch_size = batch_size
        self.downsampling = downsampling
        self.device = torch.device(device)
        sh, eh, sw, ew = sequence.crop_positions
        self.height, self.width = eh - sh, ew - sw

        model = ARCHITECTURES[architecture](n_classes=1, dtype=dtype)
        ckpt.load_any_checkpoint(checkpoint_path, model)
        fixed = fixed_input_size(architecture)
        if fixed is not None:
            model = _Resized(model, fixed)
        self.model = model.to(self.device).eval()

        boundary = (sequence.mask_boundary.astype(np.float32) / 255.0 > 0.9)
        boundary = boundary.astype(np.float32)[None, :, :, None]
        self._boundary = torch.from_numpy(
            np.repeat(boundary, batch_size, axis=0)).to(self.device)

    # -- host-side frame prep ------------------------------------------------

    def prepare(self, frame) -> np.ndarray:
        """Path or raw BGR frame -> normalized cropped float32 (H, W, 3)."""
        with profiling.span("prepare"):
            return self._prepare(frame)

    def _prepare(self, frame) -> np.ndarray:
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
        with profiling.span("dispatch"):
            x = torch.from_numpy(np.ascontiguousarray(colors, np.float32))
            depth = training.predict_step(self.model, x.to(self.device),
                                          self._boundary)
            return (depth * self._boundary)[..., 0]

    def _predict(self, colors: np.ndarray) -> np.ndarray:
        depth = self._dispatch(colors)
        with profiling.span("readback"):  # waits for the device
            return depth.cpu().numpy()

    def predict_batch(self, colors: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) normalized colors -> (B, H, W) masked depth. Under
        ``torch.profiler`` a root span with ``dispatch`` and ``readback``
        (``utils.profiling``)."""
        with profiling.root_span("predict_batch"):
            return self._predict(colors)

    def predict_frame(self, frame) -> np.ndarray:
        """A path or raw BGR frame -> (H, W) masked depth. Under
        ``torch.profiler`` a root span with ``prepare``, ``dispatch`` and
        ``readback``."""
        with profiling.root_span("predict_frame"):
            colors = np.repeat(self.prepare(frame)[None], self.batch_size, axis=0)
            return self._predict(colors)[0]

    # -- deployment artifacts --------------------------------------------------

    def _exported_program(self) -> torch.export.ExportedProgram:
        """The masked-depth function traced by ``torch.export`` under
        no_grad, at this predictor's batch, on its device: weights, BN
        statistics and boundary baked in, the 44 dense layers as
        ``endodepth::fused_dense_conv`` nodes."""
        colors = torch.zeros(self.batch_size, self.height, self.width, 3,
                             device=self.device)
        with torch.no_grad():
            return torch.export.export(_MaskedDepth(self.model, self._boundary),
                                       (colors,), strict=False)

    def export(self, path) -> None:
        """Write this predictor as one ``torch.export`` file (JAX ``export``).

        A host loads it with :func:`load_exported` on the device it was
        exported on. The batch is fixed at ``batch_size``; input
        ``(batch, H, W, 3)`` float32 normalized colors, output
        ``(batch, H, W, 1)`` float32 masked depth.
        """
        torch.export.save(self._exported_program(), str(path))

    def export_native_bundle(self, bundle_dir) -> None:
        """Write a bundle for the libtorch host ``csrc/serve_host.cpp``
        (JAX ``export_pjrt_bundle``). Layout::

            model.pt2  the AOTInductor package of the same function as
                       ``export``, for this predictor's device (``cuda``
                       or ``cpu``), depth in float32
            meta.txt   key=value input/output specs parsed by the host
                       (platform, shapes, dtypes)
            ops.so     the op library of ``csrc/dense_conv_op.cpp``, which
                       the package calls by name for the 44 dense layers

        The host then needs libtorch alone, and builds nothing when the
        bundle loads. Inductor compiles the glue between the K1 nodes; the
        K1 nodes stay opaque, and the other convolutions extern calls.
        """
        program = self._exported_program()
        bundle = Path(bundle_dir)
        bundle.mkdir(parents=True, exist_ok=True)
        torch._inductor.aoti_compile_and_package(
            program, package_path=str(bundle / "model.pt2"),
            inductor_configs={"cpp.cxx": (None, _libtorch_build.CXX)})

        def fmt(t: torch.Tensor):
            return ",".join(str(d) for d in t.shape), str(t.dtype).removeprefix("torch.")
        (colors,) = [n.meta["val"] for n in program.graph.nodes
                     if n.op == "placeholder" and n.name in
                     program.graph_signature.user_inputs]
        (depth,) = [n.meta["val"] for n in list(program.graph.nodes)[-1].args[0]]
        if depth.dtype != torch.float32:
            raise AssertionError(f"the exported depth is {depth.dtype}, not float32")
        lines = [f"platform={self.device.type}"]
        for kind, t in (("input0", colors), ("output0", depth)):
            shape, dtype = fmt(t)
            lines += [f"{kind}_shape={shape}", f"{kind}_dtype={dtype}"]
        (bundle / "meta.txt").write_text("\n".join(lines) + "\n")
        shutil.copyfile(_libtorch_build.op_library(), bundle / "ops.so")

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
