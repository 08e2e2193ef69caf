"""Board images, depth exports and metric logging: the part of the JAX
package's ``utils/visualization.py`` that the trainer and the evaluate
CLI use (``make_grid`` :23, ``colorize_depth`` :35, ``flow_to_hsv`` :51,
``color_panel`` :69, ``training_panel`` :83, ``validation_panel`` :95,
``stack_panels`` :112, ``write_event`` :119, ``MetricWriter`` :145,
``weight_histograms`` :183, ``flow_color_wheel`` :196,
``write_depth_outputs`` :213, and the debug viewers :248-312).

Re-creates the reference's diagnostic imagery (utils.py:707-1044): JET
depth colormaps, HSV flow wheels, horizontal sample grids stacked into one
panel. ``MetricWriter`` writes scalars as JSONL and images as PNG always,
and to tensorboardX too where it is installed. Inputs are numpy arrays
or tensors (read back to the host).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import cv2
import numpy as np
import torch

from .pointcloud import point_cloud_from_depth, write_point_cloud


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def make_grid(images: np.ndarray, padding: int = 2) -> np.ndarray:
    """Horizontal grid of NHWC images with zero padding between them
    (replacement for torchvision.utils.make_grid used at utils.py:912)."""
    images = _to_numpy(images)
    n, h, w, c = images.shape
    out = np.zeros((h + 2 * padding, n * (w + padding) + padding, c), images.dtype)
    for i in range(n):
        x0 = padding + i * (w + padding)
        out[padding:padding + h, x0:x0 + w] = images[i]
    return out


def colorize_depth(depth_grid: np.ndarray, min_value: Optional[float] = None,
                   max_value: Optional[float] = None) -> np.ndarray:
    """Normalize to [0,1] and apply the JET colormap, returned RGB float32.
    Parity: reference utils.py:773-781, 924-928."""
    d = _to_numpy(depth_grid).astype(np.float32).squeeze(-1) if depth_grid.ndim == 3 \
        else _to_numpy(depth_grid).astype(np.float32)
    if min_value is None:
        min_value = float(d.min())
    if max_value is None:
        max_value = float(d.max())
    scale = max(max_value - min_value, 1e-12)
    norm = np.clip(np.abs((d - min_value) / scale), 0.0, 1.0)
    bgr = cv2.applyColorMap(np.uint8(255 * norm), cv2.COLORMAP_JET)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def flow_to_hsv(flow_grid: np.ndarray, max_v: Optional[float] = None):
    """Flow -> HSV wheel RGB image; hue = direction, value = magnitude.
    Returns (rgb float32, max_magnitude). Parity: reference utils.py:868-891
    (x-flow as-is, y-flow scaled by h/w, shared max across panels)."""
    flow = _to_numpy(flow_grid).astype(np.float32)
    h, w = flow.shape[:2]
    fx, fy = flow[..., 0], flow[..., 1] * h / w
    ang = np.arctan2(fy, fx) + np.pi
    mag = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((h, w, 3), np.uint8)
    hsv[..., 0] = np.uint8(ang * (180.0 / np.pi / 2.0))
    hsv[..., 1] = 255
    top = float(np.max(mag)) if max_v is None else max_v
    hsv[..., 2] = np.uint8(np.minimum(mag / max(top, 1e-12), 1.0) * 255)
    rgb = cv2.cvtColor(cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR), cv2.COLOR_BGR2RGB)
    return rgb.astype(np.float32) / 255.0, float(np.max(mag))


def color_panel(colors: np.ndarray, boundaries: Optional[np.ndarray] = None,
                is_hsv: bool = False) -> np.ndarray:
    """Normalized [-1,1] NHWC colors -> display grid RGB float32."""
    imgs = _to_numpy(colors) * 0.5 + 0.5
    if boundaries is not None:
        imgs = imgs * _to_numpy(boundaries)
    grid = make_grid(imgs)
    grid = np.clip(grid, 0.0, 1.0)
    if is_hsv:
        grid = cv2.cvtColor((grid * 255).astype(np.uint8),
                            cv2.COLOR_HSV2RGB_FULL).astype(np.float32) / 255.0
    return grid


def training_panel(colors, scaled_depths, sparse_flows, dense_flows,
                   is_hsv: bool = False) -> List[np.ndarray]:
    """The reference's 4-panel training row: color | JET depth | sparse
    flow | dense flow (utils.py:965-994); the dense-flow panel is scaled
    to the sparse-flow panel's max magnitude like the reference."""
    c = color_panel(colors, is_hsv=is_hsv)
    d = colorize_depth(make_grid(_to_numpy(scaled_depths))[:, :, 0])
    sf, max_v = flow_to_hsv(make_grid(_to_numpy(sparse_flows)))
    df, _ = flow_to_hsv(make_grid(_to_numpy(dense_flows)), max_v=max_v)
    return [c, d, sf, df]


def validation_panel(colors, sparse_depths, scaled_depths, warped_depths,
                     sparse_flows, dense_flows, boundaries,
                     is_hsv: bool = False) -> List[np.ndarray]:
    """The reference's 6-panel eval row (utils.py:903-962): color | sparse
    depth | pred depth | warped depth | sparse flow | dense flow, depth
    panels sharing pred-depth's range, flow panels sharing dense-flow's."""
    c = color_panel(colors, boundaries, is_hsv=is_hsv)
    pred = make_grid(_to_numpy(scaled_depths))[:, :, 0]
    lo, hi = float(pred.min()), float(pred.max())
    d = colorize_depth(pred, lo, hi)
    sd = colorize_depth(make_grid(_to_numpy(sparse_depths))[:, :, 0], lo, hi)
    wd = colorize_depth(make_grid(_to_numpy(warped_depths))[:, :, 0], lo, hi)
    df, max_v = flow_to_hsv(make_grid(_to_numpy(dense_flows)))
    sf, _ = flow_to_hsv(make_grid(_to_numpy(sparse_flows)), max_v=max_v)
    return [c, sd, d, wd, sf, df]


def stack_panels(panels: List[np.ndarray]) -> np.ndarray:
    """Vertically stack panel rows into one image (utils.py:894-900)."""
    width = max(p.shape[1] for p in panels)
    padded = [np.pad(p, ((0, 0), (0, width - p.shape[1]), (0, 0))) for p in panels]
    return np.vstack(padded)


def write_event(log, step: int, **data) -> None:
    """Append one JSON event line ``{..., step, dt}`` to an open text file.

    Repaired port of the reference's ``write_event`` (utils.py:817-822),
    which is broken there (py2 leftovers: undefined ``unicode``/``json``
    and ``datetime.time()`` never carries the current time). Same record
    layout — sorted keys, ``step`` and an ISO ``dt`` stamp — with the
    intended wall-clock time. ``MetricWriter`` is the structured superset
    used by the trainer; this stays for 1:1 API parity.
    """
    import datetime as _dt

    data["step"] = step
    data["dt"] = _dt.datetime.now().time().isoformat()
    log.write(json.dumps(data, sort_keys=True))
    log.write("\n")
    log.flush()


class MetricWriter:
    """Scalar + image logging: tensorboardX if it imports and starts,
    JSONL and PNG always.

    Mirrors the reference's SummaryWriter usage (train.py:348-350, 481-483)
    plus its per-epoch ``export_scalars_to_json`` (train.py:491-492).
    TensorBoard is optional logging, so any error while importing or
    starting tensorboardX (not only a missing package) leaves the writer
    on JSONL and PNG, as the JAX package's writer does; the device and the
    kernels never fall back this way.
    """

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._scalars: Dict[str, list] = {}
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(logdir=str(self.log_dir))
        except Exception:  # optional logging: a broken install must not stop a run
            self._tb = None

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        record = {"tag": tag, "step": step,
                  **{k: float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        self._scalars.setdefault(tag, []).append(record)
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in values.items()}, step)

    def add_image(self, tag: str, image_hwc: np.ndarray, step: int):
        # png always (direct artifact, testable); tensorboard when available
        path = self.log_dir / f"{tag.replace('/', '_')}_{step}.png"
        cv2.imwrite(str(path), cv2.cvtColor(
            np.uint8(np.clip(image_hwc, 0, 1) * 255), cv2.COLOR_RGB2BGR))
        if self._tb is not None:
            self._tb.add_image(tag, np.moveaxis(image_hwc, 2, 0), step)

    def export_scalars_to_json(self, path):
        with open(path, "w") as f:
            json.dump(self._scalars, f)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def write_depth_outputs(results_root, colors, scaled_depths, boundaries,
                        intrinsics, prefix: str = "", is_hsv: bool = False,
                        point_cloud_downsampling: int = 1) -> None:
    """Per sample a color jpg, a JET depth jpg and a colored ``.ply``: the
    consolidated form of the reference's generate_{training,validation,
    test}_output dumps (utils.py:1047-1243). NHWC numpy inputs, colors
    normalized to [-1, 1]."""
    results_root = Path(results_root)
    results_root.mkdir(parents=True, exist_ok=True)
    colors = np.asarray(colors)
    depths = np.asarray(scaled_depths) * np.asarray(boundaries)
    for j in range(colors.shape[0]):
        color = np.uint8(np.clip(colors[j] * 0.5 + 0.5, 0, 1) * 255)
        color = cv2.cvtColor(color, cv2.COLOR_HSV2BGR_FULL if is_hsv
                             else cv2.COLOR_RGB2BGR)
        d = depths[j, :, :, 0]
        span = max(float(d.max()) - float(d.min()), 1e-12)
        depth_vis = cv2.applyColorMap(
            np.uint8(np.clip((d - d.min()) / span, 0, 1) * 255), cv2.COLORMAP_JET)
        cv2.imwrite(str(results_root / f"{prefix}color_{j}.jpg"), color)
        cv2.imwrite(str(results_root / f"{prefix}depth_{j}.jpg"), depth_vis)
        cloud = point_cloud_from_depth(d, color, np.asarray(boundaries)[j, :, :, 0],
                                       np.asarray(intrinsics)[j],
                                       point_cloud_downsampling)
        write_point_cloud(str(results_root / f"{prefix}point_cloud_{j}.ply"), cloud)


def weight_histograms(model: torch.nn.Module, writer: MetricWriter, step: int,
                      prefix: str = "Weights") -> None:
    """A histogram per parameter, ``{prefix}/{name}``, to tensorboardX when
    the writer has it (reference utils.py:1042-1044, over
    ``named_parameters``); nothing without it."""
    if writer._tb is None:
        return
    for name, p in model.named_parameters():
        writer._tb.add_histogram(f"{prefix}/{name}", _to_numpy(p).ravel(), step)


def flow_color_wheel(size: int = 1001) -> np.ndarray:
    """The HSV flow-direction legend (reference utils.py:1900-1918,
    vectorized): hue = direction, value = magnitude; RGB uint8."""
    center = (size - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    fy = (ys - center) / size
    fx = (xs - center) / size
    ang = np.arctan2(fy, fx) + np.pi
    v = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((size, size, 3), np.uint8)
    hsv[..., 0] = np.uint8(ang * (180.0 / np.pi / 2.0))
    hsv[..., 1] = 255
    hsv[..., 2] = np.uint8(np.minimum(v, 0.5) * 2.0 * 255)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


# -- debug viewers (reference utils.py:707-781) --------------------------------


def _show_or_save(name: str, bgr: np.ndarray, interactive: bool,
                  save_dir: Optional[str]) -> None:
    if interactive:  # needs a display server
        cv2.imshow(name, bgr)
        cv2.waitKey(1)
    if save_dir is not None:
        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(out / f"{name}.png"), bgr)


def visualize_color_image(title: str, images, rebias: bool = False,
                          is_hsv: bool = False, idx_list=None,
                          interactive: bool = False,
                          save_dir: Optional[str] = None) -> None:
    """Per-sample color viewer (reference utils.py:707-725) on NHWC colors
    in [0, 1] (``rebias``: in [-1, 1]). Writes ``{title}{i}.png`` into
    ``save_dir``; ``interactive=True`` shows them as the reference does."""
    images = _to_numpy(images)
    idx_list = range(images.shape[0]) if idx_list is None else idx_list
    for i in idx_list:
        img = images[i].astype(np.float32)
        if rebias:
            img = img * 0.5 + 0.5  # undo Normalize(mean=std=0.5)
        img = np.uint8(np.clip(img * 255.0, 0, 255))
        img = cv2.cvtColor(img, cv2.COLOR_HSV2BGR_FULL if is_hsv
                           else cv2.COLOR_RGB2BGR)
        _show_or_save(f"{title}{i}", img, interactive, save_dir)


def visualize_depth_map(title: str, depths, min_value: Optional[float] = None,
                        max_value: Optional[float] = None, idx_list=None,
                        interactive: bool = False,
                        save_dir: Optional[str] = None):
    """Per-sample JET depth viewer (reference utils.py:728-770) on (B, H,
    W) or (B, H, W, 1) depths; writes ``{title}{i}.png`` into ``save_dir``.
    Returns the (min, max) used."""
    depths = _to_numpy(depths).astype(np.float32)
    if depths.ndim == 4:
        depths = depths[..., 0]
    if min_value is None:
        min_value = float(depths.min())
    if max_value is None:
        max_value = float(depths.max())
    idx_list = range(depths.shape[0]) if idx_list is None else idx_list
    span = max(max_value - min_value, 1.0e-8)
    for i in idx_list:
        norm = np.uint8(np.clip((depths[i] - min_value) / span * 255.0, 0, 255))
        _show_or_save(f"{title}{i}", cv2.applyColorMap(norm, cv2.COLORMAP_JET),
                      interactive, save_dir)
    return min_value, max_value


def display_depth_map(depth_map, min_value: Optional[float] = None,
                      max_value: Optional[float] = None) -> np.ndarray:
    """One depth map in JET (reference utils.py:773-781), returned as BGR
    uint8 rather than shown."""
    d = _to_numpy(depth_map).astype(np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    lo = float(d.min()) if min_value is None else min_value
    hi = float(d.max()) if max_value is None else max_value
    norm = np.uint8(np.clip((d - lo) / max(hi - lo, 1.0e-8) * 255.0, 0, 255))
    return cv2.applyColorMap(norm, cv2.COLORMAP_JET)
