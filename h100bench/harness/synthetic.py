"""Inputs and weights made from ``--seed``, on the device, in a few large
calls. Frozen copies of ``chip_smoke.py`` (``seeded_model`` :234,
``synthetic_sequence`` :250, ``synthetic_frames`` :265,
``synthetic_batch`` :1113, ``conditioned`` :1149, at commit 6f9cbf0),
with their random draws moved onto the device and varied by the seed.

The same seed gives the same inputs on the same device. Every seed gives
the same sizes and the same work: colors, motions, pixel noise and
weights vary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch import nn

MARGIN = 16  # raw frames hold the crop plus this border on every side


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def seeded_state_dict(skeleton: nn.Module, seed: int, device: torch.device,
                      conditioned: bool) -> Dict[str, torch.Tensor]:
    """Weights for ``skeleton``'s state_dict (its names and shapes; it may
    live on the meta device), drawn on ``device`` from ``seed``:
    Kaiming-normal convolutions (std sqrt(2 / fan_in)) with zero biases,
    BatchNorm weight U[0.5, 1.5), bias N(0, 0.1), running mean N(0, 0.2)
    and running variance U[0.5, 1.5). One draw per kind for the whole
    model. ``conditioned`` scales the head by 0.1 and sets its bias to 3,
    so the depth is |3 + 0.1 conv|: a raw init leaves depths at the |.|
    kink and the 1/z pole of the objective, whose gradients then reach
    1e4-1e7."""
    g = generator(seed, device)
    convs = [(n, m) for n, m in skeleton.named_modules() if isinstance(m, nn.Conv2d)]
    norms = [(n, m) for n, m in skeleton.named_modules()
             if isinstance(m, nn.BatchNorm2d)]
    n_w = sum(m.weight.numel() for _, m in convs)
    n_c = sum(m.num_features for _, m in norms)
    z = torch.randn(n_w, generator=g, device=device)
    bn = {"weight": torch.rand(n_c, generator=g, device=device) + 0.5,
          "bias": torch.randn(n_c, generator=g, device=device) * 0.1,
          "running_mean": torch.randn(n_c, generator=g, device=device) * 0.2,
          "running_var": torch.rand(n_c, generator=g, device=device) + 0.5}
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, m in convs:
        n = m.weight.numel()
        fan_in = m.weight[0].numel()
        out[f"{name}.weight"] = (z[off:off + n] * (2.0 / fan_in) ** 0.5).view(m.weight.shape)
        out[f"{name}.bias"] = torch.zeros(m.out_channels, device=device)
        off += n
    off = 0
    for name, m in norms:
        n = m.num_features
        for key, values in bn.items():
            out[f"{name}.{key}"] = values[off:off + n]
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                         device=device)
        off += n
    if conditioned:
        out["finalConv.weight"] = out["finalConv.weight"] * 0.1
        out["finalConv.bias"] = out["finalConv.bias"] * 0.1 + 3.0
    missing = set(skeleton.state_dict()) ^ set(out)
    if missing:
        raise KeyError(f"seeded weights and the skeleton disagree on {sorted(missing)}")
    return {k: v.contiguous() for k, v in out.items()}


def train_batches(n: int, batch: int, height: int, width: int, seed: int,
                  device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``n`` geometrically consistent batches (NHWC, the port's batch keys):
    a depth plane at 1 inside a boundary mask, a forward motion along the
    optical axis of U(0.01, 0.03) (``chip_smoke`` moves every row by 0.02),
    sparse depth and flow exact from that geometry, and colors U(-1, 1):
    the motions and colors drawn from ``seed``, different in every row of
    every batch, so that every row's loss and gradient are its own."""
    b, h, w = batch, height, width
    f32 = dict(dtype=torch.float32, device=device)
    g = generator(seed, device)
    colors = torch.rand(n, 2, b, h, w, 3, generator=g, device=device) * 2.0 - 1.0
    motion = 0.01 + 0.02 * torch.rand(n, b, generator=g, device=device)
    k = torch.zeros(b, 3, 3, **f32)
    k[:, 0, 0] = k[:, 1, 1] = 80.0 * w / 64
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = w / 2, h / 2, 1.0
    rot = torch.eye(3, **f32).expand(b, 3, 3).contiguous()
    mask = torch.zeros(b, h, w, 1, **f32)
    mask[:, h // 8:-h // 8, w // 8:-w // 8] = 1.0
    sparse = torch.zeros(b, h, w, 1, **f32)
    sparse[:, h // 5:-h // 5:4, w // 5:-w // 5:4] = 1.0
    ys, xs = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32), indexing="ij")
    batches = []
    for i in range(n):
        t12 = torch.zeros(b, 3, 1, **f32)
        t12[:, 2, 0] = motion[i]
        z2 = (1.0 - motion[i])[:, None, None]
        flow = torch.stack([(xs - w / 2) / z2 + w / 2 - xs,
                            (ys - h / 2) / z2 + h / 2 - ys], -1)
        flow = flow / torch.tensor([w, h], **f32)
        batches.append({
            "color_1": colors[i, 0], "color_2": colors[i, 1],
            "sparse_depth_1": sparse, "sparse_depth_2": sparse,
            "depth_mask_1": sparse, "depth_mask_2": sparse,
            "flow_1": flow * sparse, "flow_2": -flow * sparse,
            "flow_mask_1": sparse, "flow_mask_2": sparse, "boundary": mask,
            "rotation_1_wrt_2": rot, "rotation_2_wrt_1": rot,
            "translation_1_wrt_2": t12, "translation_2_wrt_1": -t12,
            "intrinsic": k,
        })
    return batches


@dataclasses.dataclass
class Sequence:
    """What ``DepthPredictor`` reads of a sequence: the crop box in the
    (downsampled) frame and the boundary mask of the crop."""
    crop_positions: list
    mask_boundary: np.ndarray


def sequence(height: int, width: int) -> Sequence:
    """A crop of (height, width) inside frames with a MARGIN border, and a
    round boundary mask."""
    yy, xx = np.mgrid[:height, :width]
    inside = ((yy - height / 2) / height) ** 2 + ((xx - width / 2) / width) ** 2 < 0.2
    return Sequence([MARGIN, MARGIN + height, MARGIN, MARGIN + width],
                    (inside * 255).astype(np.uint8))


def raw_frames(n: int, height: int, width: int, scale: int, seed: int,
               device: torch.device) -> List[np.ndarray]:
    """``n`` raw uint8 BGR frames of (height + 2 MARGIN) x (width + 2 MARGIN)
    times ``scale``: smooth gradients plus noise U{0..55} from ``seed``,
    drawn on the device and read back once."""
    hh, ww = (height + 2 * MARGIN) * scale, (width + 2 * MARGIN) * scale
    yy, xx = torch.meshgrid(torch.arange(hh, device=device, dtype=torch.float32),
                            torch.arange(ww, device=device, dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([xx / ww, yy / hh, (xx + yy) / (hh + ww)], -1) * 200
    noise = torch.randint(0, 56, (n, hh, ww, 3), generator=generator(seed, device),
                          device=device, dtype=torch.uint8)
    frames = (base.floor().to(torch.uint8) + noise).cpu().numpy()
    return list(frames)
