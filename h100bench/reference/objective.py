"""The self-supervised objective and its optimizer, plain PyTorch, NHWC
maps and float32 (the endoscopy reference's models.py:317-554,
losses.py:57-146, train.py:239-327 and scheduler.py).

One step: both frames through the network as one stacked 2B batch,
per-sample scale recovery from the sparse SfM depths, dense flow from
depth against the sparse flow (SFL), frame 2's depth warped into frame 1
and back by a four-gather bilinear sampler against the prediction (DCL),
then clip-by-global-norm(10) and momentum SGD (0.9) at the cyclic rate.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

AXES = (1, 2, 3)


def sample_bilinear(image: torch.Tensor, px: torch.Tensor, py: torch.Tensor
                    ) -> torch.Tensor:
    """image (B, H, W, C) at pixel coordinates (px, py) (B, Hq, Wq), pixel
    centres at integers, zeros outside: four gathers, weighted. The
    coordinates are clamped to [-2, size + 1] first, which changes no value
    (every tap there is outside the image) and keeps floor() small."""
    b, h, w, c = image.shape
    px = px.clamp(-2.0, w + 1.0)
    py = py.clamp(-2.0, h + 1.0)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    flat = image.reshape(b, h * w, c)
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0.long() + dx, y0.long() + dy
            inside = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(image.dtype)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1, 1)
            taps = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(*px.shape, c)
            out = out + taps * (wy * wx * inside)[..., None]
    return out


def _grid(h: int, w: int, like: torch.Tensor):
    y, x = torch.meshgrid(torch.arange(h, dtype=like.dtype, device=like.device),
                          torch.arange(w, dtype=like.dtype, device=like.device),
                          indexing="ij")
    return x, y


def _homogeneous(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    x, y = _grid(h, w, like)
    return torch.stack([x, y, torch.ones_like(x)], -1)  # (H, W, 3)


def reprojection(depth, rotation, translation, intrinsics):
    """Frame-2 homogeneous coordinates of every frame-1 pixel: K R^T K^-1
    [u v 1]^T d + K R^T (-t), as (x, y, z) maps (B, H, W, 1) each."""
    _, h, w, _ = depth.shape
    k_inv = torch.linalg.inv(intrinsics)
    m = intrinsics @ rotation.transpose(1, 2) @ k_inv          # (B, 3, 3)
    t = (intrinsics @ rotation.transpose(1, 2) @ (-translation))[:, None, None, :, 0]
    rays = torch.einsum("bij,hwj->bhwi", m, _homogeneous(h, w, depth))
    p = rays * depth + t                                       # (B, H, W, 3)
    return p[..., 0:1], p[..., 1:2], p[..., 2:3]


def flow_from_depth(depth, mask, translation, rotation, intrinsics):
    """((u2 - u) / W, (v2 - v) / H) (B, H, W, 2); masked pixels divide by
    1e30, so their u2, v2 go to ~0."""
    _, h, w, _ = depth.shape
    px, py, pz = reprojection(depth, rotation, translation, intrinsics)
    pz = 1.0e30 * (1.0 - mask) + mask * pz
    x, y = _grid(h, w, depth)
    return torch.cat([(px / pz - x[..., None]) / w, (py / pz - y[..., None]) / h], -1)


def warp_depth(depth_1, depth_2, mask, translation, rotation, intrinsics,
               epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame 2's depth, as seen from frame 2 of frame-1's points, sampled
    at frame-1's pixels' positions in frame 2; and the mask where both
    frames see the point (sampled mask >= 0.9)."""
    _, h, w, _ = depth_1.shape
    d1, d2 = depth_1 * mask, depth_2 * mask
    px, py, pz = reprojection(d1, rotation, translation, intrinsics)
    pz = torch.where(mask > 0.5, pz, torch.full_like(pz, epsilon))
    pz = torch.where(pz > 0.0, pz, torch.full_like(pz, epsilon))
    u2, v2 = px / pz, py / pz
    # z of frame-1's point as seen from frame 2 (K t)_z + d2 (K R K^-1 p)_z
    k_inv = torch.linalg.inv(intrinsics)
    m2 = intrinsics @ rotation @ k_inv
    z_ray = torch.einsum("bj,hwj->bhw", m2[:, 2, :], _homogeneous(h, w, d2))[..., None]
    t_z = (intrinsics @ translation)[:, 2, 0][:, None, None, None]
    d1_in_2 = mask * (t_z + d2 * z_ray)
    sampled = sample_bilinear(torch.cat([d1_in_2, mask], -1),
                              u2[..., 0] - 0.5, v2[..., 0] - 0.5)
    intersect = (sampled[..., 1:2] * mask >= 0.9).to(depth_1.dtype)
    return sampled[..., 0:1], intersect


def scale_recovery(pred, sparse, sparse_mask, epsilon: float) -> torch.Tensor:
    """pred times each sample's mean ratio sparse / pred over the sparse
    points above half their masked mean."""
    binary = (sparse_mask > 1.0e-8).to(pred.dtype)
    mean_sparse = (sparse * binary).sum(AXES, keepdim=True) / binary.sum(AXES, keepdim=True)
    above = (sparse > 0.5 * mean_sparse).to(pred.dtype)
    scale = ((sparse * above / (epsilon + pred)).sum(AXES, keepdim=True)
             / above.sum(AXES, keepdim=True))
    return scale * pred


def sparse_flow_loss(flows, flows_from_depth, masks) -> torch.Tensor:
    per = (masks * (flows - flows_from_depth).abs()).sum(AXES) / (1.0 + masks.sum(AXES))
    return per.mean()


def depth_consistency_loss(depth, warped, intersect, intrinsics) -> torch.Tensor:
    _, h, w, _ = depth.shape
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    x, y = _grid(h, w, depth)

    def unproject(d):
        return torch.cat([(x[None, ..., None] - cx[:, None, None, None])
                          / fx[:, None, None, None] * d,
                          (y[None, ..., None] - cy[:, None, None, None])
                          / fy[:, None, None, None] * d, d], -1)

    with torch.no_grad():
        mean_value = (intersect * depth).sum(AXES) / (1.0e-5 + intersect.sum(AXES))
    diff = (unproject(depth) - unproject(warped)).abs()
    per = (2.0 * (intersect * diff).sum(AXES)
           / (1.0e-5 * mean_value + (intersect * (depth + warped.abs())).sum(AXES)))
    return per.mean()


def loss(model, batch: Dict[str, torch.Tensor], sfl_weight: float,
         dcl_weight: float, epsilon: float, quant=None) -> torch.Tensor:
    """SFL + DCL of one batch, both frames through ``model`` stacked."""
    def both(a, b):
        return torch.cat([batch[a], batch[b]], 0)

    bound = both("boundary", "boundary")
    colors = both("color_1", "color_2") * bound
    depth = model(colors.permute(0, 3, 1, 2), quant).permute(0, 2, 3, 1)
    k = both("intrinsic", "intrinsic")
    t = both("translation_1_wrt_2", "translation_2_wrt_1")
    r = both("rotation_1_wrt_2", "rotation_2_wrt_1")
    scaled = scale_recovery(depth, both("sparse_depth_1", "sparse_depth_2"),
                            both("depth_mask_1", "depth_mask_2"), epsilon)
    flows = flow_from_depth(scaled, bound, t, r, k) * bound
    sfl = sfl_weight * sparse_flow_loss(both("flow_1", "flow_2") * bound, flows,
                                        both("flow_mask_1", "flow_mask_2") * bound)
    s1, s2 = scaled.chunk(2, 0)
    warped, intersect = warp_depth(scaled, torch.cat([s2, s1], 0), bound, t, r, k,
                                   epsilon)
    return sfl + dcl_weight * depth_consistency_loss(scaled, warped, intersect, k)


def cyclic_lr(count: int, base_lr: float, max_lr: float, step_size: int) -> float:
    """The triangular cyclic rate at the count of finite optimizer steps."""
    cycle = (1 + count // (2 * step_size))
    x = abs(count / step_size - 2 * cycle + 1)
    return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x)


def train_steps(model, batches: List[Dict[str, torch.Tensor]], hyper: dict,
                quant=None) -> dict:
    """Momentum SGD on ``batches``, one step each, in place on ``model``.
    Returns each step's loss, the first step's clipped gradient by
    parameter name (the momentum after one step) and the finite flags."""
    params = dict(model.named_parameters())
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first_update, count = [], None, 0
    model.train()
    for batch in batches:
        value = loss(model, batch, hyper["sfl_weight"], hyper["dcl_weight"],
                     hyper["zero_division_epsilon"], quant)
        grads = torch.autograd.grad(value, list(params.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            clip = hyper["grad_clip_norm"]
            factor = 1.0 if norm < clip else float(clip / norm)
            lr = cyclic_lr(count, hyper["min_lr"], hyper["max_lr"], hyper["lr_step_size"])
            for (n, p), g in zip(params.items(), grads):
                momentum[n] = g * factor + hyper["momentum"] * momentum[n]
                p -= lr * momentum[n]
        losses.append(float(value.detach()))
        count += 1
        if first_update is None:
            first_update = {n: m.detach().clone() for n, m in momentum.items()}
    return {"losses": losses, "first_update": first_update}
