#!/usr/bin/env python3
"""Drive the PyTorch port's depth-serving path once on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back
to the CPU or to a kernel's plain version):

  1. environment: the card's name and power limit, torch, CUDA and nvcc
     versions, whether OpenCV imports;
  2. build: the fused dense-layer kernel (``csrc/dense_conv.cu``) built for
     sm_90a, with ptxas's register and spill report;
  3. kernel: the kernel against its plain PyTorch version at every one of
     FCDenseNet-57's 44 dense-layer shapes at batch 8, 256x320, in f32
     (TF32 off) and bf16, with its time beside the plain version's;
  4. serving: ``DepthPredictor`` on a seeded reference-format ``.pt`` and
     synthetic frames, in bf16: ``predict_batch`` and ``stream`` at
     256x320 batch 8, ``predict_frame`` at the real 512x576 crop batch 1.
     Every forward must launch the kernel 44 times, and the depth must
     match the port's own CPU float32 forward inside the boundary mask;
  5. timing: forward latencies with CUDA events.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from endoscopydepthestimation_pytorch_tpu_torch import training
from endoscopydepthestimation_pytorch_tpu_torch.data import SequenceData
from endoscopydepthestimation_pytorch_tpu_torch.models import (
    FCDenseNet57, init_weights, save_reference_checkpoint)
from endoscopydepthestimation_pytorch_tpu_torch.ops import dense_conv
from endoscopydepthestimation_pytorch_tpu_torch.serving import DepthPredictor

KERNEL_SOURCE = "endoscopydepthestimation_pytorch_tpu_torch/csrc/dense_conv.cu"
KERNEL_REPLACES = "endoscopydepthestimation_pytorch_tpu/ops/dense_conv.py:73"
MARGIN = 16  # raw frames are the crop plus this border on every side
SEED = 0


def dense_layer_shapes(height: int, width: int, down=(4,) * 5, up=(4,) * 5,
                       bottleneck: int = 4, growth: int = 12,
                       first: int = 48) -> list:
    """(H, W, Cin) of every dense layer of an FCDenseNet, in forward order
    (FCDenseNet-57 by default: 44 layers)."""
    shapes, skips, c, h, w = [], [], first, height, width
    for n in down:
        shapes += [(h, w, c + j * growth) for j in range(n)]
        c += n * growth
        skips.append((h, w, c))
        h, w = h // 2, w // 2
    shapes += [(h, w, c + j * growth) for j in range(bottleneck)]
    prev = bottleneck * growth
    for n in up:
        h, w, skip_c = skips.pop()
        shapes += [(h, w, prev + skip_c + j * growth) for j in range(n)]
        prev = n * growth
    return shapes


def seeded_model(seed: int) -> torch.nn.Module:
    """FCDenseNet-57 with Kaiming weights and non-trivial BatchNorm
    parameters and running statistics, all drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    model = init_weights(FCDenseNet57(), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    return model.eval()


def synthetic_sequence(height: int, width: int) -> SequenceData:
    """A sequence whose crop is (height, width) inside frames with a
    MARGIN border, and a round boundary mask."""
    yy, xx = np.mgrid[:height, :width]
    inside = ((yy - height / 2) / height) ** 2 + ((xx - width / 2) / width) ** 2 < 0.2
    empty = np.zeros((0, 4), np.float32)
    return SequenceData(
        folder="synthetic", crop_positions=[MARGIN, MARGIN + height, MARGIN, MARGIN + width],
        selected_indexes=[], visible_view_indexes=[], point_cloud=empty,
        intrinsic_matrix=np.eye(3, 4, dtype=np.float32),
        mask_boundary=(inside * 255).astype(np.uint8),
        view_indexes_per_point=empty, extrinsics=[], projections=[],
        clean_point_list=np.zeros(0, np.float32))


def synthetic_frames(n: int, height: int, width: int, seed: int) -> list:
    """Raw uint8 BGR frames (smooth gradients plus noise)."""
    rng = np.random.RandomState(seed)
    hh, ww = height + 2 * MARGIN, width + 2 * MARGIN
    yy, xx = np.mgrid[:hh, :ww]
    frames = []
    for _ in range(n):
        base = np.stack([xx / ww, yy / hh, (xx + yy) / (hh + ww)], -1) * 200
        noise = rng.randint(0, 56, (hh, ww, 3))
        frames.append((base + noise).astype(np.uint8))
    return frames


def masked_rel_err(got: np.ndarray, ref: np.ndarray, height: int, width: int) -> float:
    """mean |got - ref| / mean |ref| inside the boundary mask."""
    mask = synthetic_sequence(height, width).mask_boundary / 255.0 > 0.9
    m = np.broadcast_to(mask, ref.shape)
    return float(np.abs(got - ref)[m].mean() / np.abs(ref)[m].mean())


def serving_phase(checkpoint, device, dtype, height: int, width: int,
                  batch: int, n_stream: int, n_batches: int = 2) -> dict:
    """``predict_batch`` n_batches times, then ``stream`` over n_stream raw
    frames (ragged tail included) at batch ``batch`` on ``device``.
    Returns the stream's depth, the first batch's colors and the number
    of forwards run."""
    sequence = synthetic_sequence(height, width)
    predictor = DepthPredictor(checkpoint, sequence, batch_size=batch,
                               downsampling=1.0, device=device, dtype=dtype)
    frames = synthetic_frames(n_stream, height, width, seed=SEED + 1)
    colors = np.stack([predictor.prepare(f) for f in frames[:batch]])
    for _ in range(n_batches):
        depth = predictor.predict_batch(colors)
        if depth.shape != (batch, height, width) or not np.isfinite(depth).all():
            raise AssertionError(f"predict_batch gave {depth.shape}, "
                                 f"finite={np.isfinite(depth).all()}")
    streamed = list(predictor.stream(frames))
    if [i for i, _ in streamed] != list(range(n_stream)):
        raise AssertionError("stream lost or reordered frames")
    depth = np.stack([d for _, d in streamed])
    if depth.shape != (n_stream, height, width) or not np.isfinite(depth).all():
        raise AssertionError(f"stream gave {depth.shape}, finite={np.isfinite(depth).all()}")
    if not np.allclose(depth[:batch], predictor.predict_batch(colors),
                       rtol=1e-5, atol=1e-6):
        raise AssertionError("stream and predict_batch disagree")
    return {"depth": depth, "colors": colors,
            "forwards": n_batches + 1 + -(-n_stream // batch)}


def cpu_reference(checkpoint, height: int, width: int, colors: np.ndarray) -> np.ndarray:
    """The port's own float32 CPU forward of the same weights and colors."""
    predictor = DepthPredictor(checkpoint, synthetic_sequence(height, width),
                               batch_size=colors.shape[0], downsampling=1.0,
                               device="cpu", dtype=torch.float32)
    return predictor.predict_batch(colors)


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(card: str, batch: int = 8, height: int = 256, width: int = 320) -> dict:
    """Kernel vs plain version at every dense-layer shape; times in bf16."""
    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    max_abs, max_f32_ratio, max_bf16_rel, ms, plain_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    print(f"kernel phase, batch {batch}, {height}x{width}, {card}:")
    print("  H    W    Cin  f32 max|d|/max|ref|  bf16 mean|d|/mean|ref|  "
          "kernel ms  plain ms")
    for h, w, c in dense_layer_shapes(height, width):
        x = torch.randn(batch, h, w, c, generator=g)
        scale = torch.rand(c, generator=g) + 0.5
        shift = torch.randn(c, generator=g) * 0.3
        wk = torch.randn(3, 3, c, 12, generator=g) * (2.0 / (9 * c)) ** 0.5
        bias = torch.randn(12, generator=g) * 0.1
        vec = [t.to(dev) for t in (scale, shift)]
        b32 = bias.to(dev)
        args32 = (x.to(dev), *vec, wk.to(dev), b32)
        got = dense_conv.fused_dense_conv(*args32)
        ref = dense_conv.fused_dense_conv_reference(*args32)
        err = (got - ref).abs().max().item()
        ratio = err / ref.abs().max().item()
        if not ratio <= 1e-4:
            raise AssertionError(f"f32 kernel mismatch at {(h, w, c)}: {ratio}")
        args16 = (x.to(dev, torch.bfloat16), *vec, wk.to(dev, torch.bfloat16), b32)
        got = dense_conv.fused_dense_conv(*args16).float()
        ref = dense_conv.fused_dense_conv_reference(*args16).float()
        rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
        if not rel <= 1e-2:
            raise AssertionError(f"bf16 kernel mismatch at {(h, w, c)}: {rel}")
        k_ms = _cuda_ms(lambda: dense_conv.fused_dense_conv(*args16), 20)
        p_ms = _cuda_ms(lambda: dense_conv.fused_dense_conv_reference(*args16), 20)
        print(f"  {h:<4} {w:<4} {c:<4} {ratio:<20.3e} {rel:<23.3e} "
              f"{k_ms:<10.4f} {p_ms:.4f}")
        max_abs, max_f32_ratio = max(max_abs, err), max(max_f32_ratio, ratio)
        max_bf16_rel = max(max_bf16_rel, rel)
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
    print(f"kernel phase ok: 44 shapes, f32 max|d| {max_abs:.3e} "
          f"(max|d|/max|ref| {max_f32_ratio:.3e} <= 1e-4), bf16 mean rel "
          f"{max_bf16_rel:.3e} <= 1e-2")
    print(f"timing [{card}] 44 dense layers, batch {batch} {height}x{width} bf16: "
          f"kernel {ms:.4f} ms, plain (cuDNN) {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def forward_ms(checkpoint, card: str, height: int, width: int, batch: int) -> float:
    """CUDA-event ms of one bf16 predict_step at (batch, height, width)."""
    predictor = DepthPredictor(checkpoint, synthetic_sequence(height, width),
                               batch_size=batch, downsampling=1.0,
                               device="cuda", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(SEED + 2)
    colors = (torch.rand(batch, height, width, 3, generator=g) * 2 - 1).cuda()
    boundary = torch.ones(batch, height, width, 1, device="cuda")
    t = _cuda_ms(lambda: training.predict_step(predictor.model, colors, boundary), 10)
    print(f"timing [{card}] forward bf16 batch {batch} {height}x{width}: {t:.4f} ms")
    return t


def _run(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(8)

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print(_run([dense_conv._build.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import cv2
        print(f"cv2 importable: yes ({cv2.__version__})")
    except ImportError:
        print("cv2 importable: no")

    t0 = time.perf_counter()
    report = dense_conv.build_report()
    print(f"built dense_conv.cu for sm_90a in {time.perf_counter() - t0:.1f} s; "
          "ptxas report:")
    print("\n".join(line for line in report.splitlines()
                    if "registers" in line or "spill" in line))
    if "sm_90a" not in report:
        raise AssertionError("the kernel was not compiled for sm_90a")

    kernel = kernel_phase(card)

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = Path(tmp) / "seeded_fcdensenet57.pt"
        save_reference_checkpoint(checkpoint, seeded_model(SEED))

        dense_conv.LAUNCHES = 0
        a = serving_phase(checkpoint, "cuda", torch.bfloat16, 256, 320,
                          batch=8, n_stream=24)
        hi = DepthPredictor(checkpoint, synthetic_sequence(512, 576), batch_size=1,
                            downsampling=1.0, device="cuda", dtype=torch.bfloat16)
        hi_frame = synthetic_frames(1, 512, 576, seed=SEED + 3)[0]
        hi_depth = hi.predict_frame(hi_frame)
        launches = dense_conv.LAUNCHES
        forwards = a["forwards"] + 1
        print(f"serving phase: {forwards} forwards, {launches} kernel launches")
        if launches != 44 * forwards:
            raise AssertionError(f"expected {44 * forwards} launches, got {launches}")
        if hi_depth.shape != (512, 576) or not np.isfinite(hi_depth).all():
            raise AssertionError(f"predict_frame gave {hi_depth.shape}")

        ref = cpu_reference(checkpoint, 256, 320, a["colors"][:2])
        rel_a = masked_rel_err(a["depth"][:2], ref, 256, 320)
        hi_colors = hi.prepare(hi_frame)[None]
        ref_hi = cpu_reference(checkpoint, 512, 576, hi_colors)[0]
        rel_b = masked_rel_err(hi_depth, ref_hi, 512, 576)
        print(f"serving vs CPU float32 forward, mean|d|/mean|ref| in the mask: "
              f"256x320 b8 {rel_a:.3e}, 512x576 b1 {rel_b:.3e} (limit 1e-2)")
        if not (rel_a <= 1e-2 and rel_b <= 1e-2):
            raise AssertionError("bf16 serving disagrees with the CPU forward")

        fwd = {"b8_256x320": forward_ms(checkpoint, card, 256, 320, 8),
               "b1_256x320": forward_ms(checkpoint, card, 256, 320, 1),
               "b1_512x576": forward_ms(checkpoint, card, 512, 576, 1)}
        print(f"forward ms: {json.dumps(fwd)}")

    print(json.dumps({"kernels": [{
        "name": "dense_conv_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
