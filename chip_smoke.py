#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and evaluation paths on one
CUDA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back
to the CPU or to a kernel's plain version):

  1. environment: the card's name and power limit, torch, CUDA, nvcc and
     OpenCV versions;
  2. build: ``csrc/dense_conv.cu`` (K1), ``csrc/warp_sample.cu`` (K2, K3),
     ``csrc/block_engine.cu`` (K4, K5, K6; K1 and K4 share the bf16
     body in ``csrc/conv3x3_mma.cuh``) and ``csrc/sgd_update.cu`` (the
     optimizer), one nvcc each, started together,
     for sm_90a, with ptxas's register and spill report; then ``cuobjdump
     -sass``: the bf16 K1, K4, K5 and K6 must hold HMMA (tensor-core)
     instructions in every instantiation, and no bf16 instantiation of
     their FFMA kernels may exist;
  3. K1: the dense-layer kernel at every one of FCDenseNet-57's 44
     dense-layer shapes at batch 1 (256x320 and the 512x576 crop), 8
     (offline serving) and 16 (the train step's), in f32 (TF32 off)
     against its plain PyTorch version and in bf16 against its tight twin
     and the plain version, bitwise-equal repeats; its time through the
     wrapper and alone, by level, beside the plain version's and cuDNN's
     conv on the activated tensor; then at every level <= 128x160, batch 1
     and 8, its chunks split against one pass;
  4. K2/K3: the warp sampler's kernels against the plain four-gather
     version and its autograd at the train step's shape, image
     (16, 256, 320, 2) f32, full and grad-first variants, and K3's dimg
     against its twin bit for bit; NaN coordinates, non-finite g, a
     collapse of every query onto one texel (the fixed point's headroom),
     K3's device launches per backward and its share of tiles summed in
     shared memory at a smooth and a random warp; forward and backward
     times beside the plain ones and the library's, through the wrappers
     and alone (CUDA graph replay), K3 also at the random warp;
  5. K4/K5/K6: the block engine's kernels against their plain versions at
     every layer of FCDenseNet-57's 11 dense blocks at 2B = 16, 256x320,
     in f32 and bf16, with their times beside the plain versions' and the
     nearest cuDNN call on the activated tensor (through events and alone);
     each summed by level, through the wrapper and alone (CUDA graph
     replay); K4 at the levels <= 64x80 with its chunks split and in one
     pass, K5 at 64x80 and 32x40 in its narrow tile and in 8x32, K6 at
     256x320 and 8x10 with its n_split, half and twice as many; then the
     block's boundary (``boundary_phase``; also alone: ``python3 -c
     "import chip_smoke as c; c.boundary_phase(c.card_name())"``) at
     FC-DenseNet-103's and -57's last up block, bf16 2B = 16 256x320: the
     entry's copy bitwise x and its moments within 2e-6 of an f64 mean,
     dx bitwise its plain version's, repeats bitwise, and each kernel's
     time alone beside the PyTorch chain it replaced and its bytes bound;
     then the glue kernels between the engine's launches (``glue_phase``;
     alone the same way) over one FC-DenseNet-103 and one FCDenseNet-57
     step's glue launches on random partials: their time alone beside the
     plain twins' and their bytes bound; then the optimizer kernel
     against its plain loop on the gradients of one
     FC-DenseNet-103 and one FCDenseNet-57 train step, and its time
     through the wrapper and alone beside the loop's and its bytes bound;
  6. serving: ``DepthPredictor`` on a seeded reference-format ``.pt`` and
     synthetic frames, in bf16: ``predict_batch`` and ``stream`` at
     256x320 batch 8, ``predict_frame`` at the real 512x576 crop batch 1.
     Every forward must launch K1 44 times, and the depth must match the
     port's own CPU float32 forward inside the boundary mask;
  7. timing: forward latencies with CUDA events; a torch.profiler table
     of the b1 256x320 forward (device busy, idle share, launches per
     forward, the host's enqueue time) on a ``DepthPredictor`` built with
     its default device;
  8. serving export, bf16 256x320: the ``torch.export`` artifact of a b8
     predictor loaded by ``load_exported`` against ``predict_batch``; the
     op library and the libtorch host (``csrc/dense_conv_op.cpp``,
     ``csrc/serve_host.cpp``) built with g++ and nvcc; the b1 AOTInductor
     bundle; the host's timed run and ``--stream`` over 24 frames against
     the eager predictor. 44 K1 a forward everywhere, the host's counted
     by the op library; the host's ms/batch beside the Python forward's;
  9. training, FCDenseNet-57 at full width on a synthetic, geometrically
     consistent batch, every dense block through the engine: (a) one f32
     step on the card against the same step on the CPU (b2 128x160);
     (b) ten bf16 steps at b8 256x320 with finite, decreasing loss and 44
     K4, K5 and K6, 1 K2, 1 K3 and no K1 launches per step, timed with
     CUDA events; (c) a step with an empty depth mask, which must leave
     params, momentum, count and step and advance the BN statistics;
 10. profile: torch.profiler over three more bf16 train steps, the device
     time by op and by kernel and the device's idle share, of the profiled
     window and of the median step of (b);
 11. ``graph_phase`` (also alone: ``python3 -c "import chip_smoke as c;
     c.graph_phase(c.card_name())"``): 20 eager and 20 graphed
     FC-DenseNet-103 bf16 steps at b8 256x320 (``step_graph``), ms a step
     and the peak of each, the two states bitwise equal;
 12. the trainer (``train.main``, the CLI's entry point) on a
     synthetic SfM data root written by ``tests/torch_sfm_sequence.py``:
     two sequences of 15 raw 1024x1280 frames (a 256x320 crop). The
     precompute in spawned workers, the native host rasterizer bit for
     bit against its numpy version, the loader alone, then the trainer at
     b8 bf16 for epochs 0 and 1 (6 steps each, validation, a checkpoint
     each) from its own init with the head conditioned as (9)'s, and a
     resume from the epoch-0 checkpoint for epoch 1 under
     ``--profile_dir``: each run's launches (K2-K6, no K1), finite losses,
     every checkpoint loaded back, the median step against (9)'s, and the
     device's idle share of the profiled epoch;
 13. evaluation (``evaluate.main``, the evaluate CLI's entry point) on
     (12)'s epoch-1 checkpoint and data root, FCDenseNet-57 at 256x320:
     the f32 validation phase on the card against ``--device cpu`` on 4
     frame pairs (``metrics.json`` at rtol 1e-3), then the validation
     phase over 15 frames at b8 (a ragged last batch) and the test phase
     on 4 frames, each in f32 and bf16: every board, cloud and image
     written, finite metrics, every PLY parsed back with finite z >= 0,
     44 K1 a forward and one K2 a validation batch, ms a frame, and the
     host's time to write one PLY and one PNG;
 14. UNet (depth 6, wf 6), which runs PyTorch's convs and K2/K3: one f32
     step on the card against the CPU at b2 128x160, then the trainer
     with ``--architecture unet`` at b8 256x320 bf16 for 12 steps and its
     validation (K2 and K3 every step, no K1 or K4-K6), finite losses, the
     checkpoint loaded back, the median step;
 15. data parallel across processes (``parallel.distributed``): (a) K2-K6
     against their plain versions at a rank's shapes (2B = 8, as (4) and
     (5) without the times); two
     ranks spawned on the one card over gloo, FCDenseNet-57 at b8 256x320
     split 2 x b4 from (9)'s conditioned weights and batch: their f32
     step against one process's b8 step (the scalars, the step's update
     and the BN statistics), the same step with a planted fault (the
     engine's BN gradients twice too large) that the update's limit must
     reject, then ten bf16 steps with each
     rank's K2-K6 launches those of a step, and the ranks' parameters,
     momentum, BN statistics and losses bitwise equal; their median step
     (not a scaling figure); (b) the trainer over NCCL at world size 1
     through ``--coordinator_address``, ``--num_processes`` and
     ``--process_id``, one epoch with validation in a process of its own,
     beside the same run without the flags: both exit 0, launch what a
     run without a process group launches, and write a checkpoint that
     loads back;
 16. the aux paths and the activation stores, FCDenseNet-57 at full
     width: (a) ``distill.distill_step``, one f32 step on the card against
     the CPU at b2 128x160, then ten bf16 steps at b8 256x320 (finite,
     falling; 44 K1 for the teacher and 44 K4, K5, K6 for the student a
     step; the teacher unchanged); (b) ``validation.network_validation``
     over (12)'s validation frames from its epoch-0 and epoch-1
     checkpoints, f32 on the card against the CPU, then bf16 (44 K1 and 1
     K2 a batch), and ``failure.save_if_best`` over the two vectors; (c)
     the train step at b8 256x320 bf16 with act8 in ``replay`` and
     ``saved_buf`` modes and (d) with remat, each against the engine
     route in the same call: the first step's loss and new BN statistics
     bitwise equal, act8's gradient cosine above 0.99 and remat's
     gradients bitwise equal, ten steps finite and falling with K4 88 a
     step where the backward replays the blocks, peak memory and the
     median step, then the stores in turns; (e) the trainer with
     ``--act8`` and with ``--remat``, one epoch each, and their
     checkpoints loaded back;
 17. Depth Anything V2-Large (``--architecture depth_anything_v2_vitl``,
     ``depth_anything_phase``; also alone: ``python3 -c "import
     chip_smoke as c; c.depth_anything_phase(c.card_name())"``): the bf16
     train step at b8 518x644 (2B = 16), per step 24 attention calls, K2
     and K3 once, no K1 or K4-K6, one ``sgd_update`` C call over 402
     tensors and nothing restrided; the optimizer kernel against its
     plain loop on that step's gradients; ten steps by CUDA events, the
     loss finite, the peak memory; a torch.profiler table of two steps:
     device ms by kernel, the attention kernels by name and the fused
     SDPA op the step ran.
 18. Depth Pro (``--architecture depth_pro``, ``depth_pro_phase``; also
     alone: ``python3 -c "import chip_smoke as c;
     c.depth_pro_phase(c.card_name())"``): the bf16 train step at b1
     1536x1536 (two frames, 70 tiles and 2 images of 577 tokens), per step
     48 attention calls (24 batched over the tiles, 24 of the image
     encoder), 70 tiles, K2 and K3 once, no K1 or K4-K6, one
     ``sgd_update`` C call over 763 tensors and nothing restrided; ten
     steps by CUDA events, the loss finite, the peak memory; a
     torch.profiler table of two steps: device ms by kernel, the attention
     kernels and the fused SDPA op; then ``DepthPredictor`` on a 256x320
     crop, resized to 1536x1536 and back: 35 tiles a frame, the depth
     finite and of the crop's size, ms a frame.
 19. VGGT (``--architecture vggt_1b``, ``vggt_phase``; also alone:
     ``python3 -c "import chip_smoke as c; c.vggt_phase(c.card_name())"``):
     the bf16 network on one 420x518 pair against the float32 reference
     ``tests/reference_vggt.py`` (LayerScale 1, so the aggregator moves the
     depth); the bf16 train step at b4 pairs (8 frames, 4 sequences of
     2,230 tokens), per step 24 attention calls of the patch embedder, 24
     frame and 24 global calls, 8 views, K2 and K3 once, no K1 or K4-K6,
     one ``sgd_update`` C call over 1,271 tensors and nothing restrided;
     ten steps by CUDA events, the loss finite, the peak memory; a
     torch.profiler table of two steps; then ``DepthPredictor`` on a
     420x518 crop, each frame a one-view sequence, against the reference's
     one-view forward, ms a frame.
Only the main paths' launches (6, 8, 9, 12, 13's counted runs, 14b,
15a's bf16 steps on both ranks, 15b's NCCL run and 16's runs) enter the
``kernels`` line.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from endoscopydepthestimation_pytorch_tpu_torch import (distill, evaluate, failure, step_graph,
                                                        training, validation)
from endoscopydepthestimation_pytorch_tpu_torch import train as trainer
from endoscopydepthestimation_pytorch_tpu_torch.data import (SequenceData, augment, dataset,
                                                           native, preprocess, rasterizer,
                                                           readers)
from endoscopydepthestimation_pytorch_tpu_torch.models import (
    DepthAnythingV2Large, DepthProLarge, FCDenseNet57, FCDenseNet103, UNet, init_weights,
    save_reference_checkpoint)
from endoscopydepthestimation_pytorch_tpu_torch.models import depth_anything, depth_pro, vggt
from endoscopydepthestimation_pytorch_tpu_torch.ops import (_libtorch_build, act8, block_engine,
                                                          conv3x3_mma, dense_conv,
                                                          sgd_update, warp_sample)
from endoscopydepthestimation_pytorch_tpu_torch.serving import (DepthPredictor,
                                                                build_native_host,
                                                                load_exported)
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt
from endoscopydepthestimation_pytorch_tpu_torch.utils import plyio

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_sfm_sequence import write_sequence  # noqa: E402  (the tests' SfM writer)

CSRC = "endoscopydepthestimation_pytorch_tpu_torch/csrc/"
JAX_OPS = "endoscopydepthestimation_pytorch_tpu/ops/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "dense_conv_fwd": (CSRC + "dense_conv.cu", JAX_OPS + "dense_conv.py:73"),
    "warp_sample_fwd": (CSRC + "warp_sample.cu", JAX_OPS + "warp_pallas.py:98"),
    "warp_sample_bwd": (CSRC + "warp_sample.cu", JAX_OPS + "warp_pallas.py:110"),
    "block_engine_fwd": (CSRC + "block_engine.cu", JAX_OPS + "block_engine.py:332"),
    "block_engine_dinput": (CSRC + "block_engine.cu", JAX_OPS + "block_engine.py:642"),
    "block_engine_dweight": (CSRC + "block_engine.cu", JAX_OPS + "block_engine.py:919"),
}
# one H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor, f32 FFMA
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


def dense_block_shapes(height: int, width: int) -> list:
    """(H, W, C0) of FCDenseNet-57's 11 dense blocks in forward order (4
    layers of growth 12 each): the layer shapes of ``dense_layer_shapes``
    in groups of four."""
    return [dense_layer_shapes(height, width)[i] for i in range(0, 44, 4)]


def engine_launches(forwards: int, backwards: int, layers: int = 44, blocks: int = 11,
                    replays: int = 0, ranks: int = 1) -> dict:
    """``block_engine.LAUNCHES`` moved by ``forwards`` train-mode forwards,
    ``replays`` forwards replayed in a backward (act8, remat) and
    ``backwards`` backwards of a network of ``layers`` dense layers in
    ``blocks`` blocks (FCDenseNet-57 by default): K4 a layer and the entry
    a block a forward or replay, K5 and K6 a layer and the exit a block a
    backward; the glue once a block and once a layer (twice in a process
    group of ``ranks`` > 1) in each direction, the running statistics once
    a block a forward (not a replay)."""
    runs, glue = forwards + replays, blocks + (2 if ranks > 1 else 1) * layers
    return {"block_engine_fwd": layers * runs, "block_engine_dinput": layers * backwards,
            "block_engine_dweight": layers * backwards, "block_engine_entry": blocks * runs,
            "block_engine_exit": blocks * backwards, "block_engine_glue_fwd": glue * runs,
            "block_engine_glue_bwd": glue * backwards,
            "block_engine_running_stats": blocks * forwards}


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """The least time the card could take (ms), and what bounds it: the
    bytes over HBM's rate or the operations over the peak for the type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def seeded_model(seed: int, dtype=torch.float32) -> torch.nn.Module:
    """FCDenseNet-57 with Kaiming weights and non-trivial BatchNorm
    parameters and running statistics, all drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    model = init_weights(FCDenseNet57(dtype=dtype), g)
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


def _graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one ``fn()``: ``iters`` calls captured in one CUDA graph
    and replayed, so no host work stands between the launches."""
    fn()  # one-time set-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


# K1's cases: (batch, height, width), live serving at batch 1 (the training
# size and the real crop), offline serving at batch 8, the train step's 2B
K1_CASES = ((1, 256, 320), (1, 512, 576), (8, 256, 320), (16, 256, 320))


def _levels(height: int, width: int) -> tuple:
    return ("full resolution", "middle levels", f"<= {height // 8}x{width // 8}")


def _level(h: int, height: int, width: int) -> str:
    names = _levels(height, width)
    return names[0] if h == height else names[2] if h <= height // 8 else names[1]


def kernel_phase(card: str, cases=K1_CASES) -> dict:
    """K1 at every one of FCDenseNet-57's 44 dense-layer shapes of each
    (batch, height, width) case: f32 (TF32 off) against the plain version,
    max|d| <= 1e-4 max|ref|; bf16 against its tight twin (the same bf16
    operands, f32 sums, the f32 bias, one rounding) mean|d|/mean|ref| <=
    1e-4, and against the plain version (cuDNN's bf16 conv, another
    rounding) <= 1e-2; two bf16 launches bitwise equal. Times in bf16
    through the wrapper (CUDA events over back-to-back calls) and alone
    (CUDA graph replay), summed by level, beside the plain version's and
    cuDNN's conv of the already activated tensor (the nearest library call:
    none folds the BN and ReLU in). Returns the batch-8 256x320 times and
    bound, and the f32 max|d|."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_abs, worst, times = 0.0, {"f32": 0.0, "twin": 0.0, "plain": 0.0}, {}
    for batch, height, width in cases:
        keys = ("ms", "alone_ms", "plain_ms", "library_ms", "library_alone_ms")
        tot = dict.fromkeys(keys, 0.0)
        by_level = {k: dict.fromkeys(_levels(height, width), 0.0)
                    for k in ("ms", "alone_ms", "library_ms")}
        n_bytes, n_ops = 0.0, 0.0
        print(f"kernel phase, batch {batch}, {height}x{width}, {card}:")
        print("  H    W    Cin  tiling      f32 max|d|/max|ref|  bf16 mean rel: twin  "
              "plain      ms: kernel / alone / plain / cuDNN conv of the activated tensor")
        for h, w, c in dense_layer_shapes(height, width):
            def draw(*shape):
                return torch.randn(*shape, generator=g, device="cuda")
            x = draw(batch, h, w, c)
            scale = torch.rand(c, generator=g, device="cuda") + 0.5
            shift = draw(c) * 0.3
            wk = draw(3, 3, c, 12) * (2.0 / (9 * c)) ** 0.5
            bias = draw(12) * 0.1
            args32 = (x, scale, shift, wk, bias)
            got = dense_conv.fused_dense_conv(*args32)
            ref = dense_conv.fused_dense_conv_reference(*args32)
            err = (got - ref).abs().max().item()
            ratio = err / ref.abs().max().item()
            if c == 48:  # the first layer: both f32 results against f64 sums
                ref64 = dense_conv.fused_dense_conv_reference(
                    *(t.double() for t in args32)).float()
                print(f"  f32 at {(batch, h, w, c)} against the f64 conv of the same "
                      f"activation: K1 max|d|/max|ref| {_rel(got, ref64):.3e}, cuDNN "
                      f"{_rel(ref, ref64):.3e}; K1 and cuDNN bitwise equal: "
                      f"{torch.equal(got, ref)}")
                del ref64
            args16 = (x.bfloat16(), scale, shift, wk.bfloat16(), bias)
            got = dense_conv.fused_dense_conv(*args16)
            again = dense_conv.fused_dense_conv(*args16)
            rel = {}
            for name, plain in (("twin", dense_conv.fused_dense_conv_twin),
                                ("plain", dense_conv.fused_dense_conv_reference)):
                r = plain(*args16).float()
                rel[name] = ((got.float() - r).abs().mean() / r.abs().mean()).item()
            tiling = dense_conv.forward_tiling(torch.bfloat16, batch, h, w, c)
            vw = dense_conv.vector_width(torch.bfloat16, c, 12, args16[0].data_ptr(),
                                         args16[3].data_ptr(), got.data_ptr())
            if not (ratio <= 1e-4 and rel["twin"] <= 1e-4 and rel["plain"] <= 1e-2
                    and torch.equal(got, again)):
                raise AssertionError(f"K1 mismatch at {(batch, h, w, c)}: f32 {ratio}, "
                                     f"bf16 {rel}, repeat equal {torch.equal(got, again)}")
            a16 = torch.relu(x * scale + shift).bfloat16().permute(0, 3, 1, 2)
            w16 = wk.bfloat16().permute(3, 2, 0, 1).contiguous()
            b16 = bias.bfloat16()
            kernel = lambda: dense_conv.fused_dense_conv(*args16)  # noqa: E731
            library = lambda: F.conv2d(a16, w16, b16, padding=1)  # noqa: E731
            t = {"ms": _cuda_ms(kernel, 20), "alone_ms": _graph_ms(kernel),
                 "plain_ms": _cuda_ms(lambda: dense_conv.fused_dense_conv_reference(
                     *args16), 10),
                 "library_ms": _cuda_ms(library, 20), "library_alone_ms": _graph_ms(library)}
            print(f"  {h:<4} {w:<4} {c:<4} {tiling[0]}x{tiling[1]}/{tiling[2]:<2} v{vw} "
                  f"{ratio:<20.3e} {rel['twin']:<11.3e} {rel['plain']:<10.3e} "
                  + " / ".join(f"{t[k]:.4f}" for k in ("ms", "alone_ms", "plain_ms",
                                                       "library_ms")))
            max_abs = max(max_abs, err)
            worst = {"f32": max(worst["f32"], ratio), "twin": max(worst["twin"], rel["twin"]),
                     "plain": max(worst["plain"], rel["plain"])}
            for k in keys:
                tot[k] += t[k]
            for k in by_level:
                by_level[k][_level(h, height, width)] += t[k]
            pixels = batch * h * w
            n_bytes += 2 * (pixels * (c + 12) + 9 * c * 12) + 4 * (2 * c + 12)
            n_ops += 2 * 9 * 12 * pixels * c
            del x, args32, args16, got, again, ref, a16
        bound_ms, bound_by = bound(n_bytes, n_ops, torch.bfloat16)
        print(f"timing [{card}] K1 dense_conv_fwd, 44 dense layers, batch {batch} "
              f"{height}x{width} bf16: kernel {tot['ms']:.4f} ms through the wrapper, "
              f"{tot['alone_ms']:.4f} alone (CUDA graph replay); plain (cuDNN) "
              f"{tot['plain_ms']:.4f} ms; cuDNN conv of the activated tensor "
              f"{tot['library_ms']:.4f} ms, {tot['library_alone_ms']:.4f} alone; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e9:.3f} GB, "
              f"{n_ops / 1e9:.1f} GFLOP)")
        print(f"timing [{card}] K1 dense_conv_fwd bf16 by level, batch {batch} "
              f"{height}x{width}: " + "; ".join(
                  f"{k}: " + ", ".join(f"{lv} {v:.4f}" for lv, v in by_level[k].items())
                  for k in by_level) + " (ms; ms = through the wrapper, alone_ms = CUDA "
              "graph replay, library_ms = cuDNN through events)")
        times[(batch, height, width)] = {**tot, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"kernel phase ok: 44 shapes at (batch, height, width) {list(cases)}, f32 max|d| "
          f"{max_abs:.3e} (max|d|/max|ref| {worst['f32']:.3e} <= 1e-4), bf16 mean rel "
          f"against the twin {worst['twin']:.3e} <= 1e-4, against the plain version "
          f"{worst['plain']:.3e} <= 1e-2, repeats bitwise equal")
    return {"max_abs_err": max_abs, **times[(8, 256, 320)]}


def k1_split_phase(card: str, batches=(1, 8), height: int = 256, width: int = 320) -> None:
    """K1 at every level <= 128x160 with its chunks split across
    ~FORWARD_BLOCKS blocks against one pass, device ms by CUDA graph replay
    summed over the level's layers, two alternating rounds, at batch 1 and
    8; beside the split the wrapper picks (it splits below SPLIT_BELOW
    tiles)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tiling = dense_conv.forward_tiling
    for batch in batches:
        levels = {}
        for h, w, c in dense_layer_shapes(height, width):
            if h > height // 2:
                continue
            x = torch.randn(batch, h, w, c, generator=g, device="cuda").bfloat16()
            scale = torch.rand(c, generator=g, device="cuda") + 0.5
            shift = torch.randn(c, generator=g, device="cuda") * 0.3
            wk = (torch.randn(3, 3, c, 12, generator=g, device="cuda") * 0.05).bfloat16()
            bias = torch.randn(12, generator=g, device="cuda") * 0.1
            tile = conv3x3_mma.mma_tile(h, w)
            n_tiles = conv3x3_mma.n_tiles(batch, h, w, *tile)
            n_split = min(-(-c // conv3x3_mma.CHUNK),
                          -(-conv3x3_mma.FORWARD_BLOCKS // n_tiles))
            t = levels.setdefault((h, w), {"split": [0.0, 0.0], "one pass": [0.0, 0.0],
                                           "n_split": [], "wrapper": [], "tiles": n_tiles})
            t["n_split"].append(n_split)
            t["wrapper"].append(tiling(torch.bfloat16, batch, h, w, c)[2])
            for rep in range(2):
                for key, n in (("split", n_split), ("one pass", 1)):
                    dense_conv.forward_tiling = lambda *_, n=n: (*tile, n)
                    try:
                        t[key][rep] += _graph_ms(
                            lambda: dense_conv.fused_dense_conv(x, scale, shift, wk, bias))
                    finally:
                        dense_conv.forward_tiling = tiling
        for (h, w), t in levels.items():
            print(f"timing [{card}] K1 dense_conv_fwd bf16 device ms, batch {batch}, the "
                  f"{len(t['n_split'])} layers at {h}x{w} ({t['tiles']} tiles; CUDA graph "
                  f"replay, two alternating rounds): split (n_split {t['n_split']}) "
                  + " / ".join(f"{v:.4f}" for v in t["split"]) + ", one pass "
                  + " / ".join(f"{v:.4f}" for v in t["one pass"])
                  + f"; the wrapper's n_split {t['wrapper']}")


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


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref|."""
    return ((got - ref).abs().max() / ref.abs().max()).item()


def build_phase() -> None:
    """Build the four kernel libraries (one nvcc each) and the host
    rasterizer (g++), all started together."""
    t0 = time.perf_counter()
    modules = (dense_conv, warp_sample, block_engine, sgd_update)
    with ThreadPoolExecutor(len(modules) + 1) as pool:
        host = pool.submit(native.build)
        reports = list(pool.map(lambda m: m.build_report(), modules))
        host.result()
    print(f"built dense_conv.cu, warp_sample.cu, block_engine.cu and sgd_update.cu for "
          f"sm_90a and the host rasterizer (g++) in {time.perf_counter() - t0:.1f} s; ptxas "
          f"report:")
    for report in reports:
        # one line a kernel: its mangled name after the file's anonymous
        # namespace (kernel and template arguments), registers, stack
        name, frame = "?", ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                name = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", line.split("'")[1])
            elif "stack frame" in line:
                frame = line.strip()
            elif "Used" in line and "registers" in line:
                print(f"  {name[:60]}: {line.split(':', 1)[1].strip()}; {frame}")
        if "sm_90a" not in report:
            raise AssertionError("a kernel was not compiled for sm_90a")
    tensor_core_sass_check()


def _sass_functions(module, name: str) -> dict:
    """mangled kernel name -> its SASS, from ``cuobjdump -sass`` of the
    module's built library."""
    lib = module._build.library_path(name, module._SOURCES)
    cuobjdump = Path(module._build.nvcc_path()).parent / "cuobjdump"
    functions = {}
    for chunk in _run([str(cuobjdump), "-sass", str(lib)]).split("Function : ")[1:]:
        fn, _, body = chunk.partition("\n")
        functions[fn.strip()] = body
    return functions


def tensor_core_sass_check() -> None:
    """``cuobjdump -sass`` of the dense_conv and block_engine libraries:
    the bf16 K1, K4, K5 and K6 must run on the tensor cores (HMMA
    instructions in every instantiation: K1's 9 = 3 tile widths x 16-byte,
    8-byte and scalar halo loads, K4's, K5's and K6's 6 = 3 x vector and
    scalar loads; K1 and K4 36 each, K5 72), and no bf16
    instantiation of their FFMA kernels may exist."""
    checks = ((dense_conv, "dense_conv", (("K1", "fwd_mma_kernel", 9, 36, "dense_conv_fwd_kernel"),)),
              (block_engine, "block_engine", (("K4", "fwd_mma_kernel", 6, 36, "fwd_kernel"),
                                              ("K5", "dinput_mma_kernel", 6, 72, "dinput_kernel"),
                                              ("K6", "dweight_mma_kernel", 6, None,
                                               "dweight_kernel"))))
    for module, lib, kernels in checks:
        functions = _sass_functions(module, lib)
        for kernel, mma, count, per, ffma in kernels:
            hmma = {name: sum("HMMA" in line for line in body.splitlines())
                    for name, body in functions.items() if mma in name}
            ffma_bf16 = [n for n in functions if ffma in n and "bfloat16" in n]
            print(f"cuobjdump -sass {lib}: HMMA instructions in the bf16 {kernel} {hmma}; "
                  f"bf16 instantiations of the FFMA {kernel}: {ffma_bf16 or 'none'}")
            if len(hmma) != count or min(hmma.values()) == 0 or ffma_bf16:
                raise AssertionError(f"the bf16 {kernel} does not run on the tensor cores "
                                     f"only, in its {count} instantiations")
            if per is not None and set(hmma.values()) != {per}:
                raise AssertionError(f"the bf16 {kernel} changed: {per} HMMA expected in each")


def _value_and_grads(fn, leaves, cot):
    """fn(*leaves) and the gradients of <fn(*leaves), cot> w.r.t. leaves."""
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


def _device_launches(fn) -> list:
    """(name, device us) of each device activity (kernels and memsets) of
    one ``fn()``, by torch.profiler, after one call outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(re.split(r"[<(]", e.name.replace("(anonymous namespace)::", "")
                      .replace("void ", ""))[0].strip(), e.time_range.elapsed_us())
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _sampler_inputs(b: int, h: int, w: int) -> tuple:
    """Image (b, h, w, 2), a random warp over [-3, size+3] (clamped to the
    sampler's band) with every 7th row on integer coordinates, and a
    cotangent; f32 on the card."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 10)
    image = torch.randn(b, h, w, 2, generator=g).to(dev)
    px = torch.rand(b, h, w, generator=g) * (w + 6) - 3
    py = torch.rand(b, h, w, generator=g) * (h + 6) - 3
    px[:, ::7], py[:, ::7] = px[:, ::7].round(), py[:, ::7].round()
    px, py = px.clamp(-2, w + 1).to(dev), py.clamp(-2, h + 1).to(dev)
    cot = torch.randn(b, h, w, 2, generator=g).to(dev)
    return image, px, py, cot


def sampler_check(image, px, py, cot) -> dict:
    """K2 and K3 against the plain four-gather sampler and its autograd,
    full and grad-first variants (max|d|/max|ref| <= 1e-5), and K3's dimg
    against its twin ``_backward_plain`` bit for bit; returns the largest
    relative and absolute errors."""
    err = {"fwd": 0.0, "bwd": 0.0, "abs_fwd": 0.0, "abs_bwd": 0.0}
    for grad_first in (False, True):
        leaves = [t.clone().requires_grad_() for t in (image, px, py)]
        got, got_g = _value_and_grads(
            lambda *a: warp_sample.sample_bilinear(*a, grad_first_only=grad_first),
            leaves, cot)
        ref_cot = torch.cat([cot[..., :1], torch.zeros_like(cot[..., 1:])], -1
                            ) if grad_first else cot
        ref, ref_g = _value_and_grads(warp_sample.sample_bilinear_reference,
                                    [t.clone().requires_grad_() for t in (image, px, py)],
                                    ref_cot)
        rel = {"fwd": _rel(got, ref)}
        rel.update({n: _rel(a, r) for n, a, r in zip(("dimg", "dpx", "dpy"), got_g, ref_g)})
        twin = warp_sample._backward_plain(image, px, py, cot, 1 if grad_first else 2)[0]
        same = torch.equal(got_g[0], twin)
        print(f"  sampler {'grad-first' if grad_first else 'full'}: max|d|/max|ref| "
              + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + " (limit 1e-5); "
              f"K3's dimg = the twin's bit for bit: {same}")
        if not all(v <= 1e-5 for v in rel.values()):
            raise AssertionError(f"sampler kernel mismatch: {rel}")
        if not same:
            raise AssertionError("K3's dimg differs from _backward_plain's bits")
        err["fwd"] = max(err["fwd"], rel["fwd"])
        err["abs_fwd"] = max(err["abs_fwd"], (got - ref).abs().max().item())
        err["bwd"] = max(err["bwd"], *(rel[k] for k in ("dimg", "dpx", "dpy")))
        err["abs_bwd"] = max(err["abs_bwd"], *((a - r).abs().max().item()
                                               for a, r in zip(got_g, ref_g)))
    return err


def sampler_phase(card: str, b: int = 16, h: int = 256, w: int = 320) -> dict:
    """``sampler_check`` at the train step's image (2B, H, W, 2) f32; then
    NaN coordinates, non-finite g, every query collapsed onto one texel
    (the fixed point's headroom), K3's device launches per backward and
    the share of its tiles summed in shared memory; then times at a smooth
    warp (a small motion, the train step's kind) beside the plain
    version's and the library's, and K3 at the random warp."""
    dev = torch.device("cuda")
    image, px, py, cot = _sampler_inputs(b, h, w)
    err = sampler_check(image, px, py, cot)

    nan_px, nan_py = px[:2, :8, :12].clone(), py[:2, :8, :12].clone()
    nan_px[0, 3, 4] = float("nan")
    nan_py[1, 5, 6] = float("nan")
    out = warp_sample.sample_bilinear(image[:2, :8, :12].contiguous(), nan_px, nan_py)
    nan = torch.isnan(out).any(-1).cpu()
    if not (nan[0, 3, 4] and nan[1, 5, 6] and int(nan.sum()) == 2):
        raise AssertionError("a NaN coordinate did not give exactly its NaN sample")
    print("  sampler NaN coordinates: NaN samples exactly there")

    # non-finite g: Inf on an integer coordinate (Inf * 0 = NaN in its
    # zero-weight taps), NaN, -Inf in channel 1, and a NaN coordinate
    nf = [t[:2, :40, :48].clone() for t in (image, px, py, cot)]
    nf[1][0, 2, 3], nf[2][0, 2, 3] = 4.0, 5.0
    nf[3][0, 2, 3, 0] = float("inf")
    nf[1][1, 4, 5], nf[2][1, 4, 5] = 10.5, 7.25
    nf[3][1, 4, 5, 0] = float("nan")
    nf[1][1, 7, 8], nf[2][1, 7, 8] = 20.75, 30.5
    nf[3][1, 7, 8, 1] = -float("inf")
    nf[1][1, 9, 10], nf[2][1, 9, 10] = float("nan"), 3.0
    for cg in (1, 2):
        got = warp_sample._backward(*nf, cg)[0]
        twin = warp_sample._backward_plain(*nf, cg)[0]
        bad = ~torch.isfinite(got)
        checks = {"bits": _same_bits(got, twin), "NaN": torch.equal(bad, torch.isnan(got)),
                  "channel 0": int(bad[..., 0].sum()) == 12,
                  "channel 1": int(bad[..., 1].sum()) == (0 if cg == 1 else 8)}
        if not all(checks.values()):
            raise AssertionError(f"K3 with non-finite g (CG = {cg}): {checks}")
    print(f"  K3 non-finite g and a NaN coordinate: dimg = the twin's bit for bit, NaN at "
          f"its {int(bad.sum())} non-finite texel channels (CG = 2)")

    # every query on one integer coordinate with g = +m (the largest float
    # below 1): texel (60, 100) of each image sums Q_b * m, the headroom's
    # limit at h = ceil(log2(Q_b))
    m = float(np.nextafter(np.float32(1), np.float32(0)))
    q = h * w
    collapse = torch.zeros(b, h, w, 2, device=dev)
    collapse[..., 0] = m
    got = warp_sample._backward(image, torch.full_like(px, 100.0), torch.full_like(py, 60.0),
                                collapse, 1)[0].double()
    want = torch.zeros_like(got)
    want[:, 60, 100, 0] = q * m
    tol = q * m * (2.0 ** -24 + 2.0 ** ((q - 1).bit_length() - 62))
    collapse_err = (got - want).abs().max().item()
    print(f"  K3 collapse: {b} x {q} queries onto one texel each, g = {m!r}: "
          f"max|d| {collapse_err:.3e} against the float64 sum {q * m!r} (limit {tol:.3e})")
    if not collapse_err <= tol:
        raise AssertionError("K3's fixed-point sum overflowed or lost its headroom")

    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    sx = (xx + 2 * torch.sin(yy / 17) + 0.3).expand(b, h, w).contiguous().to(dev)
    sy = (yy + 2 * torch.cos(xx / 23) - 0.2).expand(b, h, w).contiguous().to(dev)
    activities = _device_launches(lambda: warp_sample._backward(image, sx, sy, cot, 1))
    print(f"  K3 device launches per backward: {len(activities)} ("
          + ", ".join(f"{name} {us:.2f} us" for name, us in activities) + ")")
    if len(activities) > 4:
        raise AssertionError("K3 launches more than its memset and three kernels")
    tiles = b * -(-h // warp_sample.TILE[0]) * -(-w // warp_sample.TILE[1])
    share = {name: int(warp_sample._backward_cuda(image, x, y, cot, 1)[3]) / tiles
             for name, x, y in (("smooth", sx, sy), ("random", px, py))}
    print(f"  K3 tiles summed in shared memory: smooth warp {share['smooth']:.4f}, "
          f"random warp {share['random']:.4f} of {tiles}")
    if share["smooth"] != 1.0:
        raise AssertionError("a smooth warp's tile did not fit K3's window")

    # F.grid_sample (bilinear, zeros, align_corners) on the same image and
    # warp, NCHW with the grid normalized: pixel x = (gx + 1) / 2 * (W - 1)
    img = image.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([2 * sx / (w - 1) - 1, 2 * sy / (h - 1) - 1], -1)
    cot1 = cot[..., :1].contiguous()
    img1 = img[:, :1].contiguous()
    gout1 = cot1.permute(0, 3, 1, 2).contiguous()
    calls = {"fwd": lambda: warp_sample.sample_bilinear(image, sx, sy),
             # the train step's variant: channel 0 only
             "bwd": lambda: warp_sample._backward(image, sx, sy, cot, 1),
             "bwd_random": lambda: warp_sample._backward(image, px, py, cot, 1),
             "library_fwd": lambda: F.grid_sample(
                 img, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
             "library_bwd": lambda: torch.ops.aten.grid_sampler_2d_backward(
                 gout1, img1, grid, 0, 0, True, [True, True])}
    # through the wrappers (CUDA events over back-to-back calls), and the
    # device time alone (CUDA graph replay: no host work between launches)
    ms = {k: _cuda_ms(fn, 50) for k, fn in calls.items()}
    alone = {k: _graph_ms(fn) for k, fn in calls.items()}
    ms["plain_fwd"] = _cuda_ms(
        lambda: warp_sample.sample_bilinear_reference(image, sx, sy), 50)
    leaves = [image[..., :1].contiguous().requires_grad_(), sx.requires_grad_(),
              sy.requires_grad_()]
    ref = warp_sample.sample_bilinear_reference(*leaves)
    ms["plain_bwd"] = _cuda_ms(
        lambda: torch.autograd.grad(ref, leaves, cot1, retain_graph=True), 50)
    q = b * h * w  # queries; f32 bytes: image, px, py in, samples out
    bounds = {"fwd": bound(4 * q * (2 + 2 + 2), q * (8 * 2 + 10), torch.float32),
              # grad-first: image and g channel 0, px, py in; dimg (both
              # channels), dpx, dpy out
              "bwd": bound(4 * q * (1 + 2 + 1 + 2 + 2), q * 30, torch.float32)}
    print(f"timing [{card}] sampler at ({b}, {h}, {w}, 2) f32, smooth warp: "
          f"K2 {ms['fwd']:.4f} ms vs plain {ms['plain_fwd']:.4f} ms vs F.grid_sample "
          f"{ms['library_fwd']:.4f} ms (bound {bounds['fwd'][0]:.4f} ms); K3 "
          f"(grad-first) {ms['bwd']:.4f} ms (random warp {ms['bwd_random']:.4f}) vs plain "
          f"autograd {ms['plain_bwd']:.4f} ms vs aten.grid_sampler_2d_backward on channel 0 "
          f"{ms['library_bwd']:.4f} ms "
          f"(bound {bounds['bwd'][0]:.4f} ms)")
    print(f"timing [{card}] sampler device time alone (CUDA graph replay): K2 "
          f"{alone['fwd']:.4f} ms vs F.grid_sample {alone['library_fwd']:.4f} ms; K3 "
          f"(grad-first) {alone['bwd']:.4f} ms (random warp {alone['bwd_random']:.4f}) vs "
          f"aten.grid_sampler_2d_backward {alone['library_bwd']:.4f} ms")
    return {"err": err, "ms": ms, "bounds": bounds}


def _engine_bytes(kernel: str, pixels: int, c: int, f: int, itemsize: int) -> int:
    """Bytes one engine kernel must move for one layer: each input read
    once, each output written once (prefix c channels, growth f)."""
    s, weights = itemsize, 9 * c * f
    if kernel == "block_engine_fwd":  # prefix in; y and its two sums out
        return s * (pixels * (c + f) + weights) + 4 * (2 * c + f + 2 * f)
    if kernel == "block_engine_dinput":  # g and y of the layer, prefix and
        # its gradient in; the gradient prefix and three sums out
        return s * (pixels * (2 * f + 3 * c) + weights) + 4 * (4 * c + 3 * f)
    return s * pixels * (c + 2 * f) + 4 * (2 * c + 2 * f + weights)


ENGINE_KERNELS = ("block_engine_fwd", "block_engine_dinput", "block_engine_dweight")


def _engine_err(got, ref, dtype, max_abs=None, name=None) -> float:
    """The error measure of ``dtype``'s limit: f32 max|d|/max|ref|, bf16
    mean|d|/mean|ref|; ``name``: keep the f32 max|d| in ``max_abs[name]``
    as that kernel's max_abs_err (its tensor output)."""
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        err = (got - ref).abs().max().item()
        if name:
            max_abs[name] = max(max_abs[name], err)
        return err / ref.abs().max().item()
    return ((got - ref).abs().mean() / ref.abs().mean()).item()


def _engine_buffers(g, batch: int, h: int, w: int, c0: int) -> tuple:
    """A dense block's f32 buffer and gradient buffer (c0 + 4 x 12 channels)."""
    ld = c0 + 4 * 12
    return (torch.randn(batch, h, w, ld, generator=g, device="cuda"),
            torch.randn(batch, h, w, ld, generator=g, device="cuda"))


def _engine_layer_params(g, c: int, f: int) -> tuple:
    """One layer's BN fold (scale, shift), weights, bias and (C1, C2)."""
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    shift = torch.randn(c, generator=g, device="cuda") * 0.3
    wk = torch.randn(3, 3, c, f, generator=g, device="cuda") * (2.0 / (9 * c)) ** 0.5
    bias = torch.randn(f, generator=g, device="cuda") * 0.1
    c1 = torch.randn(f, generator=g, device="cuda") * 0.1
    c2 = torch.randn(f, generator=g, device="cuda") * 0.1
    return scale, shift, wk, bias, c1, c2


def _engine_layer_check(buf32, grad32, c: int, f: int, layer: tuple,
                        max_abs: dict) -> dict:
    """K4, K5 and K6 against their plain versions at one layer (prefix c,
    growth f), in f32 and bf16: y and its sums, the updated gradient prefix
    and the three BN/bias sums, and dW; each limit 1e-4. Returns the
    errors by dtype, (K4, K5, K6) each."""
    scale, shift, wk, bias, c1, c2 = layer
    names = ENGINE_KERNELS
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        buf, grad, w_t = buf32.to(dtype), grad32.to(dtype), wk.to(dtype)
        e = []
        got_b, ref_b = buf.clone(), buf.clone()
        got = block_engine.layer_forward(got_b, c, scale, shift, w_t, bias).sum(1)
        ref = block_engine.layer_forward_reference(ref_b, c, scale, shift, w_t, bias)
        e.append(max(_engine_err(got_b[..., c:c + f], ref_b[..., c:c + f], dtype,
                                 max_abs, names[0]), _engine_err(got, ref, dtype)))
        del got_b, ref_b
        # K5 adds into the random gradient prefix; in bf16 also into a zero
        # one, which compares the increment itself after rounding
        grads = [grad]
        if dtype == torch.bfloat16:
            grads.append(torch.cat([torch.zeros_like(grad[..., :c]), grad[..., c:]], -1))
        k5 = []
        for grad0 in grads:
            got_g, ref_g = grad0.clone(), grad0.clone()
            part, part_bias = block_engine.layer_dinput(got_g, buf, c, scale, shift, w_t,
                                                        c1, c2)
            got = (*part.sum(1), part_bias.sum(0))
            ref = block_engine.layer_dinput_reference(ref_g, buf, c, scale, shift, w_t,
                                                      c1, c2)
            k5 += [_engine_err(got_g[..., :c], ref_g[..., :c], dtype, max_abs, names[1])]
            k5 += [_engine_err(a, r, dtype) for a, r in zip(got, ref)]
            del got_g, ref_g
        e.append(max(k5))
        del grads
        got = block_engine.layer_dweight(grad, buf, c, f, scale, shift, c1, c2)
        ref = block_engine.layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)
        e.append(_engine_err(got, ref, dtype, max_abs, names[2]))
        errs[dtype] = e
    if not max(errs[torch.float32]) <= 1e-4 or not max(errs[torch.bfloat16]) <= 1e-4:
        raise AssertionError(f"engine kernel mismatch at {(buf32.shape, c)}: {errs}")
    return errs


def engine_kernel_check(batch: int, height: int = 256, width: int = 320) -> dict:
    """``_engine_layer_check`` at every layer of FCDenseNet-57's 11 dense
    blocks at ``batch``; returns each kernel's f32 max|d|."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    max_abs, max_f32, max_bf16 = dict.fromkeys(ENGINE_KERNELS, 0.0), 0.0, 0.0
    for h, w, c0 in dense_block_shapes(height, width):
        buf32, grad32 = _engine_buffers(g, batch, h, w, c0)
        for j in range(4):
            c, f = c0 + 12 * j, 12
            errs = _engine_layer_check(buf32, grad32, c, f, _engine_layer_params(g, c, f),
                                       max_abs)
            max_f32 = max(max_f32, *errs[torch.float32])
            max_bf16 = max(max_bf16, *errs[torch.bfloat16])
        del buf32, grad32
    print(f"  engine kernels at batch {batch}, {height}x{width}, 44 layers against their "
          f"plain versions: f32 max|d|/max|ref| {max_f32:.3e}, bf16 mean rel "
          f"{max_bf16:.3e} (limit 1e-4 each); f32 max|d| {max_abs}")
    return max_abs


def engine_kernel_phase(card: str, batch: int = 16, height: int = 256,
                        width: int = 320) -> dict:
    """K4, K5 and K6 against their plain versions at every layer of the 11
    dense blocks of FCDenseNet-57 at 2B = 16: f32 (TF32 off) max|d| <=
    1e-4 max|ref|, bf16 mean|d|/mean|ref| <= 1e-4 (kernel and plain version
    round the same bf16 operands alike, so only f32 sums in another order
    crossing a rounding edge move a stored value), for y and its sums, the
    updated gradient prefix and the three BN/bias sums, and dW. Then times
    in bf16 over the 44 layers beside the plain versions' and the nearest
    cuDNN call on the already activated tensor (conv2d; convolution_backward
    for the input only; for the weight only), which folds no BN or ReLU."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    names = ENGINE_KERNELS
    tot = {n: {"ms": 0.0, "alone_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "library_alone_ms": 0.0, "bytes": 0, "ops": 0} for n in names}
    max_abs, max_f32, max_bf16 = dict.fromkeys(names, 0.0), 0.0, 0.0
    levels = ("full resolution", "middle levels", "<= 32x40")
    by_level = {n: dict.fromkeys(levels, 0.0) for n in names}  # through the wrapper
    alone = {n: dict.fromkeys(levels, 0.0) for n in names}     # CUDA graph replay
    # K4 at the deep levels, its chunks split across ~FORWARD_BLOCKS blocks
    # against one pass, device ms by CUDA graph replay, two alternating
    # rounds (the wrapper splits below SPLIT_BELOW tiles)
    split_ablation = {hh: {"split": [0.0, 0.0], "one pass": [0.0, 0.0], "n_split": [],
                           "wrapper": []}
                      for hh in (height // 4, height // 8, height // 16, height // 32)}
    tile_ablation = {hh: {"chosen": [0.0, 0.0], "8x32": [0.0, 0.0]}
                     for hh in (height // 4, height // 8)}
    # bf16 K6 at a full-resolution and a deep level: the wrapper's n_split
    # (at most DWEIGHT_BLOCKS blocks) against half and twice as many splits,
    # device ms by CUDA graph replay, two alternating rounds
    dweight_ablation = {hh: {"n_split": [], **{k: [0.0, 0.0] for k in ("chosen", "half",
                                                                       "twice")}}
                        for hh in (height, height // 32)}
    print(f"engine kernel phase, batch {batch}, {height}x{width}, {card}:")
    print("  H    W    C    f32 max|d|/max|ref| (K4 K5 K6)  bf16 mean rel (K4 K5 K6)"
          "  bf16 ms kernel / plain / cuDNN (K4; K5; K6)")
    for h, w, c0 in dense_block_shapes(height, width):
        buf32, grad32 = _engine_buffers(g, batch, h, w, c0)
        for j in range(4):
            c, f = c0 + 12 * j, 12
            scale, shift, wk, bias, c1, c2 = layer = _engine_layer_params(g, c, f)
            errs = _engine_layer_check(buf32, grad32, c, f, layer, max_abs)
            max_f32 = max(max_f32, *errs[torch.float32])
            max_bf16 = max(max_bf16, *errs[torch.bfloat16])

            # bf16 timing, and the nearest cuDNN call on the activated tensor
            buf, grad, w_t = buf32.bfloat16(), grad32.bfloat16(), wk.bfloat16()
            a = torch.relu(buf32[..., :c] * scale + shift).bfloat16().permute(0, 3, 1, 2)
            gy = grad[..., c:c + f].contiguous().permute(0, 3, 1, 2)
            w_oihw = w_t.permute(3, 2, 0, 1).contiguous()
            b16 = bias.bfloat16()
            conv_bwd = torch.ops.aten.convolution_backward
            calls = {
                names[0]: (lambda: block_engine.layer_forward(buf, c, scale, shift, w_t, bias),
                           lambda: block_engine.layer_forward_reference(
                               buf, c, scale, shift, w_t, bias),
                           lambda: F.conv2d(a, w_oihw, b16, padding=1)),
                names[1]: (lambda: block_engine.layer_dinput(grad, buf, c, scale, shift,
                                                             w_t, c1, c2),
                           lambda: block_engine.layer_dinput_reference(
                               grad, buf, c, scale, shift, w_t, c1, c2),
                           lambda: conv_bwd(gy, a, w_oihw, None, [1, 1], [1, 1], [1, 1],
                                            False, [0, 0], 1, (True, False, False))),
                names[2]: (lambda: block_engine.layer_dweight(grad, buf, c, f, scale,
                                                              shift, c1, c2),
                           lambda: block_engine.layer_dweight_reference(
                               grad, buf, c, f, scale, shift, c1, c2),
                           lambda: conv_bwd(gy, a, w_oihw, None, [1, 1], [1, 1], [1, 1],
                                            False, [0, 0], 1, (False, True, False))),
            }
            level = ("full resolution" if h == height else "<= 32x40"
                     if h <= height // 8 else "middle levels")
            row = []
            for name, (kernel, plain, library) in calls.items():
                t = (_cuda_ms(kernel, 10), _cuda_ms(plain, 3, warmup=1),
                     _cuda_ms(library, 10))
                # the device times alone, no host work between launches
                kernel_alone, library_alone = _graph_ms(kernel), _graph_ms(library)
                for key, v in zip(("ms", "plain_ms", "library_ms", "alone_ms",
                                   "library_alone_ms"), t + (kernel_alone, library_alone)):
                    tot[name][key] += v
                tot[name]["bytes"] += _engine_bytes(name, batch * h * w, c, f, 2)
                tot[name]["ops"] += 2 * 9 * c * f * batch * h * w
                row.append(" / ".join(f"{v:.3f}" for v in t))
                by_level[name][level] += t[0]
                alone[name][level] += kernel_alone
            k4, k5 = calls[names[0]][0], calls[names[1]][0]
            if h in split_ablation:
                tiling = block_engine.forward_tiling
                tile = conv3x3_mma.mma_tile(h, w)
                n_part = conv3x3_mma.n_tiles(batch, h, w, *tile)
                n_split = min(-(-c // conv3x3_mma.CHUNK),
                              -(-conv3x3_mma.FORWARD_BLOCKS // n_part))
                split_ablation[h]["n_split"].append(n_split)
                split_ablation[h]["wrapper"].append(tiling(torch.bfloat16, batch, h, w, c)[2])
                for rep in range(2):
                    for key, n in (("split", n_split), ("one pass", 1)):
                        block_engine.forward_tiling = lambda *_, n=n: (*tile, n)
                        try:
                            split_ablation[h][key][rep] += _graph_ms(k4)
                        finally:
                            block_engine.forward_tiling = tiling
            if h in dweight_ablation:
                tiling = block_engine.dweight_tiling
                tile_h, tile_w, n_split = tiling(torch.bfloat16, batch, h, w, c)
                n_tiles = conv3x3_mma.n_tiles(batch, h, w, tile_h, tile_w)
                choices = {"chosen": n_split, "half": max(1, n_split // 2),
                           "twice": min(n_tiles, 2 * n_split)}
                dweight_ablation[h]["n_split"].append(n_split)
                for rep in range(2):
                    for key, n in choices.items():
                        block_engine.dweight_tiling = lambda *_, n=n: (tile_h, tile_w, n)
                        try:
                            dweight_ablation[h][key][rep] += _graph_ms(calls[names[2]][0])
                        finally:
                            block_engine.dweight_tiling = tiling
            # where the wrapper picks a narrow K5 tile, beside one 8x32 tile,
            # alternating twice
            if h in tile_ablation:
                tiling = block_engine.dinput_tiling
                for rep in range(2):
                    tile_ablation[h]["chosen"][rep] += _graph_ms(k5)
                    block_engine.dinput_tiling = lambda dtype, b, hh, ww, cc: (
                        8, 32, -(-cc // 32))
                    try:
                        tile_ablation[h]["8x32"][rep] += _graph_ms(k5)
                    finally:
                        block_engine.dinput_tiling = tiling
            print(f"  {h:<4} {w:<4} {c:<4} "
                  + " ".join(f"{v:.2e}" for v in errs[torch.float32]) + "   "
                  + " ".join(f"{v:.2e}" for v in errs[torch.bfloat16]) + "   "
                  + "; ".join(row))
            del buf, grad, a, gy
        del buf32, grad32
    result = {}
    for name in names:
        t = tot[name]
        bound_ms, bound_by = bound(t["bytes"], t["ops"], torch.bfloat16)
        result[name] = {"max_abs_err": max_abs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"timing [{card}] {name}, 44 layers, batch {batch} {height}x{width} bf16: "
              f"kernel {t['ms']:.4f} ms, {t['alone_ms']:.4f} alone; plain "
              f"{t['plain_ms']:.4f} ms; nearest cuDNN call on the activated tensor "
              f"{t['library_ms']:.4f} ms, {t['library_alone_ms']:.4f} alone; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {t['bytes'] / 1e9:.3f} GB, "
              f"{t['ops'] / 1e9:.1f} GFLOP)")
    for name in names:
        print(f"timing [{card}] {name} bf16 by level: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in by_level[name].items())
              + f" (total {sum(by_level[name].values()):.4f}); device alone (CUDA graph "
              "replay): " + ", ".join(f"{k} {v:.4f} ms" for k, v in alone[name].items())
              + f" (total {sum(alone[name].values()):.4f})")
    for hh, t in split_ablation.items():
        print(f"timing [{card}] block_engine_fwd bf16 device ms, the {len(t['n_split'])} "
              f"layers at {hh}x{hh * width // height} (CUDA graph replay, two alternating "
              f"rounds): split (n_split {t['n_split']}) "
              + " / ".join(f"{v:.4f}" for v in t["split"]) + ", one pass "
              + " / ".join(f"{v:.4f}" for v in t["one pass"])
              + f"; the wrapper's n_split {t['wrapper']}")
    for hh, t in dweight_ablation.items():
        print(f"timing [{card}] block_engine_dweight bf16 device ms, the "
              f"{len(t['n_split'])} layers at {hh}x{hh * width // height} (CUDA graph "
              f"replay, two alternating rounds): the wrapper's n_split {t['n_split']}, "
              "half and twice as many: " + "; ".join(
                  f"{k} " + " / ".join(f"{v:.4f}" for v in t[k])
                  for k in ("chosen", "half", "twice")))
    for hh, t in tile_ablation.items():
        tile = block_engine.dinput_tiling(torch.bfloat16, batch, hh, hh * width // height, 48)
        print(f"timing [{card}] block_engine_dinput bf16 device ms, the 8 layers at "
              f"{hh}x{hh * width // height} (CUDA graph replay, two alternating rounds): "
              f"the wrapper's {tile[0]}x{tile[1]} tile "
              + " / ".join(f"{v:.4f}" for v in t["chosen"]) + ", one 8x32 tile "
              + " / ".join(f"{v:.4f}" for v in t["8x32"]))
    print(f"engine kernel phase ok: 11 blocks, 44 layers, f32 max|d|/max|ref| "
          f"{max_f32:.3e} <= 1e-4, bf16 mean rel {max_bf16:.3e} <= 1e-4")
    return result


# the blocks whose boundary ``boundary_phase`` takes: (C0, ld) of
# FC-DenseNet-103's and FCDenseNet-57's last up block, the largest prefixes
BOUNDARY_CASES = {"fcdensenet103_up5": (192, 256), "fcdensenet57_up5": (144, 192)}


def boundary_phase(card: str, batch: int = 16, height: int = 256, width: int = 320) -> dict:
    """The block's boundary kernels in bf16 at ``BOUNDARY_CASES``: the
    entry's copy bitwise x and its moments within 2e-6 (relative) of x's f64
    mean and mean of squares; dx bitwise ``block_exit_reference``'s; both
    bitwise on a repeat. Then each kernel's device time alone (CUDA graph
    replay) beside its plain version's, the PyTorch chain it replaced, and
    its bytes bound: the entry reads x and writes the prefix (4 bytes an
    element), the exit reads g and x and writes dx (6)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    results = {}
    for name, (c0, ld) in BOUNDARY_CASES.items():
        shape = (batch, height, width)
        x = (torch.randn(*shape, c0, generator=g, device="cuda") + 1).bfloat16()
        buf = torch.randn(*shape, ld, generator=g, device="cuda").bfloat16()
        grad = torch.randn(*shape, ld, generator=g, device="cuda").bfloat16()
        c1, c2 = (torch.randn(ld, generator=g, device="cuda") * 0.1 for _ in range(2))
        stats = block_engine.block_entry(x, buf)
        again = block_engine.block_entry(x, buf.clone())
        x64 = x.double()
        want = torch.stack([x64.mean((0, 1, 2)), x64.square().mean((0, 1, 2))])
        moments = float(((stats.double() - want).abs() / want.abs()).max())
        dx = block_engine.block_exit(grad, buf, c1, c2, c0)
        checks = {"copy": torch.equal(buf[..., :c0], x), "moments_rel": moments,
                  "dx_bitwise": torch.equal(dx, block_engine.block_exit_reference(
                      grad, buf, c1, c2, c0)),
                  "repeats_bitwise": torch.equal(stats, again) and torch.equal(
                      dx, block_engine.block_exit(grad, buf, c1, c2, c0))}
        del x64, want, dx
        elements = batch * height * width * c0
        ms = {"entry": _graph_ms(lambda: block_engine.block_entry(x, buf)),
              "entry_plain": _graph_ms(lambda: block_engine.block_entry_reference(x, buf)),
              "exit": _graph_ms(lambda: block_engine.block_exit(grad, buf, c1, c2, c0)),
              "exit_plain": _graph_ms(lambda: block_engine.block_exit_reference(
                  grad, buf, c1, c2, c0))}
        bound = {"entry": 4 * elements / HBM_BYTES_PER_S * 1e3,
                 "exit": 6 * elements / HBM_BYTES_PER_S * 1e3}
        results[name] = {**checks, **{f"{k}_ms": round(v, 4) for k, v in ms.items()},
                         **{f"{k}_bound_ms": round(v, 4) for k, v in bound.items()},
                         **{f"{k}_hbm_pct": round(100 * bound[k] / ms[k], 2) for k in bound}}
        print(f"  {name} (C0 {c0}, ld {ld}): {json.dumps(results[name])} ({card})")
        if not (checks["copy"] and checks["dx_bitwise"] and checks["repeats_bitwise"]
                and moments <= 2e-6):
            raise AssertionError(f"the boundary kernels failed their checks at {name}")
        del x, buf, grad
    return results


def _sum_err(got, ref, part, dim) -> float:
    """The largest difference of two f32 sums of the same partials in two
    orders, as a share of the partials' absolute sum."""
    return float(((got - ref).abs() / part.abs().sum(dim)).max())


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _glue_block_checks(mu, m2, c1, c2, c0, f, n, params, pairs, fresh) -> list:
    """A block's once-a-block glue launches against their twins, bitwise,
    on clones: the forward's first call (the entry's moments into mu, m2
    and layer 0's fold and kernel cast), the backward's start (C1, C2 and
    the top layer's fold and cast) and the running statistics of every
    layer (``pairs``). Returns the names of those that differ."""
    failed = []
    for kernel, plain, name in (
            (block_engine.glue_forward, block_engine.glue_forward_reference, "forward start"),
            (block_engine.glue_backward_start, block_engine.glue_backward_start_reference,
             "backward start"),
            (block_engine.running_stats, block_engine.running_stats_reference,
             "running statistics")):
        runs = []
        for glue in (kernel, plain):
            if name == "forward start":
                state = [mu.clone(), m2.clone()]
                runs.append(state + list(glue(*state, 0, torch.stack([mu[:c0], m2[:c0]]), n,
                                              block_engine.FINISH, params[0], fresh())))
            elif name == "backward start":
                state = [c1.clone(), c2.clone()]
                runs.append(state + list(glue(mu, m2, *state, mu, m2, n, params[-1], fresh())))
            else:
                state = [(a.clone(), b.clone()) for a, b in pairs]
                glue(state, mu, m2, c0, f, 0.9)
                runs.append([t for pair in state for t in pair])
        if not _same(*runs):
            failed.append(name)
    return failed


def _glue_layer_checks(mu, m2, c1, c2, c, f, n, part, stats, gamma, nxt, prev,
                       fresh) -> tuple:
    """One dense layer's glue (prefix c, growth f) against its twins, on
    clones: the forward after K4 (``part``, K4's partials) and the backward
    after K5 (``stats``, K5's partials). Returns the failed checks' names
    and the sums' largest error as a share of their partials' absolute
    sum. The sums (the statistics, dbeta, the bias gradient, the (sum
    dpre*x, sum dpre)) may differ from the twins' in their order; what is
    computed from them (the next layer's fold and kernel cast, dgamma, the
    (C1, C2) updates) must be bitwise the twins' given the kernel's sums,
    and a REDUCE-alone call's sums bitwise the one-call's."""
    reduce, finish = block_engine.REDUCE, block_engine.FINISH
    failed = []
    mu_k, m2_k = mu.clone(), m2.clone()
    folded = block_engine.glue_forward(mu_k, m2_k, c, part, n, reduce | finish, nxt, fresh())
    mu_t, m2_t = mu.clone(), m2.clone()
    block_engine.glue_forward_reference(mu_t, m2_t, c, part, n, reduce | finish, None, None)
    err = max(_sum_err(mu_k[c:c + f] * n, mu_t[c:c + f] * n, part[0], 0),
              _sum_err(m2_k[c:c + f] * n, m2_t[c:c + f] * n, part[1], 0))
    moments = block_engine.glue_forward(mu.clone(), m2.clone(), c, part, n, reduce, None,
                                        fresh())
    if not (torch.equal(mu_k[:c], mu[:c]) and torch.equal(mu_k[c + f:], mu[c + f:])
            and torch.equal(m2_k[:c], m2[:c]) and torch.equal(m2_k[c + f:], m2[c + f:])):
        failed.append("forward: channels outside the layer's moved")
    if not torch.equal(moments, torch.stack([mu_k[c:c + f], m2_k[c:c + f]])):
        failed.append("forward: REDUCE alone differs from the one call")
    if nxt is not None and not _same(folded, block_engine._fold_next(mu_k, m2_k, nxt, fresh())):
        failed.append("forward: the next layer's fold or kernel cast")

    grads = [torch.empty(k, device=mu.device) for k in (c, c, f)]
    c1_k, c2_k = c1.clone(), c2.clone()
    folded = block_engine.glue_backward(mu, m2, c1_k, c2_k, c, stats, n, reduce | finish,
                                        gamma, grads, prev, fresh())
    alone = [torch.empty(k, device=mu.device) for k in (c, c, f)]
    sums = block_engine.glue_backward(mu, m2, c1.clone(), c2.clone(), c, stats, n, reduce,
                                      gamma, alone, None, fresh())
    err = max(err, _sum_err(sums, stats[0].sum(1), stats[0], 1),
              _sum_err(grads[2], stats[1].sum(0), stats[1], 0))
    if not (_same(alone, grads) and torch.equal(sums[1], grads[1])):
        failed.append("backward: REDUCE alone differs from the one call")
    inv = torch.rsqrt(m2[:c] - mu[:c].square() + block_engine.EPS)
    if not torch.equal(grads[0], inv * (sums[0] - mu[:c] * sums[1])):
        failed.append("backward: dgamma")
    c1_t, c2_t = c1.clone(), c2.clone()
    twin = block_engine.glue_backward_reference(mu, m2, c1_t, c2_t, c, sums, n, finish, gamma,
                                                None, prev, fresh())
    if not _same((c1_t, c2_t), (c1_k, c2_k)):
        failed.append("backward: the (C1, C2) update")
    if prev is not None and not _same(folded, twin):
        failed.append("backward: the previous layer's fold or kernel cast")
    return failed, err


def glue_phase(card: str, batch: int = 16, height: int = 256, width: int = 320) -> dict:
    """The engine's glue kernels in bf16 over every dense block of
    FC-DenseNet-103 and FCDenseNet-57 at 2B = 16 256x320, on random partials
    of K4's and K5's shapes. First each launch against its plain twin (the
    PyTorch expressions it replaced) on cloned inputs: every layer's glue in
    both directions as ``_glue_layer_checks`` holds it (its sums within
    1e-5 of the partials' absolute sum, the rest bitwise), each block's
    first forward call, backward start and running statistics bitwise.
    Raises on any mismatch. Then one train step's glue launches (each
    direction once a block and once a layer, the running statistics once a
    block): their device time alone (CUDA graph replay of each launch,
    summed) beside the twins', and the bytes bound: every partial, vector
    and kernel element read once and every output written once."""
    reduce_finish, finish = block_engine.REDUCE | block_engine.FINISH, block_engine.FINISH
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    dev = dict(device="cuda")
    results = {}
    for net, kwargs in (("fcdensenet103", dict(down=(4, 5, 7, 10, 12), up=(12, 10, 7, 5, 4),
                                               bottleneck=15, growth=16)),
                        ("fcdensenet57", {})):
        sizes = (*kwargs.get("down", (4,) * 5), kwargs.get("bottleneck", 4),
                 *kwargs.get("up", (4,) * 5))
        layers, f = dense_layer_shapes(height, width, **kwargs), kwargs.get("growth", 12)
        ms, launches, n_bytes = {"glue": 0.0, "glue_plain": 0.0}, 0, 0
        failed, sums_err, checked = [], 0.0, 0
        for first, n_layers in zip(np.cumsum((0,) + sizes[:-1]), sizes):
            h, w, c0 = layers[first]
            n, ctot = batch * h * w, c0 + n_layers * f
            mu = torch.randn(ctot, generator=g, **dev) * 0.5
            m2 = mu.square() + 1
            params = [(torch.rand(c0 + j * f, generator=g, **dev) + 0.5,
                       torch.randn(c0 + j * f, generator=g, **dev) * 0.1,
                       torch.randn(f, c0 + j * f, 3, 3, generator=g, **dev).permute(2, 3, 1, 0))
                      for j in range(n_layers)]
            c1, c2 = (torch.randn(ctot, generator=g, **dev) * 0.1 for _ in range(2))
            out = block_engine.GlueBuffers.empty(ctot - f, f, torch.bfloat16, "cuda")
            pairs = [(torch.randn(c0 + j * f, generator=g, **dev),
                      torch.rand(c0 + j * f, generator=g, **dev) + 0.5)
                     for j in range(n_layers)]

            def fresh():
                return block_engine.GlueBuffers.empty(ctot - f, f, torch.bfloat16, "cuda")

            failed += [f"the block at layer {first}: {what}"
                       for what in _glue_block_checks(mu, m2, c1, c2, c0, f, n, params, pairs,
                                                      fresh)]
            checked += 3

            def fold_bytes(c):  # gamma, beta, the f32 kernel in; scale, shift, bf16 kernel out
                return 16 * c + 9 * c * f * 6

            calls = [((block_engine.glue_forward, block_engine.glue_forward_reference),
                      (mu, m2, 0, torch.stack([mu[:c0], m2[:c0]]), n, finish, params[0], out),
                      16 * c0 + fold_bytes(c0)),
                     ((block_engine.glue_backward_start,
                       block_engine.glue_backward_start_reference),
                      (mu, m2, c1, c2, mu, m2, n, params[-1], out),
                      24 * ctot + fold_bytes(ctot - f)),
                     ((block_engine.running_stats, block_engine.running_stats_reference),
                      (pairs, mu, m2, c0, f, 0.9), sum(24 * p[0].numel() for p in pairs))]
            for j in range(n_layers):
                c = c0 + j * f
                tile = block_engine.forward_tiling(torch.bfloat16, batch, h, w, c)[:2]
                part = torch.randn(2, block_engine._n_part(batch, h, w, *tile), f,
                                   generator=g, **dev).abs()
                nxt = params[j + 1] if j + 1 < n_layers else None
                calls.append(((block_engine.glue_forward, block_engine.glue_forward_reference),
                              (mu, m2, c, part, n, reduce_finish, nxt, out),
                              4 * part.numel() + 16 * c + (fold_bytes(c + f) if nxt else 0)))
                tile = block_engine.dinput_tiling(torch.bfloat16, batch, h, w, c)[:2]
                n_part = block_engine._n_part(batch, h, w, *tile)
                stats = (torch.randn(2, n_part, c, generator=g, **dev),
                         torch.randn(n_part, f, generator=g, **dev))
                grads = [torch.empty(k, **dev) for k in (c, c, f)]
                prev = params[j - 1] if j > 0 else None
                bad, err = _glue_layer_checks(mu, m2, c1, c2, c, f, n, part, stats,
                                              params[j][0], nxt, prev, fresh)
                failed += [f"layer {first + j}: {what}" for what in bad]
                sums_err, checked = max(sums_err, err), checked + 2
                calls.append(((block_engine.glue_backward, block_engine.glue_backward_reference),
                              (mu, m2, c1, c2, c, stats, n, reduce_finish, params[j][0], grads,
                               prev, out),
                              4 * (stats[0].numel() + stats[1].numel()) + 36 * c + 4 * f
                              + (fold_bytes(c - f) if prev else 0)))
            for (kernel, plain), args, moved in calls:
                ms["glue"] += _graph_ms(lambda: kernel(*args))
                ms["glue_plain"] += _graph_ms(lambda: plain(*args))
                launches += 1
                n_bytes += moved
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        results[net] = {"checked": checked, "failed": failed, "sums_err": sums_err,
                        "launches": launches, **{f"{k}_ms": round(v, 4) for k, v in ms.items()},
                        "bound_ms": round(bound, 4), "bytes": n_bytes,
                        "hbm_pct": round(100 * bound / ms["glue"], 2)}
        print(f"  glue a {net} step, bf16 b{batch // 2} pairs {height}x{width}: "
              f"{json.dumps(results[net])} ({card})")
        if failed or not sums_err <= 1e-5:
            raise AssertionError(f"the glue kernels failed their checks in {net}: {failed[:8]}, "
                                 f"sums {sums_err:.3e} of their partials' absolute sum "
                                 f"(limit 1e-5)")
    return results


def optimizer_phase(card: str) -> dict:
    """The multi-tensor optimizer (``ops/sgd_update``: one C call, three
    launches) on the gradients of one bf16 train step (b2 128x160) of
    FC-DenseNet-103 and of FCDenseNet-57, in the layouts the step gives
    them, scaled to global norm 3 and 30 (both sides of the clip at 10):
    the norm against the plain loop's (rtol 1e-6), momentum and
    parameters bit for bit unclipped and within 1e-6 of their largest
    clipped, count and step exact, no gradient copied; then its time
    through the wrapper (events) and alone (CUDA graph replay) beside the
    plain loop's and the bytes bound: 24 bytes an element (the norm reads
    g; the step reads p, b and g and writes p and b)."""
    results = {}
    for name, build in (("fcdensenet103", FCDenseNet103), ("fcdensenet57", FCDenseNet57)):
        model = conditioned(init_weights(build(dtype=torch.bfloat16),
                                         torch.Generator().manual_seed(SEED))).cuda()
        state = training.create_train_state(model)
        config = training.TrainConfig(compute_dtype=torch.bfloat16)
        captured, update, restrided = [], sgd_update.update, sgd_update.RESTRIDED
        sgd_update.update = lambda *args: captured.append(args[2]) or update(*args)
        try:
            training.train_step(state, synthetic_batch(2, 128, 160, SEED + 4, "cuda"),
                                torch.tensor(0.1, device="cuda"), config)
        finally:
            sgd_update.update = update
        params = [p.detach() for p in state.params]
        elements = sum(p.numel() for p in params)
        permuted = sum(sgd_update._layout(tuple(p.shape), p.stride(), g.stride())
                       not in (None, sgd_update._COPY)
                       for p, g in zip(params, captured[0]) if p.stride() != g.stride())
        norm0 = float(sgd_update.global_norm(captured[0]))
        scalars = (torch.tensor(1.0, device="cuda"), torch.tensor(3e-3, device="cuda"))
        for norm in (3.0, 30.0):
            grads = [g * (norm / norm0) for g in captured[0]]  # keeps each layout
            got = ([p.clone() for p in params], [b.clone() for b in state.momentum],
                   state.count.clone(), state.step.clone())
            want = ([p.clone() for p in params], [b.clone() for b in state.momentum],
                    state.count.clone(), state.step.clone())
            _, got_norm = sgd_update.update(got[0], got[1], grads, *scalars, got[2], got[3],
                                            10.0, 0.9)
            _, want_norm = sgd_update._sgd_update_plain(want[0], want[1], grads, *scalars,
                                                        want[2], want[3], 10.0, 0.9)
            rel = abs(float(got_norm) - float(want_norm)) / float(want_norm)
            worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(got[0] + got[1], want[0] + want[1]))
            print(f"  {name}, norm {norm:g}: kernel's global norm {float(got_norm):.9g} / "
                  f"plain {float(want_norm):.9g} (rel {rel:.3e}, limit 1e-6); momentum "
                  f"and parameters max|d|/max|ref| {worst:.3e} (limit 0 unclipped, 1e-6 "
                  f"clipped); count {int(got[2])} / {int(want[2])}, step {int(got[3])} / "
                  f"{int(want[3])}")
            if not (rel <= 1e-6 and worst <= (0.0 if norm < 10 else 1e-6)
                    and int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])):
                raise AssertionError(f"sgd_update disagrees with its plain loop ({name})")
        if sgd_update.RESTRIDED != restrided:
            raise AssertionError(f"{name}'s step copied a gradient into its parameter's layout")
        work = ([p.clone() for p in params], [b.clone() for b in state.momentum],
                grads, *scalars, state.count.clone(), state.step.clone(), 10.0, 0.9)
        ms = {"wrapper": _cuda_ms(lambda: sgd_update.update(*work), iters=20),
              "alone": _graph_ms(lambda: sgd_update.update(*work)),
              "plain": _cuda_ms(lambda: sgd_update._sgd_update_plain(*work), iters=3,
                                warmup=1),
              "bound": 24 * elements / HBM_BYTES_PER_S * 1e3}
        results[name] = {"tensors": len(params), "elements": elements,
                         "gradients_read_through_strides": permuted,
                         **{k: round(v, 4) for k, v in ms.items()}}
        print(f"  {name}: {json.dumps(results[name])} ({card})")
        del model, state, captured, work, grads, got, want
    return results


def synthetic_batch(batch: int, height: int, width: int, seed: int,
                    device) -> dict:
    """A geometrically consistent batch, built as tests/test_training.py
    builds it: a depth plane at 1 inside a boundary mask, a pure 0.02
    forward motion, sparse depth and flow exact from that geometry, and
    random colors."""
    rng = np.random.RandomState(seed)
    b, h, w = batch, height, width
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 80.0 * w / 64
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = w / 2, h / 2, 1.0
    rot = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    t12 = np.zeros((b, 3, 1), np.float32)
    t12[:, 2, 0] = 0.02
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, h // 8:-h // 8, w // 8:-w // 8] = 1.0
    sparse = np.zeros((b, h, w, 1), np.float32)
    sparse[:, h // 5:-h // 5:4, w // 5:-w // 5:4] = 1.0
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    z2 = 1.0 - 0.02
    flow = np.stack([(xs - w / 2) / z2 + w / 2 - xs, (ys - h / 2) / z2 + h / 2 - ys], -1)
    flow = (flow / np.array([w, h], np.float32))[None].repeat(b, 0).astype(np.float32)
    arrays = {
        "color_1": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "color_2": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
        "sparse_depth_1": sparse, "sparse_depth_2": sparse,
        "depth_mask_1": sparse, "depth_mask_2": sparse,
        "flow_1": flow * sparse, "flow_2": -flow * sparse,
        "flow_mask_1": sparse, "flow_mask_2": sparse, "boundary": mask,
        "rotation_1_wrt_2": rot, "rotation_2_wrt_1": rot,
        "translation_1_wrt_2": t12, "translation_2_wrt_1": -t12,
        "intrinsic": k,
    }
    return {key: torch.from_numpy(v).to(device) for key, v in arrays.items()}


def conditioned(model: torch.nn.Module) -> torch.nn.Module:
    """Scale the head by 0.1 and add 3 to its bias, so the depth is
    |3 + 0.1 * conv|. At a raw random init some depths sit near the |.|
    kink and the 1/z pole of the objective, which then amplifies f32
    order noise ~1000x (PERF.md "Objective conditioning"): a comparison
    of two implementations of one step, and a loss that should fall over
    a few steps, need a well-conditioned start."""
    with torch.no_grad():
        model.finalConv.weight.mul_(0.1)
        model.finalConv.bias.mul_(0.1).add_(3.0)
    return model


def _rel_scalar(a: torch.Tensor, b: torch.Tensor) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def train_parity_phase(config) -> None:
    """(a) One f32 step (TF32 off) on the card against the same step on the
    CPU, at b2 128x160 from the same conditioned weights (the kernels on
    the card, their plain versions on the CPU)."""
    base = conditioned(seeded_model(SEED))
    results = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device)
        state = training.create_train_state(model)
        batch = synthetic_batch(2, 128, 160, SEED + 4, device)
        t0 = time.perf_counter()
        state, metrics = training.train_step(
            state, batch, torch.tensor(0.1, device=device), config)
        stats = {k: v.cpu() for k, v in state.model.state_dict().items()
                 if "running" in k}
        results[device] = ({k: v.cpu() for k, v in metrics.items()}, stats)
        print(f"  f32 step on {device}: loss {float(metrics['loss']):.6f} in "
              f"{time.perf_counter() - t0:.1f} s")
    (m_cpu, s_cpu), (m_gpu, s_gpu) = results["cpu"], results["cuda"]
    rel = {k: _rel_scalar(m_gpu[k], m_cpu[k]) for k in
           ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm")}
    stat_err = max(_rel(s_gpu[k], s_cpu[k]) for k in s_cpu)
    print("  card vs CPU, f32 step b2 128x160: rel " +
          ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) +
          f" (limit 1e-3); BN statistics max|d|/max|ref| {stat_err:.3e} (limit 1e-4)")
    if not (all(v <= 1e-3 for v in rel.values()) and stat_err <= 1e-4):
        raise AssertionError("the card's f32 train step disagrees with the CPU's")


def _launch_counts() -> dict:
    return {"dense_conv_fwd": dense_conv.LAUNCHES, **warp_sample.LAUNCHES,
            **block_engine.LAUNCHES}


def _reset_launch_counts() -> None:
    dense_conv.LAUNCHES = 0
    warp_sample.LAUNCHES.update(dict.fromkeys(warp_sample.LAUNCHES, 0))
    block_engine.LAUNCHES.update(dict.fromkeys(block_engine.LAUNCHES, 0))


def train_phase(card: str, config, steps: int = 10, batch: int = 8,
                height: int = 256, width: int = 320) -> dict:
    """(b) ``steps`` bf16 train steps on one fixed batch, counted and timed;
    (c) one step with an empty depth mask. From the conditioned weights:
    at 256x320 the raw random init puts some depths on the objective's
    1/z pole, and even in f32 its loss then jumps from step to step with
    gradient norms of 1e4-1e7 (measured on the card). Every dense layer
    runs K4, K5 and K6 once per step and K1 never."""
    dev = torch.device("cuda")
    state = training.create_train_state(
        conditioned(seeded_model(SEED, torch.bfloat16)).to(dev))
    data = synthetic_batch(batch, height, width, SEED + 5, dev)
    dcl = torch.tensor(0.1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    _reset_launch_counts()
    events[0].record()
    for i in range(steps):
        state, metrics = training.train_step(state, data, dcl, config)
        events[i + 1].record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = _launch_counts()
    losses = torch.stack(losses).cpu()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    steady = sorted(step_ms[2:])[len(step_ms[2:]) // 2]  # median after 2 warm-ups
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {"dense_conv_fwd": 0, "warp_sample_fwd": steps, "warp_sample_bwd": steps,
                **engine_launches(steps, steps)}
    print(f"train phase: {steps} bf16 steps, b{batch} {height}x{width}: losses "
          + " ".join(f"{v:.5f}" for v in losses.tolist()))
    print(f"  launches: {launches} (expected {expected})")
    print(f"timing [{card}] train step bf16 b{batch} {height}x{width}: "
          f"{steady:.4f} ms median of steps 3-{steps} ({batch * 1000 / steady:.2f} "
          f"samples/s); steps ms {[round(t, 3) for t in step_ms]}; "
          f"peak memory {peak:.2f} GiB")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and decreasing: {losses.tolist()}")
    if int(state.step) != steps or int(state.count) != steps:
        raise AssertionError(f"step {int(state.step)}, count {int(state.count)}")
    if launches != expected:
        raise AssertionError(f"unexpected launch counts {launches}")

    bad = dict(data)
    bad["depth_mask_1"] = torch.zeros_like(data["depth_mask_1"])
    bad["sparse_depth_1"] = torch.zeros_like(data["sparse_depth_1"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    momentum = [b.clone() for b in state.momentum]
    state, metrics = training.train_step(state, bad, dcl, config)
    after = state.model.state_dict()
    kept = all(torch.equal(after[k], v) for k, v in before.items() if "running" not in k)
    moved = all(not torch.equal(after[k], v) for k, v in before.items() if "running" in k)
    kept_momentum = all(torch.equal(a, b) for a, b in zip(state.momentum, momentum))
    print(f"  empty depth mask: loss {float(metrics['loss'])}, params and momentum "
          f"kept {kept and kept_momentum}, step {int(state.step)}, count "
          f"{int(state.count)}, BN statistics advanced {moved}")
    if torch.isfinite(metrics["loss"]) or not (kept and kept_momentum and moved) or (
            int(state.step), int(state.count)) != (steps, steps):
        raise AssertionError("the non-finite guard failed")
    return {"launches": launches, "ms": steady, "state": state, "data": data}


class _EagerSteps(step_graph.CudaGraphs):
    """The card's capture backend, engaging nowhere: every train step runs
    eagerly, as before ``step_graph``. For comparison only."""

    def engages(self, device) -> bool:
        return False


def graph_phase(card: str, steps: int = 20, batch: int = 8, height: int = 256,
                width: int = 320) -> dict:
    """``steps`` eager and ``steps`` graphed FC-DenseNet-103 bf16 train steps
    on one batch (``step_graph``), each run from the same weights after two
    warm-up steps (eager: two eager steps; graphed: the eager step and the
    capture): ms a step by CUDA events over the ``steps`` back to back, so
    the host's launch time counts as in training, and the allocator's peak
    over each run above what was allocated before it. The two states after
    their runs are bitwise equal."""
    dev = torch.device("cuda")
    config = training.TrainConfig(lr_step_size=50, compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(SEED)
    start = conditioned(init_weights(FCDenseNet103(dtype=torch.bfloat16), g))
    data = synthetic_batch(batch, height, width, SEED + 5, dev)
    dcl = torch.tensor(0.1, device=dev)
    out, states = {}, {}
    backend = step_graph.BACKEND
    for label, steps_backend in (("eager", _EagerSteps()), ("graphed", backend)):
        state = training.create_train_state(copy.deepcopy(start).to(dev))
        step_graph.BACKEND = steps_backend
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for _ in range(2):
                training.train_step(state, data, dcl, config)
            torch.cuda.synchronize()
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            graphed = dict(step_graph.GRAPHED)
            begin.record()
            for _ in range(steps):
                _, metrics = training.train_step(state, data, dcl, config)
            end.record()
            torch.cuda.synchronize()
        finally:
            step_graph.BACKEND = backend
        ms = begin.elapsed_time(end) / steps
        moved = {k: v - graphed[k] for k, v in step_graph.GRAPHED.items()}
        out[label] = {"ms": ms, "samples_per_s": batch * 1000 / ms,
                      "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                      "loss": float(metrics["loss"]), "graphed": moved}
        states[label] = state
    same = all(torch.equal(a, b) for a, b in zip(
        [*states["eager"].model.state_dict().values(), *states["eager"].momentum],
        [*states["graphed"].model.state_dict().values(), *states["graphed"].momentum]))
    static = sum(v.nbytes for v in data.values())
    print(f"timing [{card}] graph phase, FC-DenseNet-103 bf16 b{batch} {height}x{width}, "
          f"{steps} steps each: eager {out['eager']['ms']:.4f} ms a step "
          f"({out['eager']['samples_per_s']:.2f} samples/s), graphed "
          f"{out['graphed']['ms']:.4f} ms ({out['graphed']['samples_per_s']:.2f} "
          f"samples/s), x{out['eager']['ms'] / out['graphed']['ms']:.3f}; peak above the "
          f"state: eager {out['eager']['peak_gib']:.4f} GiB, graphed "
          f"{out['graphed']['peak_gib']:.4f} GiB (static inputs {static / 2 ** 30:.4f}); "
          f"states bitwise equal {same}; {json.dumps(out)}")
    if out["eager"]["graphed"] != {"eager": steps, "captures": 0, "replays": 0} or out[
            "graphed"]["graphed"] != {"eager": 0, "captures": 0, "replays": steps}:
        raise AssertionError(f"the runs took other paths: {out}")
    if not same:
        raise AssertionError("graphed FC-DenseNet-103 steps differ from eager ones")
    return out


def _profile_tables(prof, n: int, card: str, label: str) -> tuple:
    """Print a torch.profiler window's device ms per iteration (of ``n``)
    by op and by kernel function; return (device busy ms, kernel launches)
    per iteration."""
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in ops if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / (1e3 * n)
    launches = sum(e.count for e in kernels) / n
    print(f"profile [{card}] {label}device ms per iteration by op:")
    for e in sorted((e for e in ops if e not in kernels),
                    key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / (1e3 * n):9.3f}  x{e.count // n:<5} {e.key[:80]}")
    by_function = {}  # kernel function (template arguments dropped) -> [us, count]
    for e in kernels:
        name = re.split(r"[<(]", e.key.replace("(anonymous namespace)::", ""))[0]
        total = by_function.setdefault(name, [0.0, 0])
        total[0] += e.self_device_time_total
        total[1] += e.count
    print(f"profile [{card}] {label}device ms per iteration by kernel function:")
    for name, (us, count) in sorted(by_function.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / (1e3 * n):9.3f}  x{count // n:<5} {name[:100]}")
    return busy, launches


def profile_train_step(state, data, config, card: str, steady_ms: float) -> None:
    """torch.profiler over 3 bf16 train steps after the timed ones: the
    device time per step by op and by kernel, and the device's idle share
    of the window (the profiler's own host cost included) and of
    ``steady_ms``, the same run's median step without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    dcl = torch.tensor(0.1, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(3):
            training.train_step(state, data, dcl, config)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / 3
    busy, _ = _profile_tables(prof, 3, card, "bf16 train step b8 256x320, ")
    print(f"profile [{card}] bf16 train step b8 256x320, 3 steps: window "
          f"{window:.3f} ms/step, device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / window:.4f} under the profiler, {1 - busy / steady_ms:.4f} "
          f"of the unprofiled median step {steady_ms:.4f} ms")


def profile_forward(checkpoint, card: str, height: int = 256, width: int = 320,
                    batch: int = 1, n: int = 5) -> None:
    """torch.profiler over ``n`` bf16 forwards (``predict_step``) after
    three warm-ups, on a ``DepthPredictor`` built with its default device
    (the card): device busy and idle share per forward, kernel launches
    per forward (K1's among them), the host's enqueue time per forward,
    and the device time by op and by kernel function."""
    from torch.profiler import ProfilerActivity, profile
    predictor = DepthPredictor(checkpoint, synthetic_sequence(height, width),
                               batch_size=batch, downsampling=1.0)
    if predictor.device.type != "cuda":
        raise AssertionError(f"DepthPredictor's default device is {predictor.device}")
    g = torch.Generator().manual_seed(SEED + 2)
    colors = (torch.rand(batch, height, width, 3, generator=g) * 2 - 1).cuda()
    boundary = torch.ones(batch, height, width, 1, device="cuda")

    def forward():
        return training.predict_step(predictor.model, colors, boundary)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        forward()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    k1 = dense_conv.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            forward()
        end.record()
        torch.cuda.synchronize()
    k1 = (dense_conv.LAUNCHES - k1) / n
    window = start.elapsed_time(end) / n
    label = f"bf16 forward b{batch} {height}x{width}, "
    busy, launches = _profile_tables(prof, n, card, label)
    print(f"profile [{card}] {label}{n} forwards: window {window:.4f} ms/forward, device "
          f"busy {busy:.4f} ms, idle share {1 - busy / window:.4f}; {launches:.0f} kernel "
          f"launches per forward ({k1:.0f} K1); host enqueue {host_ms:.4f} ms per forward "
          "without the profiler")
    if k1 != 44:
        raise AssertionError(f"expected 44 K1 launches per forward, got {k1}")


def export_phase(checkpoint, card: str, tmp: Path, python_b1_ms: float) -> dict:
    """The deployment artifacts on the card, bf16 at 256x320: the
    ``torch.export`` artifact of a b8 predictor loaded by ``load_exported``
    against ``predict_batch`` (mean|d|/mean|ref| in the mask <= 1e-4: it
    replays the same aten ops and K1) with 44 K1 launches a forward and its
    ms; the op library and the libtorch host built in parallel; the b1
    AOTInductor bundle (the live-feed shape) with its compile seconds; the
    host's timed run (``--warmup 5 --iters 50``, CUDA events on its stream)
    and its output against the eager predictor (<= 1e-2 in the mask:
    Inductor's fused glue rounds bf16 elsewhere), then ``--stream`` over 24
    frames against the eager ``stream``. The host's K1 count must be 44 a
    forward. Returns K1's launches: the artifact's in this process plus the
    host's."""
    height, width = 256, 320
    sequence = synthetic_sequence(height, width)
    with ThreadPoolExecutor(2) as pool:
        t_build = time.perf_counter()
        builds = [pool.submit(_libtorch_build.op_library), pool.submit(build_native_host)]

        b8 = DepthPredictor(checkpoint, sequence, batch_size=8, downsampling=1.0,
                            device="cuda", dtype=torch.bfloat16)
        frames = synthetic_frames(24, height, width, seed=SEED + 4)
        colors8 = np.stack([b8.prepare(f) for f in frames[:8]])
        t0 = time.perf_counter()
        b8.export(tmp / "b8.pt2")
        export_s = time.perf_counter() - t0
        fn = load_exported(tmp / "b8.pt2")
        k1 = dense_conv.LAUNCHES
        exported = fn(colors8)[..., 0].cpu().numpy()
        if dense_conv.LAUNCHES - k1 != 44:
            raise AssertionError(f"the loaded artifact launched K1 "
                                 f"{dense_conv.LAUNCHES - k1} times, not 44")
        eager = b8.predict_batch(colors8)
        rel_exported = masked_rel_err(exported, eager, height, width)
        same = bool(np.array_equal(exported, eager))
        print(f"export phase: torch.export of the b8 bf16 predictor in {export_s:.1f} s; "
              f"loaded artifact vs predict_batch: mean|d|/mean|ref| in the mask "
              f"{rel_exported:.3e} (limit 1e-4), max|d| {np.abs(exported - eager).max():.3e}, "
              f"bitwise equal {same}; 44 K1 launches a forward")
        if not (np.isfinite(exported).all() and rel_exported <= 1e-4):
            raise AssertionError("the exported artifact disagrees with predict_batch")
        x8 = torch.from_numpy(colors8).cuda()
        artifact_ms = _cuda_ms(lambda: fn(x8), 10)
        op_library, host = [b.result() for b in builds]
        build_s = time.perf_counter() - t_build
    print(f"export phase: built the op library ({op_library.name}, g++ and nvcc) and the "
          f"host ({host.name}, g++) in {build_s:.1f} s, in parallel with the b8 export")
    del b8, fn, x8

    b1 = DepthPredictor(checkpoint, sequence, batch_size=1, downsampling=1.0,
                        device="cuda", dtype=torch.bfloat16)
    bundle = tmp / "bundle_b1"
    t0 = time.perf_counter()
    b1.export_native_bundle(bundle)
    compile_s = time.perf_counter() - t0
    print(f"export phase: AOTInductor bundle of the b1 256x320 bf16 predictor in "
          f"{compile_s:.1f} s (trace and compile); meta: "
          + ", ".join((bundle / "meta.txt").read_text().split()))

    colors1 = np.stack([b1.prepare(f) for f in frames])
    (tmp / "in.bin").write_bytes(colors1[:1].tobytes())
    warmup, iters = 5, 50
    out = subprocess.run([str(host), "--bundle", str(bundle), "--warmup", str(warmup),
                          "--iters", str(iters), "--input", str(tmp / "in.bin"),
                          "--output", str(tmp / "out.bin")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"serve_host failed ({out.returncode}):\n{out.stderr}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"export phase: serve_host {json.dumps(report)}")
    hosted = np.fromfile(tmp / "out.bin", np.float32).reshape(1, height, width)
    eager1 = b1.predict_batch(colors1[:1])
    rel_host = masked_rel_err(hosted, eager1, height, width)
    ref = cpu_reference(checkpoint, height, width, colors1[:1])
    print(f"export phase: b1 against the CPU float32 forward, mean|d|/mean|ref| in the "
          f"mask: serve_host {masked_rel_err(hosted, ref, height, width):.3e}, eager bf16 "
          f"{masked_rel_err(eager1, ref, height, width):.3e}")
    if report["k1_launches"] != 44 * (warmup + iters):
        raise AssertionError(f"serve_host launched K1 {report['k1_launches']} times, "
                             f"not {44 * (warmup + iters)}")
    if not (np.isfinite(hosted).all() and rel_host <= 1e-2):
        raise AssertionError(f"serve_host disagrees with the eager predictor: {rel_host}")

    out = subprocess.run([str(host), "--bundle", str(bundle), "--stream"],
                         input=colors1.tobytes(), capture_output=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"serve_host --stream failed ({out.returncode}):\n"
                             f"{out.stderr.decode()}")
    stats = json.loads(out.stderr.decode().strip().splitlines()[-1])
    streamed = np.frombuffer(out.stdout, np.float32).reshape(len(frames), height, width)
    want = np.stack([d for _, d in b1.stream(frames)])
    rel_stream = masked_rel_err(streamed, want, height, width)
    print(f"export phase: serve_host --stream {json.dumps(stats)}; vs the eager stream "
          f"mean|d|/mean|ref| in the mask {rel_stream:.3e} (limit 1e-2)")
    if stats["batches"] != len(frames) or stats["k1_launches"] != 44 * len(frames):
        raise AssertionError(f"serve_host --stream: {stats}")
    if not (np.isfinite(streamed).all() and rel_stream <= 1e-2):
        raise AssertionError("serve_host --stream disagrees with the eager stream")
    print(f"timing [{card}] serving export, bf16 256x320: serve_host b1 "
          f"{report['value']:.4f} ms/batch (CUDA events, {iters} iterations) against the "
          f"Python predictor's forward_ms b1 {python_b1_ms:.4f}; loaded torch.export "
          f"artifact b8 {artifact_ms:.4f} ms (CUDA events); serve_host --stream "
          f"{stats['ms_per_batch']:.4f} ms a frame (host clock, pipes and read back "
          f"included; {stats['ms_per_batch_after_first']:.4f} after the first frame's "
          f"{stats['first_batch_ms']:.4f}); "
          f"host vs eager b1 mean|d|/mean|ref| in the mask {rel_host:.3e} (limit 1e-2)")
    return {"launches": report["k1_launches"] + stats["k1_launches"]}


TRAINER_FRAMES, TRAINER_RAW = 15, (1024, 1280)  # per sequence; two sequences


def _trainer_argv(data: Path, out: Path, *extra) -> list:
    """The trainer at b8 bf16 on the card: 48 samples an epoch (6 steps),
    epochs 0 and 1, a board every 2 steps, every step's metrics read
    back, the precompute's pickle loaded."""
    return ["--adjacent_range", "2", "6", "--id_range", "1", "2",
            "--input_size", "256", "320", "--batch_size", "8", "--num_iter", "48",
            "--number_epoch", "1", "--display_interval", "2", "--log_interval", "1",
            "--validation_interval", "1", "--num_workers", "8",
            "--training_patient_id", "1", "--testing_patient_id", "1",
            "--validation_patient_id", "1", "--load_intermediate_data",
            "--training_data_root", str(data), "--training_result_root", str(out),
            "--device", "cuda", *extra]


def _trainer_expected(train_steps: int, evals: int) -> dict:
    """The kernel launches of a trainer run: each train step K2, K3, 44
    of K4, K5 and K6 and 11 block entries and exits; each validation batch
    (the train-mode forward with the batch statistics) K2, 44 of K4 and 11
    entries; no K1."""
    return {"dense_conv_fwd": 0, "warp_sample_fwd": train_steps + evals,
            "warp_sample_bwd": train_steps, **engine_launches(train_steps + evals, train_steps)}


def _check_checkpoint(path: Path, model: torch.nn.Module = None) -> dict:
    """Load ``path`` back into a fresh ``model`` (by default a bf16
    FCDenseNet-57) on the card; the model, the momentum, ``count`` and
    ``step`` must equal the file's."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model = FCDenseNet57(dtype=torch.bfloat16) if model is None else model
    state = training.create_train_state(model.cuda())
    state, epoch, _ = ckpt.load_checkpoint(path, state)
    same = (int(state.step) == raw["step"]
            and int(state.count) == raw["optimizer"]["param_groups"][0]["count"]
            and all(torch.equal(b.cpu(), raw["optimizer"]["state"][i]["momentum_buffer"])
                    for i, b in enumerate(state.momentum))
            and all(torch.equal(v.cpu(), raw["model"][f"module.{k}"])
                    for k, v in state.model.state_dict().items()))
    if not same:
        raise AssertionError(f"{path.name} does not load back")
    return {"epoch": epoch, "step": raw["step"],
            "count": raw["optimizer"]["param_groups"][0]["count"]}


def _board_ms(state, host_batch: dict, out: Path) -> dict:
    """The host cost of one training board at the trainer's batch: its
    readback and drawing (``train._board``) and its PNG write
    (``MetricWriter.add_image``), each the median of 3, on the metrics of
    one ``eval_step`` with images."""
    from endoscopydepthestimation_pytorch_tpu_torch.parallel import to_device
    from endoscopydepthestimation_pytorch_tpu_torch.utils.visualization import MetricWriter
    device = state.step.device
    batch = to_device(host_batch, device)
    config = training.TrainConfig(compute_dtype=state.model.dtype)
    metrics = training.eval_step(state, batch, torch.tensor(0.1, device=device), config,
                                 with_images=True, use_batch_stats=True)
    torch.cuda.synchronize()
    writer = MetricWriter(out)
    times = {"board": [], "png": []}
    for i in range(3):
        t0 = time.perf_counter()
        board = trainer._board(batch, metrics, False)
        t1 = time.perf_counter()
        writer.add_image("Training/Images/Results", board, i)
        times["board"].append((t1 - t0) * 1e3)
        times["png"].append((time.perf_counter() - t1) * 1e3)
    writer.close()
    return {"board": float(np.median(times["board"])),
            "png": float(np.median(times["png"])), "shape": "x".join(map(str, board.shape))}


def trainer_phase(card: str, synthetic_step_ms: float, tmp: Path) -> dict:
    """(12) The trainer, ``train.main``, on a synthetic SfM data root
    of two sequences of TRAINER_FRAMES raw 1024x1280 frames (3000 points
    each; a 256x320 crop at ``--input_downsampling 4``): the precompute
    (two spawned workers), the native rasterizer against its numpy version
    at that size, the loader alone, then the trainer at b8 bf16 for epochs
    0 and 1 (6 steps each, validation, a checkpoint each) from its own init
    with the head ``conditioned`` (``--load_trained_model``: epoch 0, zero
    momentum), and a resume from the epoch-0 checkpoint for epoch 1 under
    ``--profile_dir``. From the raw init, weight noise of 1e-7 moves the
    first loss by 9-23%, so the checkpoints that (13) and (16b) compare
    card against CPU in f32 would ride on a chaotic trajectory. Each run's
    launches are counted from 0 and must be the trainer's; every loss is
    finite and every checkpoint loads back with its momentum, count and
    step."""
    data = tmp / "data"
    t0 = time.perf_counter()
    for segment in (1, 2):
        write_sequence(data, seed=SEED + 20 + segment, n_frames=TRAINER_FRAMES,
                       height=TRAINER_RAW[0], width=TRAINER_RAW[1], n_points=3000,
                       segment=segment, first_frame=100 * segment)
    written = time.perf_counter() - t0
    folders = readers.get_parent_folder_names(data, [1, 2])
    t0 = time.perf_counter()
    sequences = preprocess.load_or_run_precompute(
        data, folders, 4.0, 64, False, 0.99, 30, "train", use_store_data=False,
        num_workers=8)
    precompute_s = time.perf_counter() - t0
    print(f"trainer phase [{card}]: wrote 2 sequences of {TRAINER_FRAMES} frames "
          f"{TRAINER_RAW[0]}x{TRAINER_RAW[1]} in {written:.1f} s; precompute "
          f"{precompute_s:.2f} s (2 spawned workers)")
    for seq in sequences.values():
        clean = float(seq.clean_point_list.mean())
        if seq.mask_boundary.shape != (TRAINER_RAW[0] // 4, TRAINER_RAW[1] // 4) or clean < 0.9:
            raise AssertionError(f"crop {seq.mask_boundary.shape}, clean {clean}")

    seq = next(iter(sequences.values()))
    pair = dict(pair_extrinsics=[seq.extrinsics[0], seq.extrinsics[5]],
                pair_projections=[seq.projections[0], seq.projections[5]],
                pair_indexes=[seq.visible_view_indexes[0], seq.visible_view_indexes[5]],
                point_cloud=seq.point_cloud, mask_boundary=seq.mask_boundary,
                view_indexes_per_point=seq.view_indexes_per_point,
                clean_point_list=seq.clean_point_list,
                visible_view_indexes=seq.visible_view_indexes)
    times, outs = {}, {}
    for name, fn in (("numpy", rasterizer.rasterize_pair),
                     ("native", native.rasterize_pair_native)):
        fn(**pair)  # warm-up (and the build, where build_phase has not run)
        t0 = time.perf_counter()
        for _ in range(20):
            outs[name] = fn(**pair)
        times[name] = (time.perf_counter() - t0) * 1e3 / 20
    if not all(np.array_equal(a, b) for a, b in zip(outs["numpy"], outs["native"])):
        raise AssertionError("the native rasterizer disagrees with rasterize_pair")
    print(f"  host rasterizer at 256x320, 3000 points, bit for bit equal: native "
          f"{times['native']:.3f} ms, numpy {times['numpy']:.3f} ms a pair [host CPU]")

    files, _, _ = readers.get_color_file_names_by_bag(data, 1, 1, 1)
    train_set = dataset.SfMDataset(
        image_file_names=files, folder_list=folders, adjacent_range=[2, 6],
        transform=augment.TrainingAugmentation(seed=trainer.SEED),
        use_store_data=True, store_data_root=data, phase="train", num_iter=48)
    loader = dataset.BatchLoader(train_set, 8, shuffle=True, num_workers=8)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    print(f"  loader alone: {len(batches)} batches of 8 at 256x320 in "
          f"{loader_ms:.2f} ms a batch, 8 threads [host CPU of the {card} machine]")

    # the trainer's own init with the head conditioned, at epoch 0, step 0
    # and zero momentum, as the benchmark's trainer cell starts
    start = tmp / "conditioned_start.pt"
    ckpt.save_checkpoint(start, training.create_train_state(conditioned(init_weights(
        FCDenseNet57(), torch.Generator().manual_seed(trainer.SEED)))), 0, 0.0)
    runs = {}
    for label, extra, steps in (
            ("first", ("--load_trained_model", "--trained_model_path", str(start)), 12),
            ("resumed", ("--load_trained_model", "--profile_dir", str(tmp / "profile"),
                         "--trained_model_path"), 6)):
        if label == "resumed":
            extra = extra + (str(runs["first"]["run"].checkpoints[0]),)
        evals = 3 * (2 if label == "first" else 1)  # 30 frames: 3 batches of 8
        _reset_launch_counts()
        rasterized = native.LAUNCHES
        run = trainer.main(_trainer_argv(data, tmp / label, *extra))
        torch.cuda.synchronize()
        launches = _launch_counts()
        rasterized = native.LAUNCHES - rasterized
        expected = _trainer_expected(steps, evals)
        print(f"  {label} run [{card}]: launches {launches} (expected {expected}); "
              f"native rasterizer {rasterized}")
        if launches != expected:
            raise AssertionError(f"unexpected launch counts {launches}")
        if len(run.losses) != steps or not np.isfinite(run.losses).all():
            raise AssertionError(f"losses {run.losses}")
        if rasterized < 8 * steps:
            raise AssertionError(f"{rasterized} native rasterizations")
        loaded = [_check_checkpoint(p) for p in run.checkpoints]
        print(f"  {label} run: losses {[round(v, 5) for v in run.losses]}; "
              f"checkpoints load back {loaded}")
        runs[label] = {"run": run, "launches": launches, "loaded": loaded}

    first, resumed = runs["first"]["run"], runs["resumed"]["run"]
    if (runs["resumed"]["loaded"][-1]["step"], runs["resumed"]["loaded"][-1]["count"]) != (
            runs["first"]["loaded"][-1]["step"], runs["first"]["loaded"][-1]["count"]) \
            or int(resumed.state.step) != 12:
        raise AssertionError("the resume did not carry step and count over")
    want = torch.load(first.checkpoints[1], map_location="cpu", weights_only=True)
    got = torch.load(resumed.checkpoints[0], map_location="cpu", weights_only=True)
    drift = max(_rel(got["model"][k].float(), v.float()) for k, v in want["model"].items()
                if v.is_floating_point() and v.abs().max() > 0)
    print(f"  resumed epoch 1 against the first run's epoch 1: step "
          f"{got['step']} / {want['step']}, count "
          f"{got['optimizer']['param_groups'][0]['count']} / "
          f"{want['optimizer']['param_groups'][0]['count']}, weights max|d|/max|ref| "
          f"{drift:.3e}")

    board_ms = _board_ms(resumed.state, batches[0], tmp / "board")
    median = float(np.median(first.step_ms))
    profile = resumed.profile
    print(f"timing [{card}] trainer step bf16 b8 256x320: median {median:.4f} ms "
          f"({8000 / median:.2f} samples/s) of {len(first.step_ms)} steps after 2 "
          f"warm-up steps (board every 2 steps); steps ms "
          f"{[round(t, 3) for t in first.step_ms]}")
    print(f"timing [{card}] trainer step against the synthetic-batch train step "
          f"{synthetic_step_ms:.4f} ms: {median - synthetic_step_ms:+.4f} ms "
          f"({median / synthetic_step_ms:.3f}x)")
    # the timer's interval ending at an even step holds that step's board
    boarded, plain = first.step_ms[0::2], first.step_ms[1::2]
    print(f"timing [{card}] trainer steps with a board: median "
          f"{np.median(boarded):.4f} ms; without: median {np.median(plain):.4f} ms "
          f"({8000 / np.median(plain):.2f} samples/s); one b8 board alone (median of "
          f"3): {board_ms['board']:.3f} ms to read back and draw, "
          f"{board_ms['png']:.3f} ms to write its {board_ms['shape']} PNG [host CPU]")
    print(f"profile [{card}] trainer epoch 1 after the resume, 6 steps: window "
          f"{profile['window_ms'] / 6:.3f} ms/step, device busy "
          f"{profile['device_busy_ms'] / 6:.3f} ms/step, idle share "
          f"{profile['idle_share']:.4f}")
    launches = {k: runs["first"]["launches"][k] + runs["resumed"]["launches"][k]
                for k in runs["first"]["launches"]}
    return {"launches": launches, "median_ms": median, "loader_ms": loader_ms,
            "precompute_s": precompute_s, "idle_share": profile["idle_share"],
            "data": data, "checkpoint": first.checkpoints[1],
            "checkpoints": first.checkpoints}


EVAL_BATCH = 8
EVAL_FRAMES = ["100", "101", "102", "103"]  # the test phase's frames (sequence 1)


def _evaluate_argv(data: Path, checkpoint: Path, out: Path, phase: str, *extra) -> list:
    """The evaluate CLI on sequence 1 of the trainer phase's data root (15
    frames), at b8 256x320, with the precompute's pickle loaded."""
    folder = sorted(readers.get_parent_folder_names(data, [1, 2]))[0]
    return ["--adjacent_range", "2", "6", "--id_range", "1", "2",
            "--input_size", "256", "320", "--batch_size", str(EVAL_BATCH),
            "--num_workers", "8", "--testing_patient_id", "1", "--load_intermediate_data",
            "--trained_model_path", str(checkpoint), "--sequence_root", str(folder),
            "--evaluation_result_root", str(out), "--evaluation_data_root", str(data),
            "--phase", phase, *extra]


def _check_clouds(paths) -> int:
    """Each PLY parses back with points whose z is finite and >= 0; returns
    the number of points."""
    n = 0
    for path in paths:
        z = plyio.read_ply_vertices(path)["z"]
        if z.size == 0 or not (np.isfinite(z).all() and (z >= 0).all()):
            raise AssertionError(f"{path.name}: {z.size} points, z in "
                                 f"[{z.min() if z.size else None}, {z.max() if z.size else None}]")
        n += z.size
    return n


def evaluate_phase(card: str, data: Path, checkpoint: Path, tmp: Path) -> dict:
    """(13) The evaluate CLI, ``evaluate.main``, on the trainer phase's
    epoch-1 checkpoint and data root, FCDenseNet-57 at 256x320: first the
    f32 validation phase on 4 frame pairs (one batch of 4) on the card
    against ``--device cpu`` (TF32 off; ``metrics.json`` at rtol 1e-3);
    then, counted and timed, the validation phase over sequence 1's 15
    frames at b8 (a batch of 8 and a ragged one of 7, padded) and the test
    phase on 4 frames, each in f32 (the default) and bf16. Every board,
    cloud and frame image must exist, the metrics be finite and each PLY
    parse back with finite z >= 0. Launches per run: validation 44 K1 a
    batch (one forward over the stacked pairs) and one K2 (the depth
    warp); test 44 K1 a frame; never K3-K6."""
    folders = readers.get_parent_folder_names(data, [1, 2])
    preprocess.load_or_run_precompute(data, folders, 4.0, 64, False, 0.995, 30,
                                      "validation", use_store_data=True, num_workers=8)
    pairs = ["--selected_frame_index_list", "100", "103", "106", "109"]
    got = {}
    for device in ("cuda", "cpu"):
        argv = _evaluate_argv(data, checkpoint, tmp / f"parity_{device}", "validation",
                              *pairs, "--device", device)
        argv[argv.index("--batch_size") + 1] = "4"
        t0 = time.perf_counter()
        run = evaluate.main(argv)
        torch.cuda.synchronize()
        got[device] = json.loads((run.log_root / "metrics.json").read_text())
        print(f"  f32 validation of 4 pairs on {device}: {got[device]} in "
              f"{time.perf_counter() - t0:.1f} s")
    rel = {k: abs(got["cuda"][k] - v) / max(abs(v), 1e-12) for k, v in got["cpu"].items()}
    print(f"  card vs CPU, metrics.json rel {rel} (limit 1e-3)")
    if not all(np.isfinite(list(got["cuda"].values()))) or max(rel.values()) > 1e-3:
        raise AssertionError("the card's f32 evaluation disagrees with the CPU's")

    n_batches = -(-TRAINER_FRAMES // EVAL_BATCH)
    launches, ms = dict.fromkeys(_launch_counts(), 0), {}
    for phase, frames, extra in (
            ("validation", TRAINER_FRAMES, ("--load_all_frames",)),
            ("test", len(EVAL_FRAMES), ("--selected_frame_index_list", *EVAL_FRAMES))):
        for dtype in ("float32", "bfloat16"):
            argv = _evaluate_argv(data, checkpoint, tmp / f"eval_{phase}_{dtype}", phase,
                                  *extra, "--compute_dtype", dtype)
            _reset_launch_counts()
            t0 = time.perf_counter()
            run = evaluate.main(argv)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counted = _launch_counts()
            root = run.log_root
            # validation: the loop's time over its frames (2 batches);
            # test: the median frame after the first
            per_frame = (sum(run.ms) / frames if phase == "validation"
                         else float(np.median(run.ms[1:])))
            ms[f"{phase}_{dtype}"] = (per_frame, wall - sum(run.ms), run.ms)
            expected = dict.fromkeys(counted, 0)
            if phase == "validation":
                expected.update(dense_conv_fwd=44 * n_batches, warp_sample_fwd=n_batches)
                names = [str(b) for b in range(n_batches)]
                metrics = json.loads((root / "metrics.json").read_text())
                if sorted(metrics) != ["abs_rel", "sigma_1.25", "sigma_1.25^2",
                                       "sigma_1.25^3"] \
                        or not np.isfinite(list(metrics.values())).all():
                    raise AssertionError(f"metrics {metrics}")
            else:
                expected.update(dense_conv_fwd=44 * frames)
                names = [f"{int(f):08d}" for f in EVAL_FRAMES]
                metrics = {}
            missing = [f"{n}.{ext}" for n in names for ext in ("png", "ply")
                       if not (root / f"{n}.{ext}").exists()]
            if missing:
                raise AssertionError(f"{phase} {dtype}: missing {missing}")
            points = _check_clouds(root / f"{n}.ply" for n in names)
            print(f"  {phase} {dtype}: {frames} frames, launches {counted} (expected "
                  f"{expected}); {len(names)} PNG + PLY, {points} points; {metrics}")
            if counted != expected:
                raise AssertionError(f"unexpected launch counts {counted}")
            for k, n in counted.items():
                launches[k] += n
    # the forwards alone, on the same checkpoint: CUDA events over 10 calls
    forwards = {}
    batch = synthetic_batch(EVAL_BATCH, 256, 320, SEED + 7, "cuda")
    for dtype in (torch.float32, torch.bfloat16):
        model = FCDenseNet57(dtype=dtype)
        ckpt.load_any_checkpoint(checkpoint, model)
        state = training.create_train_state(model.cuda().eval())
        config = training.TrainConfig(compute_dtype=dtype)
        dcl = torch.tensor(config.dcl_weight, device="cuda")
        forwards[dtype] = (
            _cuda_ms(lambda: training.predict_step(state.model, batch["color_1"][:1],
                                                   batch["boundary"][:1]), 10),
            _cuda_ms(lambda: training.eval_step(state, batch, dcl, config,
                                                with_images=True), 10))
    print(f"timing [{card}] evaluate forwards alone (CUDA events, 10 calls): test "
          f"predict_step b1 256x320 f32 {forwards[torch.float32][0]:.4f} ms, bf16 "
          f"{forwards[torch.bfloat16][0]:.4f} ms; validation eval_step with images "
          f"b{EVAL_BATCH} 256x320 f32 {forwards[torch.float32][1]:.4f} ms, bf16 "
          f"{forwards[torch.bfloat16][1]:.4f} ms")

    # what the host spends writing one output, on the files just written
    writes = {}
    for kind, name in (("test", f"{int(EVAL_FRAMES[0]):08d}"), ("validation", "0")):
        root = next((tmp / f"eval_{kind}_float32").iterdir())
        cloud = plyio.read_ply_vertices(root / f"{name}.ply")
        cloud = np.stack([cloud[k].astype(np.float32) for k in cloud.dtype.names], 1)
        image = cv2.imread(str(root / f"{name}.png"))
        times = {"ply": [], "png": []}
        for _ in range(3):
            t0 = time.perf_counter()
            plyio.write_point_cloud(tmp / "rewrite.ply", cloud)
            t1 = time.perf_counter()
            cv2.imwrite(str(tmp / "rewrite.png"), image)
            times["ply"].append((t1 - t0) * 1e3)
            times["png"].append((time.perf_counter() - t1) * 1e3)
        writes[kind] = (len(cloud), float(np.median(times["ply"])), image.shape,
                        float(np.median(times["png"])))
    print(f"  host writes, median of 3 [host CPU of the {card} machine]: "
          + "; ".join(f"{kind}: a PLY of {n} points (ASCII) {ply:.3f} ms, a "
                      f"{'x'.join(map(str, shape))} PNG {png:.3f} ms"
                      for kind, (n, ply, shape, png) in writes.items()))
    for key, (per_frame, setup, each) in ms.items():
        phase, dtype = key.split("_")
        what = ("the loop over 2 batches (8 + 7 pairs) over its frames: data, "
                "forward, board, PLY" if phase == "validation" else
                "the median frame after the first: data, forward, PNG, PLY")
        print(f"timing [{card}] evaluate {phase} {dtype} b"
              f"{EVAL_BATCH if phase == 'validation' else 1} 256x320: {per_frame:.3f} ms "
              f"a frame ({what}); set-up before the loop {setup:.1f} ms (model load, "
              f"dataset with the precompute's pickle); each "
              f"{'batch' if phase == 'validation' else 'frame'} ms "
              f"{[round(t, 3) for t in each]}")
    return {"launches": launches, "ms": ms, "writes": writes}


def conditioned_unet(model: torch.nn.Module) -> torch.nn.Module:
    """The UNet's head scaled by 0.1 with 3 added to its bias (see
    ``conditioned``)."""
    with torch.no_grad():
        model.last.weight.mul_(0.1)
        model.last.bias.mul_(0.1).add_(3.0)
    return model


def unet_parity_phase() -> None:
    """(14a) The default UNet (depth 6, wf 6) at full width: one f32 step
    on the card against the CPU at b2 128x160 from the same conditioned
    weights (TF32 off); on the card K2 and K3 once each and no other
    kernel."""
    base = conditioned_unet(init_weights(UNet(), torch.Generator().manual_seed(SEED)))
    config = training.TrainConfig(lr_step_size=50)
    results = {}
    for device in ("cpu", "cuda"):
        state = training.create_train_state(copy.deepcopy(base).to(device))
        batch = synthetic_batch(2, 128, 160, SEED + 6, device)
        _reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = training.train_step(
            state, batch, torch.tensor(0.1, device=device), config)
        launches = _launch_counts()
        results[device] = ({k: v.cpu() for k, v in metrics.items()},
                           [b.cpu() for b in state.momentum])
        print(f"  UNet f32 step on {device}: loss {float(metrics['loss']):.6f} in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    (m_cpu, b_cpu), (m_gpu, b_gpu) = results["cpu"], results["cuda"]
    expected = dict.fromkeys(launches, 0)
    expected.update(warp_sample_fwd=1, warp_sample_bwd=1)
    rel = {k: _rel_scalar(m_gpu[k], m_cpu[k]) for k in
           ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm")}
    # each parameter's momentum after the first step is its clipped
    # gradient; the new parameters themselves are not compared: lr x grad
    # is near the f32 spacing of many weights, so p - lr*b rounds either way.
    # Held over all parameters, and per tensor against the largest gradient
    # entry of any. The deep levels' gradients (up to 3e-5, against 0.03
    # elsewhere) cancel: the CPU's own f32 step differs from its float64
    # step by 2.75e-3 over all parameters and by 1.24e-2 in
    # up4_block.conv1.weight on its own scale, the tensor that leads
    # between card and CPU too; so 1e-2 over all
    names = [n for n, _ in base.named_parameters()]
    grad_err = (torch.cat([(g - c).flatten() for g, c in zip(b_gpu, b_cpu)]).norm()
                / torch.cat([c.flatten() for c in b_cpu]).norm()).item()
    top = max(c.abs().max() for c in b_cpu)
    tensor_err = max(((g - c).abs().max() / top).item() for g, c in zip(b_gpu, b_cpu))
    own = sorted(((_rel(g, c), n, c.abs().max().item()) for g, c, n in
                  zip(b_gpu, b_cpu, names)), reverse=True)[:3]
    print("  UNet card vs CPU, f32 step b2 128x160: rel " +
          ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) +
          f" (limit 1e-3); the momentum (the clipped gradient) over all "
          f"{len(names)} parameters |d|/|ref| {grad_err:.3e} (limit 1e-2), per tensor "
          f"max|d| / the largest entry of any {tensor_err:.3e} (limit 1e-3); on their "
          f"own scale the worst: " + ", ".join(f"{n} {e:.3e} (max|ref| {m:.3e})"
                                                for e, n, m in own))
    if launches != expected:
        raise AssertionError(f"unexpected UNet step launches {launches}")
    if not (all(v <= 1e-3 for v in rel.values()) and grad_err <= 1e-2
            and tensor_err <= 1e-3):
        raise AssertionError("the card's f32 UNet step disagrees with the CPU's")


def unet_trainer_phase(card: str, data: Path, tmp: Path) -> dict:
    """(14b) The trainer, ``train.main --architecture unet`` (the default
    UNet), at b8 256x320 bf16 for one epoch of 12 steps and its
    validation, on the trainer phase's data root: K2 and K3 every step, K2
    every validation batch, no K1 or K4-K6, finite losses, and a
    checkpoint that loads back. The run resumes from a conditioned
    checkpoint (``--load_trained_model``, epoch 0, zero momentum): the
    UNet's head has no |.|, and from a raw init some depths lie at or
    below 0, where the objective's 1/z makes the loss NaN (two of 12 steps
    on the CPU at 64x64)."""
    steps, evals = 12, 3  # 96 samples an epoch; 30 validation frames: 3 batches of 8
    start = tmp / "unet_conditioned.pt"
    ckpt.save_checkpoint(start, training.create_train_state(conditioned_unet(
        init_weights(UNet(), torch.Generator().manual_seed(SEED)))), 0, 0.0)
    argv = _trainer_argv(data, tmp / "unet", "--architecture", "unet",
                         "--load_trained_model", "--trained_model_path", str(start))
    argv[argv.index("--number_epoch") + 1] = "0"
    argv[argv.index("--num_iter") + 1] = str(8 * steps)
    _reset_launch_counts()
    run = trainer.main(argv)
    torch.cuda.synchronize()
    launches = _launch_counts()
    expected = dict.fromkeys(launches, 0)
    expected.update(warp_sample_fwd=steps + evals, warp_sample_bwd=steps)
    print(f"  UNet trainer [{card}]: launches {launches} (expected {expected}); losses "
          f"{[round(v, 5) for v in run.losses]}")
    if launches != expected:
        raise AssertionError(f"unexpected UNet trainer launches {launches}")
    if len(run.losses) != steps or not np.isfinite(run.losses).all():
        raise AssertionError(f"UNet losses {run.losses}")
    (path,) = run.checkpoints
    loaded = _check_checkpoint(path, UNet(dtype=torch.bfloat16))
    if (loaded["epoch"], loaded["step"]) != (1, steps):
        raise AssertionError(f"{path.name}: {loaded}")
    median = float(np.median(run.step_ms))
    n_params = sum(p.numel() for p in run.state.model.parameters())
    print(f"  UNet checkpoint loads back: {loaded}, {n_params:,} parameters")
    print(f"timing [{card}] UNet trainer step bf16 b8 256x320: median {median:.4f} ms "
          f"({8000 / median:.2f} samples/s) of {len(run.step_ms)} steps after 2 warm-up "
          f"steps (board every 2 steps); steps ms {[round(t, 3) for t in run.step_ms]}")
    return {"launches": launches, "median_ms": median}


# the distributed phase: FCDenseNet-57's global batch b8 256x320 over 2 ranks
DIST_WORLD, DIST_BATCH, DIST_STEPS = 2, 8, 10
DIST_SCALARS = ("loss", "sparse_flow_loss", "depth_consistency_loss", "grad_norm")
# the f32 step's update, max|d|/max|ref|: between the 2-rank step's
# reading and a planted fault's (PERF.md §2)
DIST_UPDATE_LIMIT = 1e-3
# a rank's trainer in a process of its own: its launches, step times and
# checkpoints as the last line of its output
TRAINER_CHILD = """\
import json, sys
from endoscopydepthestimation_pytorch_tpu_torch import train
from endoscopydepthestimation_pytorch_tpu_torch.ops import block_engine, dense_conv, warp_sample
run = train.main(sys.argv[1:])
print(json.dumps({"launches": {"dense_conv_fwd": dense_conv.LAUNCHES, **warp_sample.LAUNCHES,
                               **block_engine.LAUNCHES},
                  "step_ms": run.step_ms, "losses": run.losses,
                  "checkpoints": [str(p) for p in run.checkpoints]}))
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_rank(rank: int, world: int, port: int, out: str) -> None:
    """(15a) One of two ranks on the one card over gloo (NCCL refuses two
    ranks on one device; gloo stages CUDA tensors through the host): one
    f32 step and DIST_STEPS bf16 steps on its rows of the train phase's
    synthetic b8 batch, from the train phase's conditioned weights. Saves
    what the parent compares to ``out/rank<r>.pt``, with the f32 step's
    twin under a planted fault."""
    from endoscopydepthestimation_pytorch_tpu_torch.parallel import distributed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    distributed.init_distributed(f"127.0.0.1:{port}", world, rank, dev, backend="gloo")
    try:
        n = DIST_BATCH // world
        data = {k: v[rank * n:(rank + 1) * n].contiguous() for k, v in
                synthetic_batch(DIST_BATCH, 256, 320, SEED + 5, dev).items()}
        dcl = torch.tensor(0.1, device=dev)
        base = training.TrainConfig(lr_step_size=50)

        def f32_step() -> dict:
            state = distributed.broadcast_state(training.create_train_state(
                conditioned(seeded_model(SEED)).to(dev)))
            state, metrics = training.train_step(state, data, dcl, base)
            return {"metrics": {k: float(metrics[k]) for k in DIST_SCALARS},
                    "momentum": [b.cpu() for b in state.momentum],
                    "model": {k: v.cpu() for k, v in state.model.state_dict().items()}}

        f32 = f32_step()
        # a planted fault: the engine's BN gradients summed over the ranks
        # inside the engine as well as averaged after the backward, i.e.
        # world times too large; the parent's limits must reject it
        engine_bn = [".layers." in k and ".norm." in k
                     for k, _ in FCDenseNet57().named_parameters()]
        average = distributed.average_gradients
        distributed.average_gradients = lambda grads: [
            g * world if bn else g for g, bn in zip(average(grads), engine_bn)]
        try:
            planted = f32_step()
        finally:
            distributed.average_gradients = average

        config = dataclasses.replace(base, compute_dtype=torch.bfloat16)
        state = distributed.broadcast_state(training.create_train_state(
            conditioned(seeded_model(SEED, torch.bfloat16)).to(dev)))
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(DIST_STEPS + 1)]
        losses = []
        _reset_launch_counts()
        events[0].record()
        for i in range(DIST_STEPS):
            state, metrics = training.train_step(state, data, dcl, config)
            events[i + 1].record()
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        launches = _launch_counts()
        # the step's collectives alone: 110 of a (2, C) statistic, one of
        # the gradients (host clock, synchronized; after a barrier)
        n_grad = sum(p.numel() for p in state.model.parameters())
        collective_ms = {}
        for name, shape, count in (("stats", (2, 256), 110), ("grads", (n_grad,), 1)):
            t = torch.ones(shape, device=dev)
            distributed.barrier(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(count):
                distributed.all_mean_(t)
            torch.cuda.synchronize()
            collective_ms[name] = (time.perf_counter() - t0) * 1e3
        torch.save({"f32": f32, "planted": planted, "launches": launches, "collective_ms": collective_ms,
                    "n_grad": n_grad,
                    "losses": torch.stack(losses).cpu(),
                    "step_ms": [events[i].elapsed_time(events[i + 1])
                                for i in range(DIST_STEPS)],
                    "model": {k: v.cpu() for k, v in state.model.state_dict().items()},
                    "momentum": [b.cpu() for b in state.momentum],
                    "count": int(state.count), "step": int(state.step)},
                   Path(out) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def _spawn_ranks(world: int, out: Path, timeout: float = 300.0) -> list:
    """Run ``_dist_rank`` on ``world`` spawned ranks; a rank that fails
    ends the others and raises, and so does one that outlives
    ``timeout``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_dist_rank, args=(world, _free_port(), str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks ran past {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _trainer_process(argv: list) -> dict:
    """The trainer (``train.main``) in a process of its own, which must exit
    0; returns the launches, step times, losses and checkpoints it prints."""
    proc = subprocess.run([sys.executable, "-c", TRAINER_CHILD, *argv],
                          capture_output=True, text=True, timeout=600,
                          cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise RuntimeError(f"the trainer exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def two_rank_phase(card: str, tmp: Path) -> dict:
    """(15a) Data parallel across processes (``parallel.distributed``):
    K2-K6 against their plain versions at a rank's shapes (2B = 8); two
    ranks on the one card over gloo, each with 4 rows of the b8 batch:
    their f32 step against one process's b8 f32 step (losses and grad norm
    rel <= 1e-3, PERF.md's train-parity limit; the step's update, the
    momentum, max|d|/max|ref| over all parameters <= DIST_UPDATE_LIMIT;
    BN statistics max|d|/max|ref| <= 1e-4), and a planted fault (the
    engine's BN gradients world times too large) that the update's limit
    must reject; then DIST_STEPS bf16 steps after which both ranks'
    launches (K2-K6, no K1) are those of a step and equal, and their
    parameters, momentum and running statistics and their losses bitwise
    equal."""
    dev = torch.device("cuda")
    local = 2 * DIST_BATCH // DIST_WORLD  # a rank's stacked pair
    print(f"  K2-K6 at a rank's shapes, 2B = {local}:")
    max_abs = engine_kernel_check(local)
    err = sampler_check(*_sampler_inputs(local, 256, 320))
    max_abs.update(warp_sample_fwd=err["abs_fwd"], warp_sample_bwd=err["abs_bwd"])

    base = training.TrainConfig(lr_step_size=50)
    state = training.create_train_state(conditioned(seeded_model(SEED)).to(dev))
    state, metrics = training.train_step(
        state, synthetic_batch(DIST_BATCH, 256, 320, SEED + 5, dev),
        torch.tensor(0.1, device=dev), base)
    ref = {k: float(metrics[k]) for k in DIST_SCALARS}
    ref_momentum = [b.cpu() for b in state.momentum]
    param_names = [k for k, _ in state.model.named_parameters()]
    ref_model = {k: v.cpu() for k, v in state.model.state_dict().items()}
    del state, metrics

    def readings(step: dict) -> dict:
        """rel of each scalar; the update over all parameters at once (a
        conv bias ahead of a BN has a true gradient of 0, so its update is
        f32 noise) and the tensor of its largest error; the BN statistics
        per tensor. The update is read from the momentum, the step's
        parameter change over -lr before the parameters' f32 rounding."""
        rel = {k: _rel_scalar(step["metrics"][k], ref[k]) for k in DIST_SCALARS}
        d = [(a - b).abs().max().item() for a, b in zip(step["momentum"], ref_momentum)]
        rel["update"] = max(d) / max(b.abs().max().item() for b in ref_momentum)
        rel["worst"] = param_names[d.index(max(d))]
        rel["statistics"] = max(_rel(step["model"][k], ref_model[k])
                                for k in ref_model if "running" in k)
        return rel

    t0 = time.perf_counter()
    out = tmp / "ranks"
    out.mkdir()
    ranks = _spawn_ranks(DIST_WORLD, out)
    spawned_s = time.perf_counter() - t0
    rel, planted = readings(ranks[0]["f32"]), readings(ranks[0]["planted"])
    print(f"distributed phase [{card}]: 2 ranks on one card over gloo, b{DIST_BATCH} "
          f"256x320 split 2 x b{DIST_BATCH // DIST_WORLD}, {spawned_s:.1f} s with the "
          f"spawns; f32 step against one process at b{DIST_BATCH}: rel " +
          ", ".join(f"{k} {rel[k]:.3e}" for k in DIST_SCALARS) +
          f" (limit 1e-3); the update (momentum) max|d|/max|ref| {rel['update']:.3e} "
          f"(limit {DIST_UPDATE_LIMIT:.0e}; largest in {rel['worst']}), BN statistics "
          f"{rel['statistics']:.3e} "
          f"(limit 1e-4); planted fault (the engine's BN gradients x{DIST_WORLD}): grad "
          f"norm rel {planted['grad_norm']:.3e}, update {planted['update']:.3e} (largest "
          f"in {planted['worst']}), BN statistics {planted['statistics']:.3e}")
    if not (all(rel[k] <= 1e-3 for k in DIST_SCALARS) and rel["update"] <= DIST_UPDATE_LIMIT
            and rel["statistics"] <= 1e-4):
        raise AssertionError("the 2-rank f32 step disagrees with the b8 step")
    if not planted["update"] > DIST_UPDATE_LIMIT:
        raise AssertionError("the update's limit lets the planted fault pass")

    a, b = ranks
    expected = {"dense_conv_fwd": 0, "warp_sample_fwd": DIST_STEPS,
                "warp_sample_bwd": DIST_STEPS,
                **engine_launches(DIST_STEPS, DIST_STEPS, ranks=2)}
    same = (all(torch.equal(a["model"][k], v) for k, v in b["model"].items())
            and all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
            and (a["count"], a["step"]) == (b["count"], b["step"]) == (DIST_STEPS,) * 2
            and torch.equal(a["losses"], b["losses"]))
    print(f"  {DIST_STEPS} bf16 steps: losses " +
          " ".join(f"{v:.5f}" for v in a["losses"].tolist()) +
          f"; launches rank 0 {a['launches']}, rank 1 {b['launches']} (expected "
          f"{expected} each); parameters, momentum, BN statistics and losses "
          f"bitwise equal across the ranks: {same}")
    if not (a["launches"] == b["launches"] == expected and same
            and torch.isfinite(a["losses"]).all()):
        raise AssertionError("the 2-rank bf16 steps failed their checks")
    step_ms = sorted(a["step_ms"][2:])[len(a["step_ms"][2:]) // 2]
    print(f"timing [{card}] 2 ranks, one card, gloo: not a scaling figure: bf16 step "
          f"b{DIST_BATCH // DIST_WORLD} a rank, 256x320: {step_ms:.4f} ms median of "
          f"rank 0's steps 3-{DIST_STEPS}; steps ms {[round(t, 3) for t in a['step_ms']]}; "
          f"the step's collectives alone on rank 0: 110 all-reduces of a (2, 256) f32 "
          f"tensor {a['collective_ms']['stats']:.3f} ms, one of the {a['n_grad']} "
          f"gradient floats {a['collective_ms']['grads']:.3f} ms")

    return {"launches": {k: a["launches"][k] + b["launches"][k] for k in a["launches"]},
            "max_abs": max_abs}


def nccl_world1_phase(card: str, data: Path, tmp: Path) -> dict:
    """(15b) The trainer over NCCL at world size 1 through its flags, one
    epoch with validation, against the same trainer run without them: both
    exit 0 with a checkpoint that loads back and the launches of a run
    without a process group."""
    # one epoch of 12 steps and 3 validation batches, no boards, so that the
    # step times are the steps'
    extra = ("--number_epoch", "0", "--num_iter", "96", "--display_interval", "0")
    flags = ("--num_processes", "1", "--process_id", "0", "--coordinator_address")
    runs = {"plain": _trainer_process(_trainer_argv(data, tmp / "plain", *extra)),
            "nccl": _trainer_process(_trainer_argv(data, tmp / "nccl", *extra, *flags,
                                                   f"127.0.0.1:{_free_port()}"))}
    expected = _trainer_expected(12, 3)
    names = {"plain": "without a process group", "nccl": "NCCL world size 1"}
    for label, run in runs.items():
        loaded = [_check_checkpoint(Path(p)) for p in run["checkpoints"]]
        print(f"  trainer {names[label]}: exit 0, launches {run['launches']} (expected "
              f"{expected}), losses {[round(v, 5) for v in run['losses']]}, checkpoint "
              f"loads back {loaded}")
        if (run["launches"] != expected or len(loaded) != 1
                or not np.isfinite(run["losses"]).all()):
            raise AssertionError(f"the trainer {names[label]} failed its checks")
    medians = {label: float(np.median(run["step_ms"])) for label, run in runs.items()}
    print(f"timing [{card}] trainer step bf16 b8 256x320 without boards, one epoch of 12 "
          f"steps in a process of its own, median of the {len(runs['nccl']['step_ms'])} "
          f"steps timed after 2 warm-ups, the plain run first: NCCL world size 1 through "
          f"the flags {medians['nccl']:.4f} ms, without a process group "
          f"{medians['plain']:.4f} ms; steps ms {[round(t, 3) for t in runs['nccl']['step_ms']]}"
          f" and {[round(t, 3) for t in runs['plain']['step_ms']]}")
    return {"launches": runs["nccl"]["launches"]}

# -- (16) the aux paths, act8 and remat -------------------------------------------


def distill_phase(card: str, config, steps: int = 10) -> dict:
    """(16a) ``distill.distill_step``: one f32 step on the card against the
    CPU at b2 128x160 (the loss and the momentum's norm, i.e. the clipped
    gradient's, rel <= 1e-3, the train-parity limit), then ``steps`` bf16
    steps at b8 256x320: finite, falling, 44 K1 (the teacher) and 44 K4,
    K5 and K6 (the student) a step, no K2 or K3. Teacher: (9)'s
    conditioned weights; student: the same from seed SEED + 1."""
    f32 = dataclasses.replace(config, compute_dtype=torch.float32)
    results = {}
    for device in ("cpu", "cuda"):
        teacher = training.create_train_state(conditioned(seeded_model(SEED)).to(device))
        student = training.create_train_state(conditioned(seeded_model(SEED + 1)).to(device))
        batch = synthetic_batch(2, 128, 160, SEED + 4, device)
        student, metrics = distill.distill_step(student, teacher, batch, f32)
        results[device] = (float(metrics["loss"]), float(sgd_update.global_norm(student.momentum)))
    rel = [abs(a - b) / abs(b) for a, b in zip(results["cuda"], results["cpu"])]
    print(f"  distill f32 step b2 128x160, card vs CPU: loss {results['cuda'][0]:.6f} / "
          f"{results['cpu'][0]:.6f} rel {rel[0]:.3e}, clipped-gradient norm rel "
          f"{rel[1]:.3e} (limit 1e-3)")
    if not max(rel) <= 1e-3:
        raise AssertionError("the card's distill step disagrees with the CPU's")

    dev = torch.device("cuda")
    teacher = training.create_train_state(
        conditioned(seeded_model(SEED, torch.bfloat16)).to(dev))
    student = training.create_train_state(
        conditioned(seeded_model(SEED + 1, torch.bfloat16)).to(dev))
    batch = synthetic_batch(8, 256, 320, SEED + 5, dev)
    teacher_stats = {k: v.clone() for k, v in teacher.model.state_dict().items()}
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    torch.cuda.synchronize()
    _reset_launch_counts()
    events[0].record()
    for i in range(steps):
        student, metrics = distill.distill_step(student, teacher, batch, config)
        events[i + 1].record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = _launch_counts()
    losses = torch.stack(losses).cpu()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    median = float(np.median(step_ms[2:]))
    expected = {"dense_conv_fwd": 44 * steps, "warp_sample_fwd": 0, "warp_sample_bwd": 0,
                **engine_launches(steps, steps)}
    kept = all(torch.equal(teacher.model.state_dict()[k], v) for k, v in teacher_stats.items())
    print(f"  distill {steps} bf16 steps b8 256x320: losses "
          + " ".join(f"{v:.6f}" for v in losses.tolist())
          + f"; launches {launches} (expected {expected}); teacher unchanged {kept}")
    print(f"timing [{card}] distill step bf16 b8 256x320: {median:.4f} ms median of steps "
          f"3-{steps} ({8000 / median:.2f} samples/s); steps ms {[round(t, 3) for t in step_ms]}")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"distill losses not finite and falling: {losses.tolist()}")
    if launches != expected or not kept or int(student.step) != steps:
        raise AssertionError("the distill steps failed their checks")
    return {"launches": launches, "ms": median}


def _validation_loader(data: Path):
    """(12)'s validation frames as the trainer loads them: 30 frames, 3
    batches of 8 at 256x320."""
    _, val_files, _ = readers.get_color_file_names_by_bag(data, ["1"], ["1"], ["1"])
    val_set = dataset.SfMDataset(
        image_file_names=val_files, folder_list=readers.get_parent_folder_names(data, [1, 2]),
        adjacent_range=[2, 6], transform=None, use_store_data=True, store_data_root=data,
        phase="validation")
    return dataset.BatchLoader(val_set, 8, shuffle=False, num_workers=8, drop_last=True)


def validation_phase(card: str, data: Path, checkpoints: list, tmp: Path) -> dict:
    """(16b) ``validation.network_validation`` over (12)'s validation
    frames from its epoch-0 and epoch-1 checkpoints: f32 on the card
    against ``device="cpu"`` (the per-batch vector at rtol 1e-3), then bf16
    on the card (44 K1 and 1 K2 a batch, ms a batch), and
    ``failure.save_if_best`` over the two bf16 vectors, which must write
    what ``outlier_robust_validation_loss_delta`` decides."""
    batches = list(_validation_loader(data))
    vectors, launches, ms = {}, {}, []
    for epoch, path in enumerate(checkpoints):
        f32 = {}
        for device in ("cpu", "cuda"):
            model, _, _ = ckpt.load_any_checkpoint(path, FCDenseNet57())
            state = training.create_train_state(model.to(device))
            _, f32[device] = validation.network_validation(state, batches)
        worst = float(np.max(np.abs(np.subtract(f32["cuda"], f32["cpu"]))
                             / np.abs(f32["cpu"])))
        print(f"  network_validation f32, epoch-{epoch} checkpoint, {len(batches)} batches "
              f"of 8: card {[round(v, 6) for v in f32['cuda']]}, CPU "
              f"{[round(v, 6) for v in f32['cpu']]}, max rel {worst:.3e} (limit 1e-3)")
        if len(f32["cuda"]) != len(batches) or not worst <= 1e-3:
            raise AssertionError("the card's f32 validation disagrees with the CPU's")
        model, _, _ = ckpt.load_any_checkpoint(path, FCDenseNet57(dtype=torch.bfloat16))
        state = training.create_train_state(model.cuda())
        validation.network_validation(state, batches[:1])  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        _, vectors[epoch] = validation.network_validation(state, batches)
        ms.append((time.perf_counter() - t0) * 1e3 / len(batches))
        launches[epoch] = _launch_counts()
        expected = dict.fromkeys(launches[epoch], 0)
        expected.update(dense_conv_fwd=44 * len(batches), warp_sample_fwd=len(batches))
        print(f"  network_validation bf16, epoch-{epoch} checkpoint: "
              f"{[round(v, 6) for v in vectors[epoch]]}; launches {launches[epoch]} "
              f"(expected {expected})")
        if launches[epoch] != expected or not np.isfinite(vectors[epoch]).all():
            raise AssertionError("the bf16 validation failed its checks")
    print(f"timing [{card}] network_validation bf16 b8 256x320 (2B = 16 a forward): "
          f"{np.median(ms):.4f} ms a batch by the host clock, data on the host "
          f"(epoch 0, 1: {[round(t, 3) for t in ms]})")

    written = []
    model, _, _ = ckpt.load_any_checkpoint(checkpoints[-1], FCDenseNet57())
    state = training.create_train_state(model)

    def save(path):
        ckpt.save_checkpoint(path, state, 0, 0.0)
        written.append(Path(path).name)

    best = failure.save_if_best(save, tmp, tmp / "best.pt", "0", vectors[0],
                                np.full(len(vectors[0]), 1e10))  # no best yet
    best = failure.save_if_best(save, tmp, tmp / "best.pt", "1", vectors[1], best)
    delta = failure.outlier_robust_validation_loss_delta(vectors[1], vectors[0])
    want = ["checkpoint_model_epoch_0", "best.pt", "checkpoint_model_epoch_1"] + (
        ["best.pt"] if delta < 0 else [])
    print(f"  save_if_best: robust delta epoch 1 vs 0 {delta:+.6f}, wrote {written}, "
          f"best vector {[round(v, 6) for v in best]}")
    if written != want or not np.array_equal(best, vectors[1] if delta < 0 else vectors[0]):
        raise AssertionError(f"save_if_best wrote {written}, expected {want}")
    counts = {k: launches[0][k] + launches[1][k] for k in launches[0]}
    return {"launches": counts, "ms": float(np.median(ms))}


def _store_model(store: str, dtype=torch.bfloat16) -> torch.nn.Module:
    model = FCDenseNet57(dtype=dtype, act8=store.startswith("act8"), remat=store == "remat")
    model.load_state_dict(conditioned(seeded_model(SEED, dtype)).state_dict())
    return model.cuda()


def _store_grads(model, batch, config) -> tuple:
    """One train-mode forward and backward of the step's loss, on a copy
    (the model's statistics stay): the loss and the gradients."""
    model = copy.deepcopy(model).train()
    d1, d2 = training._forward_pair(model, batch)
    loss, _ = training.compute_losses(d1, d2, batch, config.sfl_weight,
                                      torch.tensor(0.1, device=batch["boundary"].device),
                                      config.zero_division_epsilon)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


STORES = ("engine", "act8 replay", "act8 saved_buf", "remat")


@contextlib.contextmanager
def _bwd_mode(store: str):
    saved = act8.BWD_MODE
    act8.BWD_MODE = "saved_buf" if store == "act8 saved_buf" else "replay"
    try:
        yield
    finally:
        act8.BWD_MODE = saved


def store_phase(card: str, config, steps: int = 10) -> dict:
    """(16c, d) The train step at b8 256x320 bf16 from (9)'s conditioned
    weights and batch, through the engine and with act8 (replay and
    saved_buf) and remat, in one call: each store's first step's loss and
    new BN statistics bitwise equal to the engine route's; act8's gradient
    cosine above 0.99 against the engine route's, remat's gradients bitwise
    equal; ``steps`` steps finite and falling with the launches of a step
    (K4 88 where the backward replays the blocks); peak memory (act8's
    below the engine route's) and the median step of each, the stores in
    turns."""
    dev = torch.device("cuda")
    data = synthetic_batch(8, 256, 320, SEED + 5, dev)
    dcl = torch.tensor(0.1, device=dev)
    runs = {}
    ref_grads = None
    for store in STORES:
        with _bwd_mode(store):
            model = _store_model(store)
            loss, grads = _store_grads(model, data, config)
            if ref_grads is None:
                ref_grads, ref_loss = grads, loss
            flat = torch.cat([g.flatten().double() for g in grads])
            ref = torch.cat([g.flatten().double() for g in ref_grads])
            cos = float(flat @ ref / flat.norm() / ref.norm())
            same = all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
            del grads
            state = training.create_train_state(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
            losses, first_stats = [], None
            _reset_launch_counts()
            events[0].record()
            for i in range(steps):
                state, metrics = training.train_step(state, data, dcl, config)
                events[i + 1].record()
                losses.append(metrics["loss"])
                if i == 0:
                    first_stats = {k: v.clone() for k, v in state.model.state_dict().items()
                                   if "running" in k}
            torch.cuda.synchronize()
            launches = _launch_counts()
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
        runs[store] = {"loss0": loss, "cos": cos, "same_grads": same,
                       "losses": torch.stack(losses).cpu(), "stats": first_stats,
                       "launches": launches, "step_ms": step_ms,
                       "median": float(np.median(step_ms[2:])),
                       "peak": torch.cuda.max_memory_allocated() / 2 ** 30}
        del state, model
    # alternate the stores for a fairer time: five rounds of one step each
    states = {}
    for store in STORES:
        with _bwd_mode(store):
            states[store] = training.create_train_state(_store_model(store))
    turns = {store: [] for store in STORES}
    for r in range(5):
        for store in (STORES if r % 2 == 0 else STORES[::-1]):
            with _bwd_mode(store):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                training.train_step(states[store], data, dcl, config)
                end.record()
                torch.cuda.synchronize()
                turns[store].append(start.elapsed_time(end))
    del states

    engine = runs["engine"]
    for store, run in runs.items():
        replays = steps if store in ("act8 replay", "remat") else 0
        expected = {"dense_conv_fwd": 0, "warp_sample_fwd": steps, "warp_sample_bwd": steps,
                    **engine_launches(steps, steps, replays=replays)}
        first_loss_same = bool(torch.equal(run["losses"][0], engine["losses"][0])
                               and torch.equal(run["loss0"], engine["loss0"]))
        stats_same = all(torch.equal(run["stats"][k], v) for k, v in engine["stats"].items())
        print(f"  {store}: first step loss bitwise the engine's {first_loss_same}, new BN "
              f"statistics bitwise {stats_same}; gradient cosine vs the engine's "
              f"{run['cos']:.6f}, bitwise {run['same_grads']}; losses "
              + " ".join(f"{v:.5f}" for v in run["losses"].tolist())
              + f"; launches {run['launches']} (expected {expected})")
        print(f"timing [{card}] train step bf16 b8 256x320, {store}: {run['median']:.4f} ms "
              f"median of steps 3-{steps}, in turns {np.median(turns[store]):.4f} ms "
              f"({[round(t, 3) for t in turns[store]]}); peak memory {run['peak']:.4f} GiB")
        ok = (first_loss_same and stats_same and run["launches"] == expected
              and torch.isfinite(run["losses"]).all() and run["losses"][-1] < run["losses"][0]
              and (run["same_grads"] if store in ("engine", "remat") else run["cos"] > 0.99))
        if store.startswith("act8"):  # the e4m3 store must lower the peak
            ok = ok and run["peak"] < engine["peak"]
        if not ok:
            raise AssertionError(f"the {store} train step failed its checks")
    launches = {k: sum(run["launches"][k] for run in runs.values()) for k in engine["launches"]}
    return {"launches": launches,
            "peak": {s: r["peak"] for s, r in runs.items()},
            "ms": {s: float(np.median(turns[s])) for s in STORES}}


def store_trainer_phase(card: str, data: Path, tmp: Path) -> dict:
    """(16e) The trainer with ``--act8`` and with ``--remat``: epoch 0 (6
    steps, 3 validation batches, boards), exit 0, K4 88 a step and 44 a
    validation batch, and a checkpoint that loads back."""
    steps, evals = 6, 3
    launches = dict.fromkeys(_launch_counts(), 0)
    for flag in ("--act8", "--remat"):
        argv = _trainer_argv(data, tmp / flag.strip("-"), flag)
        argv[argv.index("--number_epoch") + 1] = "0"
        _reset_launch_counts()
        run = trainer.main(argv)
        torch.cuda.synchronize()
        counted = _launch_counts()
        expected = _trainer_expected(steps, evals)
        for name, n in engine_launches(0, 0, replays=steps).items():  # the backward's replays
            expected[name] += n
        (path,) = run.checkpoints
        loaded = _check_checkpoint(path)
        print(f"  trainer {flag} [{card}]: launches {counted} (expected {expected}); losses "
              f"{[round(v, 5) for v in run.losses]}; checkpoint loads back {loaded}; median "
              f"step {np.median(run.step_ms):.4f} ms")
        if (counted != expected or len(run.losses) != steps
                or not np.isfinite(run.losses).all() or (loaded["epoch"], loaded["step"]) != (1, steps)):
            raise AssertionError(f"the trainer with {flag} failed its checks")
        for k, n in counted.items():
            launches[k] += n
    return {"launches": launches}


def aux_phase(card: str, config, data: Path, checkpoints: list, tmp: Path) -> dict:
    """(16) Distillation, the standalone validation and model selection,
    act8 in both modes, remat and the trainer with each; the launches of
    their main-path runs."""
    t0 = time.perf_counter()
    parts = [distill_phase(card, config),
             validation_phase(card, data, checkpoints, tmp),
             store_phase(card, config), store_trainer_phase(card, data, tmp)]
    launches = {k: sum(p["launches"][k] for p in parts) for k in parts[0]["launches"]}
    print(f"aux phase ok in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "distill": parts[0], "validation": parts[1],
            "stores": parts[2]}


def _run(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def card_name() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def _step_profile(step, card: str, steps: int = 2) -> dict:
    """A torch.profiler table of ``steps`` calls of ``step``: device ms a
    call by kernel, the attention kernels and the SDPA ops; raises where
    the attention ran no fused kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / (1e3 * steps)
    attention = {k: v for k, v in kernels.items()
                 if re.search(r"flash_fwd|flash_bwd|fmha|sdpa", k)}
    ops = {e.key for e in prof.key_averages()}
    fused = sorted(o for o in ops if "scaled_dot_product" in o)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    print(f"  profiler, ms a step by kernel [{card}]: total {sum(kernels.values()):.2f}, "
          f"attention {sum(attention.values()):.2f}; SDPA ops {fused}")
    for name, v in top:
        print(f"    {v:9.3f}  {name[:160]}")
    print("  attention kernels: " + json.dumps({k[:200]: round(v, 4)
                                                for k, v in attention.items()}))
    if "aten::_scaled_dot_product_attention_math" in ops or not attention:
        raise AssertionError(f"the attention did not run a fused kernel: {fused}")
    return {"attention_ms": sum(attention.values()), "device_ms": sum(kernels.values())}


def depth_anything_phase(card: str, batch: int = 8, steps: int = 10) -> dict:
    """(17) Depth Anything V2-Large's bf16 train step at b8 518x644 (see the
    module docstring)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 518, 644
    model = init_weights(DepthAnythingV2Large(dtype=torch.bfloat16),
                         torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        head = model.depth_head.scratch.output_conv2[2]
        head.weight.mul_(0.1)
        head.bias.mul_(0.1).add_(3.0)
    state = training.create_train_state(model.cuda())
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    data = synthetic_batch(batch, h, w, SEED + 30, "cuda")
    dcl = torch.tensor(5.0, device="cuda")
    _reset_launch_counts()
    before = (sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED,
              depth_anything.LAUNCHES["attention"])
    captured, update = [], sgd_update.update
    sgd_update.update = lambda *args: captured.append(args[2]) or update(*args)
    try:
        _, metrics = training.train_step(state, data, dcl, config)
    finally:
        sgd_update.update = update
    torch.cuda.synchronize()
    launches = {**_launch_counts(), "sgd_update": sgd_update.LAUNCHES["sgd_update"] - before[0],
                "restrided": sgd_update.RESTRIDED - before[1],
                "attention": depth_anything.LAUNCHES["attention"] - before[2]}
    params = state.params
    print(f"  one step [{card}]: loss {float(metrics['loss']):.6f}, launches {launches}, "
          f"{len(params)} tensors, {sum(p.numel() for p in params):,} parameters")
    want = {"dense_conv_fwd": 0, "warp_sample_fwd": 1, "warp_sample_bwd": 1,
            **dict.fromkeys(block_engine.LAUNCHES, 0), "sgd_update": 1, "restrided": 0,
            "attention": 24}
    if launches != want or len(params) != 402 or not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"the Depth Anything V2 step left its path: {launches}")
    grads = captured[0]
    norm0 = float(sgd_update.global_norm(grads))
    scalars = (torch.tensor(1.0, device="cuda"), torch.tensor(3e-4, device="cuda"))
    for norm in (3.0, 30.0):
        scaled = [g * (norm / norm0) for g in grads]
        got = ([p.detach().clone() for p in params], [b.clone() for b in state.momentum],
               state.count.clone(), state.step.clone())
        ref = ([p.detach().clone() for p in params], [b.clone() for b in state.momentum],
               state.count.clone(), state.step.clone())
        _, got_norm = sgd_update.update(got[0], got[1], scaled, *scalars, got[2], got[3],
                                        10.0, 0.9)
        _, ref_norm = sgd_update._sgd_update_plain(ref[0], ref[1], scaled, *scalars, ref[2],
                                                   ref[3], 10.0, 0.9)
        rel = abs(float(got_norm) - float(ref_norm)) / float(ref_norm)
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(got[0] + got[1], ref[0] + ref[1]))
        print(f"  sgd_update at norm {norm:g} against its plain loop: norm rel {rel:.3e} "
              f"(limit 1e-6), momentum and parameters max|d|/max|ref| {worst:.3e} "
              f"(limit 0 unclipped, 1e-6 clipped)")
        if not (rel <= 1e-6 and worst <= (0.0 if norm < 10 else 1e-6)):
            raise AssertionError("sgd_update disagrees with its plain loop on Depth Anything V2")
        del got, ref, scaled
    del captured, grads
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ms = _cuda_ms(lambda: losses.append(training.train_step(state, data, dcl, config)[1]["loss"]),
                  iters=steps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"  {steps} steps [{card}]: {ms:.2f} ms a step (CUDA events), "
          f"{batch / ms * 1e3:.2f} samples/s, peak {peak / 2**30:.3f} GiB; losses "
          f"{losses[0]:.6f} .. {losses[-1]:.6f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    table = _step_profile(lambda: training.train_step(state, data, dcl, config), card)
    result = {"ms": ms, "peak_bytes": peak, **table}
    del state, model, data
    torch.cuda.empty_cache()
    return result


def depth_pro_phase(card: str, steps: int = 10) -> dict:
    """(18) Depth Pro's bf16 train step at b1 1536x1536 and its predictor
    (see the module docstring)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    side = 1536
    model = init_weights(DepthProLarge(dtype=torch.bfloat16),
                         torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        head = model.head[4]
        head.weight.mul_(0.1)
        head.bias.mul_(0.1).add_(3.0)
    state = training.create_train_state(model.cuda())
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    data = synthetic_batch(1, side, side, SEED + 31, "cuda")
    dcl = torch.tensor(5.0, device="cuda")
    _reset_launch_counts()
    before = (sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED,
              depth_anything.LAUNCHES["attention"], depth_pro.LAUNCHES["tiles"])
    _, metrics = training.train_step(state, data, dcl, config)
    torch.cuda.synchronize()
    launches = {**_launch_counts(), "sgd_update": sgd_update.LAUNCHES["sgd_update"] - before[0],
                "restrided": sgd_update.RESTRIDED - before[1],
                "attention": depth_anything.LAUNCHES["attention"] - before[2],
                "tiles": depth_pro.LAUNCHES["tiles"] - before[3]}
    params = state.params
    print(f"  one step [{card}]: loss {float(metrics['loss']):.6f}, launches {launches}, "
          f"{len(params)} tensors, {sum(p.numel() for p in params):,} parameters")
    want = {"dense_conv_fwd": 0, "warp_sample_fwd": 1, "warp_sample_bwd": 1,
            **dict.fromkeys(block_engine.LAUNCHES, 0), "sgd_update": 1, "restrided": 0,
            "attention": 48, "tiles": 70}
    if launches != want or len(params) != 763 or not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"the Depth Pro step left its path: {launches}")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ms = _cuda_ms(lambda: losses.append(training.train_step(state, data, dcl, config)[1]["loss"]),
                  iters=steps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"  {steps} steps [{card}]: {ms:.2f} ms a step (CUDA events), "
          f"{1 / ms * 1e3:.3f} samples/s, peak {peak / 2**30:.3f} GiB; losses "
          f"{losses[0]:.6f} .. {losses[-1]:.6f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    table = _step_profile(lambda: training.train_step(state, data, dcl, config), card)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "depth_pro.pt"
        ckpt.save_checkpoint(path, state, 0, 0.0)
        del state, data
        torch.cuda.empty_cache()
        sequence = synthetic_sequence(256, 320)
        predictor = DepthPredictor(path, sequence, batch_size=1, downsampling=1.0,
                                   architecture="depth_pro")
        frame = synthetic_frames(1, 256, 320, SEED + 32)[0]
        tiles = depth_pro.LAUNCHES["tiles"]
        depth = predictor.predict_frame(frame)
        frame_ms = _cuda_ms(lambda: predictor.predict_frame(frame), iters=5, warmup=1)
        tiles = (depth_pro.LAUNCHES["tiles"] - tiles) / 7
    print(f"  predictor [{card}]: 256x320 crop through 1536x1536, {frame_ms:.2f} ms a frame, "
          f"{tiles:g} tiles a frame, depth {depth.shape} in [{depth.min():.4f}, "
          f"{depth.max():.4f}]")
    if depth.shape != (256, 320) or not np.isfinite(depth).all() or tiles != 35:
        raise AssertionError("the Depth Pro predictor left its path")
    del predictor, model
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_bytes": peak, "frame_ms": frame_ms, **table}


def _vggt_seeded(dtype) -> torch.nn.Module:
    """VGGT-1B from the trainer's init, the depth conditioned (3 exp(0.1
    conv)) and LayerScale 1, so the aggregator moves the depth."""
    model = init_weights(vggt.VGGT1B(dtype=dtype), torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        head = model.depth_head.scratch.output_conv2[2]
        head.weight.mul_(0.1)
        head.bias.fill_(float(np.log(3.0)))
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(1.0)
    return model


def _vggt_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """mean |got - want| over the reference's mean spread about its level."""
    want = want.float()
    return float((got.float() - want).abs().mean() / (want - want.mean()).abs().mean())


def vggt_phase(card: str, batch: int = 4, steps: int = 10) -> dict:
    """(19) VGGT against its reference, its bf16 train step at b4 pairs
    420x518 and its predictor (see the module docstring)."""
    import reference_vggt
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 420, 518
    model = _vggt_seeded(torch.bfloat16)
    reference = reference_vggt.VGGT(1024, 24, 16, 4.0, 4, (4, 11, 17, 23), 256,
                                    (256, 512, 1024, 1024), 518)
    reference.load_state_dict(model.state_dict(), strict=True)
    reference = reference.cuda()
    model = model.cuda()
    pair = torch.rand(2, 3, h, w, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(SEED)) * 2 - 1
    with torch.no_grad():
        gap = _vggt_gap(model(pair, views=2), reference(pair))
    print(f"  one pair [{card}]: bf16 depth against the float32 reference, mean gap "
          f"{gap:.5f} of the depth's spread")
    if not gap < 0.1:
        raise AssertionError(f"VGGT's depth left the reference: {gap}")
    state = training.create_train_state(model)
    config = training.TrainConfig(compute_dtype=torch.bfloat16)
    data = synthetic_batch(batch, h, w, SEED + 41, "cuda")
    dcl = torch.tensor(5.0, device="cuda")
    _reset_launch_counts()
    before = (sgd_update.LAUNCHES["sgd_update"], sgd_update.RESTRIDED,
              depth_anything.LAUNCHES["attention"], dict(vggt.LAUNCHES))
    _, metrics = training.train_step(state, data, dcl, config)
    torch.cuda.synchronize()
    launches = {**_launch_counts(), "sgd_update": sgd_update.LAUNCHES["sgd_update"] - before[0],
                "restrided": sgd_update.RESTRIDED - before[1],
                "attention": depth_anything.LAUNCHES["attention"] - before[2],
                **{k: v - before[3][k] for k, v in vggt.LAUNCHES.items()}}
    params = state.params
    print(f"  one step [{card}]: loss {float(metrics['loss']):.6f}, launches {launches}, "
          f"{len(params)} tensors, {sum(p.numel() for p in params):,} parameters")
    want = {"dense_conv_fwd": 0, "warp_sample_fwd": 1, "warp_sample_bwd": 1,
            **dict.fromkeys(block_engine.LAUNCHES, 0), "sgd_update": 1, "restrided": 0,
            "attention": 24, "frame_attention": 24, "global_attention": 24, "views": 2 * batch}
    if launches != want or len(params) != 1271 or not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"the VGGT step left its path: {launches}")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ms = _cuda_ms(lambda: losses.append(training.train_step(state, data, dcl, config)[1]["loss"]),
                  iters=steps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"  {steps} steps [{card}]: {ms:.2f} ms a step (CUDA events), "
          f"{batch / ms * 1e3:.3f} pairs/s, peak {peak / 2**30:.3f} GiB; losses "
          f"{losses[0]:.6f} .. {losses[-1]:.6f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    table = _step_profile(lambda: training.train_step(state, data, dcl, config), card)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "vggt.pt"
        ckpt.save_checkpoint(path, state, 0, 0.0)
        del state, data
        torch.cuda.empty_cache()
        sequence = synthetic_sequence(h, w)
        predictor = DepthPredictor(path, sequence, batch_size=1, downsampling=1.0,
                                   architecture="vggt_1b")
        frame = synthetic_frames(1, h, w, SEED + 42)[0]
        views = vggt.LAUNCHES["views"]
        depth = predictor.predict_frame(frame)
        frame_ms = _cuda_ms(lambda: predictor.predict_frame(frame), iters=5, warmup=1)
        views = (vggt.LAUNCHES["views"] - views) / 7
        colors = torch.from_numpy(predictor.prepare(frame))[None].cuda()
        boundary = predictor._boundary[:1].cuda()
        reference.load_state_dict(predictor.model.state_dict(), strict=True)
        with torch.no_grad():
            want = reference((colors * boundary).permute(0, 3, 1, 2), views=1)[0, 0]
        gap = _vggt_gap(torch.from_numpy(depth).cuda(), want * boundary[0, ..., 0])
    print(f"  predictor [{card}]: 420x518 crop as a one-view sequence, {frame_ms:.2f} ms a "
          f"frame, {views:g} views a frame, depth {depth.shape} in [{depth.min():.4f}, "
          f"{depth.max():.4f}], mean gap {gap:.5f} to the float32 reference")
    if depth.shape != (h, w) or not np.isfinite(depth).all() or views != 1 or not gap < 0.1:
        raise AssertionError("the VGGT predictor left its path")
    del predictor, model, reference
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_bytes": peak, "frame_ms": frame_ms, **table}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(8)
    # Inductor's cache inside the checkout (gitignored), not the user's temp dir
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(Path(__file__).resolve().parent / "build" / "inductor"))

    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print(_run([dense_conv._build.nvcc_path(), "--version"]).splitlines()[-1])
    print(f"cv2 {cv2.__version__}")

    build_phase()
    kernel = kernel_phase(card)
    k1_split_phase(card)
    print(f"sampler phase, {card}:")
    sampler = sampler_phase(card)
    engine = engine_kernel_phase(card)
    print(f"boundary phase, {card}:")
    boundary_phase(card)
    print(f"glue phase, {card}:")
    glue_phase(card)
    print(f"optimizer phase, {card}:")
    optimizer_phase(card)

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = Path(tmp) / "seeded_fcdensenet57.pt"
        save_reference_checkpoint(checkpoint, seeded_model(SEED))

        _reset_launch_counts()
        a = serving_phase(checkpoint, "cuda", torch.bfloat16, 256, 320,
                          batch=8, n_stream=24)
        hi = DepthPredictor(checkpoint, synthetic_sequence(512, 576), batch_size=1,
                            downsampling=1.0, device="cuda", dtype=torch.bfloat16)
        hi_frame = synthetic_frames(1, 512, 576, seed=SEED + 3)[0]
        hi_depth = hi.predict_frame(hi_frame)
        serving_launches = dense_conv.LAUNCHES
        forwards = a["forwards"] + 1
        print(f"serving phase: {forwards} forwards, {serving_launches} kernel launches")
        if serving_launches != 44 * forwards:
            raise AssertionError(f"expected {44 * forwards} launches, "
                                 f"got {serving_launches}")
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
        profile_forward(checkpoint, card)
        del hi

        print(f"export phase, {card}:")
        _reset_launch_counts()
        exported = export_phase(checkpoint, card, Path(tmp), fwd["b1_256x320"])
        export_launches = dense_conv.LAUNCHES + exported["launches"]

    base = training.TrainConfig(lr_step_size=50)
    config = dataclasses.replace(base, compute_dtype=torch.bfloat16)
    print(f"train parity phase, {card}:")
    train_parity_phase(base)
    train = train_phase(card, config)
    profile_train_step(train["state"], train["data"], config, card, train["ms"])
    launches = dict(train["launches"])
    launches["dense_conv_fwd"] += serving_launches + export_launches
    print(f"graph phase, {card}:")
    graph_phase(card)
    synthetic_ms = train["ms"]
    del train
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        print(f"trainer phase, {card}:")
        trained = trainer_phase(card, synthetic_ms, work)
        print(f"evaluate phase, {card}:")
        evaluated = evaluate_phase(card, trained["data"], trained["checkpoint"], work)
        print(f"UNet phase, {card}:")
        unet_parity_phase()
        unet = unet_trainer_phase(card, trained["data"], work)
        print(f"distributed phase, {card}:")
        spread = two_rank_phase(card, work)
        world1 = nccl_world1_phase(card, trained["data"], work)
        print(f"aux phase, {card}:")
        aux = aux_phase(card, config, trained["data"], trained["checkpoints"], work)
    print(f"Depth Anything V2 phase, {card}:")
    depth_anything_phase(card)
    print(f"Depth Pro phase, {card}:")
    depth_pro_phase(card)
    print(f"VGGT phase, {card}:")
    vggt_phase(card)
    for part in (trained, evaluated, unet, spread, world1, aux):
        for name, n in part["launches"].items():
            launches[name] += n

    measured = {
        "dense_conv_fwd": dict(kernel),
        "warp_sample_fwd": {
            "max_abs_err": sampler["err"]["abs_fwd"], "ms": sampler["ms"]["fwd"],
            "plain_ms": sampler["ms"]["plain_fwd"],
            "library_ms": sampler["ms"]["library_fwd"],
            "bound_ms": sampler["bounds"]["fwd"][0],
            "bound_by": sampler["bounds"]["fwd"][1]},
        "warp_sample_bwd": {
            "max_abs_err": sampler["err"]["abs_bwd"], "ms": sampler["ms"]["bwd"],
            "plain_ms": sampler["ms"]["plain_bwd"],
            "library_ms": sampler["ms"]["library_bwd"],
            "bound_ms": sampler["bounds"]["bwd"][0],
            "bound_by": sampler["bounds"]["bwd"][1]},
        **engine,
    }
    for name, err in spread["max_abs"].items():  # the kernels at a rank's shapes
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], err)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         **{k: m[k] for k in keys}}
        for name, m in measured.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
