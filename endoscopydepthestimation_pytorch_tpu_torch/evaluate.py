"""The port's evaluation CLI (the JAX package's root ``evaluate.py``:
``build_parser`` :37, ``_make_state`` :75, ``run_validation`` :103,
``run_test`` :194, ``main`` :246).

    python -m endoscopydepthestimation_pytorch_tpu_torch.evaluate \\
        --adjacent_range 5 30 --id_range 1 2 --input_size 256 320 \\
        --testing_patient_id 1 --load_all_frames --phase test \\
        --trained_model_path <checkpoint .pt> --sequence_root <sequence> \\
        --evaluation_result_root /tmp/eval --evaluation_data_root <data root>

FCDenseNet-57 (or the ``--architecture`` the trainer took, a key of
``models.ARCHITECTURES``; ``depth_anything_v2_vitl`` needs
``--network_downsampling 14``, ``depth_pro`` ``--input_size 1536 1536``,
``vggt_1b`` ``--network_downsampling 14``, each frame a one-view
sequence) from a reference-format ``.pt`` (the port's
trainer writes one per epoch), in eval mode with the running statistics.
Two phases:

  validation: frame pairs with the whole objective (``training.eval_step``
      with images); per batch a 12-panel ``{batch}.png`` (two
      ``validation_panel`` rows; the frame-2 row shows the 1->2 warped
      depth) and the first sample's scaled-depth ``{batch}.ply``; at the
      end ``metrics.json``, AbsRel and sigma < 1.25^k over the sparse
      ground truth. The ragged last batch is padded with repeats of its
      last row, as the JAX CLI pads it, so each printed loss is over the
      same rows; every per-sample output is sliced back to the real rows.
  test: single frames through ``training.predict_step``; per frame a JET
      ``{name}.png`` (color | depth) and the unprojected ``{name}.ply``.

The same flags, defaults, seed and result folder as the JAX CLI. It runs
on the CUDA card unless ``--device cpu`` asks for the CPU, and raises
without a card. Every dense layer runs K1 (``ops.dense_conv``): in f32 by
default, in bf16 on the tensor cores with ``--compute_dtype bfloat16``.
``--packed_conv``, an XLA layout of the same convolution, raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import cv2
import numpy as np
import torch

from . import losses, training
from .data import readers
from .data.dataset import BatchLoader, SfMDataset
from .models import ARCHITECTURES, check_crop
from .parallel import pad_batch_to, to_device
from .utils import checkpoint as ckpt
from .utils import visualization as viz
from .utils.pointcloud import point_cloud_from_depth, write_point_cloud

SEED = 10085
PACKED_CONV = ("an XLA-level variant of the same math that the port does not "
               "carry (ROADMAP, north star: left out on purpose)")


@dataclasses.dataclass
class EvalRun:
    """What ``main`` returns: the result folder, the validation metrics
    (None in the test phase), the number of frames (validation: pairs),
    and each batch's (validation) or frame's (test) wall-clock ms, from
    fetching its data to writing its last file."""
    log_root: Path
    metrics: Optional[Dict[str, float]]
    frames: int
    ms: List[float]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-supervised Depth Estimation on Monocular Endoscopy "
                    "Dataset -- Evaluate (PyTorch + CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input_downsampling", type=float, default=4.0)
    p.add_argument("--input_size", nargs="+", type=int, required=True)
    p.add_argument("--selected_frame_index_list", nargs="+", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=2, help="host loader threads")
    p.add_argument("--num_pre_workers", type=int, default=8)
    p.add_argument("--adjacent_range", nargs="+", type=int, required=True)
    p.add_argument("--id_range", nargs="+", type=int, required=True)
    p.add_argument("--network_downsampling", type=int, default=64)
    p.add_argument("--inlier_percentage", type=float, default=0.995)
    p.add_argument("--testing_patient_id", nargs="+", default=[])
    p.add_argument("--load_intermediate_data", action="store_true")
    p.add_argument("--use_hsv_colorspace", action="store_true")
    p.add_argument("--architecture_summary", action="store_true")
    p.add_argument("--load_all_frames", action="store_true")
    p.add_argument("--trained_model_path", type=str, required=True)
    p.add_argument("--sequence_root", type=str, required=True)
    p.add_argument("--evaluation_result_root", type=str, required=True)
    p.add_argument("--evaluation_data_root", type=str, required=True)
    p.add_argument("--phase", type=str, required=True,
                   choices=["validation", "test"])
    p.add_argument("--visibility_overlap", type=int, default=30)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["bfloat16", "float32"])
    p.add_argument("--rgb_mode", type=str, default="rgb")
    p.add_argument("--packed_conv", action=argparse.BooleanOptionalAction,
                   default=None, help="not ported: raises when given")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA card unless 'cpu' is asked for")
    p.add_argument("--architecture", type=str, default="fcdensenet57",
                   choices=sorted(ARCHITECTURES), help="the network the checkpoint holds")
    return p


def _make_state(args, height: int, width: int, device: torch.device):
    """``--architecture`` in ``--compute_dtype`` with the checkpoint's
    weights, in eval mode on ``device``, as a ``TrainState`` for
    ``eval_step``."""
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = ARCHITECTURES[args.architecture](n_classes=1, dtype=dtype)
    if args.architecture_summary:
        # the reference prints torchsummary in both phases (its
        # evaluate.py:142, 302)
        print(model)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{args.architecture}: {n_params:,} parameters, input {height}x{width}, "
              f"dtype {args.compute_dtype}, device {device}")
    if not Path(args.trained_model_path).exists():
        raise OSError("Trained model could not be found")
    model, epoch, _ = ckpt.load_any_checkpoint(args.trained_model_path, model)
    print(f"Restored model, epoch {epoch}")
    state = training.create_train_state(model.to(device).eval())
    return state, training.TrainConfig(compute_dtype=dtype)


def _dataset(args, phase: str) -> SfMDataset:
    data_root = Path(args.evaluation_data_root)
    sequence_root = Path(args.sequence_root)
    frame_list = (readers.read_visible_view_indexes(sequence_root)
                  if args.load_all_frames else args.selected_frame_index_list)
    if frame_list is None:
        raise IOError("provide --selected_frame_index_list or --load_all_frames")
    return SfMDataset(
        image_file_names=readers.get_filenames_from_frame_indexes(sequence_root,
                                                                  frame_list),
        folder_list=readers.get_parent_folder_names(data_root, args.id_range),
        adjacent_range=args.adjacent_range, transform=None,
        downsampling=args.input_downsampling,
        network_downsampling=args.network_downsampling,
        inlier_percentage=args.inlier_percentage,
        visible_interval=args.visibility_overlap,
        use_store_data=args.load_intermediate_data, store_data_root=data_root,
        phase=phase, is_hsv=args.use_hsv_colorspace,
        num_pre_workers=args.num_pre_workers, rgb_mode=args.rgb_mode)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def run_validation(args, log_root: Path, height: int, width: int,
                   device: torch.device) -> EvalRun:
    """Frame pairs through ``eval_step``; writes the boards, the clouds and
    ``metrics.json``."""
    dataset = _dataset(args, "validation")
    # num_workers: host loader threads (the reference passes its flag to
    # DataLoader, evaluate.py:262-265 there)
    loader = BatchLoader(dataset, args.batch_size, shuffle=False,
                         drop_last=False, num_workers=args.num_workers)
    state, config = _make_state(args, height, width, device)
    dcl_weight = torch.tensor(config.dcl_weight, dtype=torch.float32, device=device)
    abs_rels, sigmas, ms = [], [], []

    t0 = time.perf_counter()
    for batch_idx, batch in enumerate(loader):
        padded = pad_batch_to(batch, args.batch_size)
        valid = padded.pop("_valid")
        device_batch = to_device(padded, device)
        metrics = training.eval_step(state, device_batch, dcl_weight, config,
                                     with_images=True)
        scaled = metrics["scaled_depth_1"][:valid]
        sparse = device_batch["sparse_depth_1"][:valid]
        mask = device_batch["depth_mask_1"][:valid]
        abs_rels.append(_host(losses.abs_rel_error(scaled, sparse, mask)))
        sigmas.append(np.stack([_host(s) for s in
                                losses.threshold_metric(scaled, sparse, mask)]))
        out = {k: _host(metrics[k][:valid]) for k in (
            "scaled_depth_1", "scaled_depth_2", "warped_depth_1_to_2",
            "warped_depth_2_to_1", "flows_from_depth_1", "flows_from_depth_2")}

        boundary = batch["boundary"]
        panels_1 = viz.validation_panel(
            batch["color_1"], batch["sparse_depth_1"],
            out["scaled_depth_1"] * boundary, out["warped_depth_2_to_1"],
            batch["flow_1"] * boundary, out["flows_from_depth_1"] * boundary,
            boundary, is_hsv=args.use_hsv_colorspace)
        # the frame-2 row renders the 1->2 warped depth (reference
        # evaluate.py:242-259), not the frame-2 prediction again
        panels_2 = viz.validation_panel(
            batch["color_2"], batch["sparse_depth_2"],
            out["scaled_depth_2"] * boundary, out["warped_depth_1_to_2"],
            batch["flow_2"] * boundary, out["flows_from_depth_2"] * boundary,
            boundary, is_hsv=args.use_hsv_colorspace)
        image = viz.stack_panels(panels_1 + panels_2)
        cv2.imwrite(str(log_root / f"{batch_idx}.png"),
                    cv2.cvtColor(np.uint8(np.clip(image, 0, 1) * 255),
                                 cv2.COLOR_RGB2BGR))

        # the first sample's scaled-depth point cloud (reference
        # evaluate.py:272-274)
        color = np.uint8((batch["color_1"][0] * 0.5 + 0.5) * 255)
        cloud = point_cloud_from_depth(
            out["scaled_depth_1"][0, :, :, 0], cv2.cvtColor(color, cv2.COLOR_RGB2BGR),
            boundary[0, :, :, 0], batch["intrinsic"][0], point_cloud_downsampling=1)
        write_point_cloud(str(log_root / f"{batch_idx}.ply"), cloud)
        print(f"batch {batch_idx}: loss {float(metrics['loss']):.5f}")
        ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()

    abs_rel = float(np.concatenate(abs_rels).mean()) if abs_rels else float("nan")
    sig = np.concatenate(sigmas, axis=1)  # (3, samples)
    result = {"abs_rel": abs_rel, "sigma_1.25": float(sig[0].mean()),
              "sigma_1.25^2": float(sig[1].mean()),
              "sigma_1.25^3": float(sig[2].mean())}
    print(f"AbsRel {abs_rel:.5f}  sigma<1.25 {result['sigma_1.25']:.4f}  "
          f"sigma<1.25^2 {result['sigma_1.25^2']:.4f}  "
          f"sigma<1.25^3 {result['sigma_1.25^3']:.4f}")
    with open(log_root / "metrics.json", "w") as f:
        json.dump(result, f)
    return EvalRun(log_root, result, len(dataset), ms)


def run_test(args, log_root: Path, height: int, width: int,
             device: torch.device) -> EvalRun:
    """Single frames through ``predict_step`` at batch 1; writes a PNG and
    a PLY per frame."""
    dataset = _dataset(args, "test")
    state, _ = _make_state(args, height, width, device)

    ms = []
    for idx in range(len(dataset)):
        t0 = time.perf_counter()
        sample = dataset[idx]
        colors = torch.from_numpy(sample["color_1"])[None].to(device)
        boundary = torch.from_numpy(sample["boundary"])[None].to(device)
        depth = _host(training.predict_step(state.model, colors, boundary))[0, :, :, 0]

        boundary_np = sample["boundary"][:, :, 0]
        color_disp = np.uint8((sample["color_1"] * 0.5 + 0.5) * 255)
        color_disp = cv2.cvtColor(color_disp, cv2.COLOR_HSV2BGR_FULL
                                  if args.use_hsv_colorspace else cv2.COLOR_RGB2BGR)
        color_disp = np.uint8(boundary_np[:, :, None] * color_disp)
        depth_masked = depth * boundary_np
        depth_vis = cv2.applyColorMap(
            np.uint8(255 * depth_masked / max(float(depth_masked.max()), 1e-12)),
            cv2.COLORMAP_JET)

        cloud = point_cloud_from_depth(depth_masked, color_disp, boundary_np,
                                       sample["intrinsic"], point_cloud_downsampling=1)
        write_point_cloud(str(log_root / f"{sample['name']}.ply"), cloud)
        cv2.imwrite(str(log_root / f"{sample['name']}.png"),
                    cv2.hconcat([color_disp, depth_vis]))
        print(f"frame {sample['name']}: depth range "
              f"[{depth_masked.min():.4f}, {depth_masked.max():.4f}]")
        ms.append((time.perf_counter() - t0) * 1e3)
    return EvalRun(log_root, None, len(dataset), ms)


def main(argv=None) -> EvalRun:
    """Run one phase (see ``EvalRun``)."""
    args = build_parser().parse_args(argv)
    if args.packed_conv is not None:
        raise ValueError(f"--packed_conv is not supported by the port: {PACKED_CONV}")
    check_crop(args.architecture, args.network_downsampling, args.input_size)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; --device cpu asks for "
                           "the CPU")
    height, width = args.input_size
    np.random.seed(SEED)
    random.seed(SEED)

    now = datetime.datetime.now()
    log_root = Path(args.evaluation_result_root) / (
        "depth_estimation_evaluation_run_{}_{}_{}_{}_test_id_{}".format(
            now.month, now.day, now.hour, now.minute,
            "_".join(str(i) for i in args.testing_patient_id)))
    log_root.mkdir(parents=True, exist_ok=True)
    print(f"Results at {log_root}")

    run = run_validation if args.phase == "validation" else run_test
    return run(args, log_root, height, width, device)


if __name__ == "__main__":
    main()
