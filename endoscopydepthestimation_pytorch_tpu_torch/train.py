"""The port's self-supervised depth trainer (the JAX package's
root ``train.py``: ``build_parser`` :57, ``main`` :194-495).

    python -m endoscopydepthestimation_pytorch_tpu_torch.train \\
        --adjacent_range 5 30 --id_range 1 2 --input_size 256 320 \\
        --batch_size 8 --num_iter 1000 --number_epoch 100 \\
        --training_patient_id 1 --testing_patient_id 1 --validation_patient_id 1 \\
        --training_result_root /tmp/run --training_data_root <data root>

The same flags, defaults, log root, checkpoint names and loop as the JAX
trainer: the per-epoch reseed, the DCL warmup, a training board every
``--display_interval`` steps, metrics read back one step late, validation
every ``--validation_interval`` epochs with the batch statistics (the
reference never leaves train mode there, its train.py:234, 380), and per
epoch a reference-format ``.pt`` checkpoint and ``all_scalars_<epoch>.json``.
The train step is ``training.train_step``, every FCDenseNet dense block
through the block engine (``--architecture unet`` runs PyTorch's convs and
the warp sampler's kernels only; ``--architecture depth_anything_v2_vitl``,
Depth Anything V2-Large, PyTorch's convs and matmuls and fused attention,
and needs ``--network_downsampling 14`` or a multiple, so that the crop's
sides are multiples of its 14-pixel patches; ``--architecture depth_pro``,
Depth Pro, the same kernels, and takes ``--input_size 1536 1536`` only,
its one input size; ``--architecture vggt_1b``, VGGT-1B, the same kernels,
each pair one 2-view sequence, with ``--network_downsampling 14`` and
e.g. ``--input_size 420 518``); batches reach the card through
``parallel.device_prefetch``.

It runs on the CUDA card unless ``--device cpu`` asks for the CPU, and
raises without a card. Flags for what the port does not carry, or has not
ported yet, raise an error that names the ROADMAP item.

Data parallel across cards and hosts (``parallel.distributed``): start
one process per card, each with ``--coordinator_address HOST:PORT`` (rank
0's), ``--num_processes N`` (the number of ranks in all) and
``--process_id i``. Rank i runs on ``cuda:<i % the host's card count>``
over NCCL, or on the CPU over gloo with ``--device cpu``, and loads its
``batch_size / N`` rows of every global batch. Only rank 0 creates the
log root, prints, and writes boards (from its own rows), scalars and
checkpoints, as the JAX trainer's ``_NullWriter`` ranks (root train.py:178,
234); every rank reaches the barrier after each save. When a rank raises,
it prints its traceback first and then leaves the group; the others fail
at their next collective, or at the group's timeout at the latest.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import random
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import training
from .data import readers
from .data.augment import TrainingAugmentation
from .data.dataset import BatchLoader, SfMDataset
from .models import ARCHITECTURES, check_crop, init_weights
from .parallel import device_prefetch, distributed
from .utils import checkpoint as ckpt
from .utils import visualization as viz
from .utils.profiling import StepTimer, device_trace

SEED = 10085
_IMAGE_KEYS = ("scaled_depth_1", "scaled_depth_2",
               "flows_from_depth_1", "flows_from_depth_2")
_LOSS_KEYS = ("loss", "sparse_flow_loss", "depth_consistency_loss")
_DISTRIBUTED_FLAGS = ("coordinator_address", "num_processes", "process_id")
# flag -> why the port refuses it when it is set
NOT_PORTED = {
    "fused_convs": "the port's train path runs every dense block through the "
                   "block engine, and K1 where the engine's gate refuses a block; "
                   "there is no per-layer fused train path to select (ROADMAP, "
                   "north star: third slice)",
    "segmented_last_up": "an XLA-level variant of the same math that the port "
                         "does not carry (ROADMAP, north star: left out on purpose)",
    "split_last_skip": "an XLA-level variant of the same math that the port "
                       "does not carry (ROADMAP, north star: left out on purpose)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-supervised Depth Estimation on Monocular Endoscopy "
                    "Dataset -- Train (PyTorch + CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--adjacent_range", nargs="+", type=int, required=True,
                   help="interval range for a pair of video frames")
    p.add_argument("--id_range", nargs="+", type=int, required=True,
                   help="id range for the training and testing dataset")
    p.add_argument("--input_downsampling", type=float, default=4.0,
                   help="image downsampling rate")
    p.add_argument("--input_size", nargs="+", type=int, required=True,
                   help="resolution of network input")
    p.add_argument("--batch_size", type=int, default=8, help="batch size")
    p.add_argument("--num_workers", type=int, default=8,
                   help="host loader threads")
    p.add_argument("--num_pre_workers", type=int, default=8,
                   help="processes for preprocessing intermediate data")
    p.add_argument("--dcl_weight", type=float, default=5.0,
                   help="weight for depth consistency loss after warmup")
    p.add_argument("--sfl_weight", type=float, default=20.0,
                   help="weight for sparse flow loss")
    p.add_argument("--max_lr", type=float, default=1.0e-3)
    p.add_argument("--min_lr", type=float, default=1.0e-4)
    p.add_argument("--num_iter", type=int, default=1000,
                   help="iterations per epoch (also the cyclic-LR half cycle)")
    p.add_argument("--network_downsampling", type=int, default=64)
    p.add_argument("--inlier_percentage", type=float, default=0.99)
    p.add_argument("--validation_interval", type=int, default=1)
    p.add_argument("--zero_division_epsilon", type=float, default=1.0e-8)
    p.add_argument("--display_interval", type=int, default=10)
    p.add_argument("--training_patient_id", nargs="+", required=True)
    p.add_argument("--testing_patient_id", nargs="+", required=True)
    p.add_argument("--validation_patient_id", nargs="+", required=True)
    p.add_argument("--load_intermediate_data", action="store_true")
    p.add_argument("--load_trained_model", action="store_true")
    p.add_argument("--number_epoch", type=int, required=True)
    p.add_argument("--visibility_overlap", type=int, default=30)
    p.add_argument("--use_hsv_colorspace", action="store_true")
    p.add_argument("--training_result_root", type=str, required=True)
    p.add_argument("--training_data_root", type=str, required=True)
    p.add_argument("--architecture_summary", action="store_true")
    p.add_argument("--trained_model_path", type=str, default=None)
    p.add_argument("--architecture", type=str, default="fcdensenet57",
                   choices=sorted(ARCHITECTURES))
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CUDA card unless 'cpu' is asked for")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the dense blocks: each block's backward "
                        "replays its forward (K4 again) from the block's exact "
                        "input instead of keeping its buffer; the same loss, "
                        "gradients and statistics bit for bit, less memory")
    p.add_argument("--fused_convs", action="store_true", default=None,
                   help="not ported: raises")
    p.add_argument("--block_engine", action="store_true",
                   help="the port's train path always runs the block engine "
                        "(K4/K5/K6) wherever its gate takes a block; with "
                        "--act8 those blocks stay exact (the engine takes "
                        "precedence over act8, as in the JAX trainer) and only "
                        "the transitions, the final conv and the blocks the "
                        "gate refuses keep fp8 copies; alone it changes nothing")
    p.add_argument("--segmented_last_up", action=argparse.BooleanOptionalAction,
                   default=None, help="not ported: raises when given")
    p.add_argument("--split_last_skip", action=argparse.BooleanOptionalAction,
                   default=None, help="not ported: raises when given")
    p.add_argument("--act8", action="store_true",
                   help="fp8 (e4m3) activation store for the backward "
                        "(ops/act8.py): the forward is exact; each dense block "
                        "keeps only an e4m3 copy of its input and replays "
                        "itself (K4 again) in the backward, and the transitions "
                        "and the final conv replay from e4m3 copies of their "
                        "inputs. Gradients deviate within a per-block "
                        "quantization envelope. Takes precedence over --remat")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step: one "
                        "clipped SGD update on the mean gradient; BN "
                        "normalizes per microbatch and the running statistics "
                        "advance per microbatch (training.train_step)")
    p.add_argument("--rgb_mode", type=str, default="rgb")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first epoch's "
                        "train loop here (trace.json, ops.txt, spans.json)")
    p.add_argument("--log_interval", type=int, default=10,
                   help="steps between metric readbacks (each waits for the "
                        "device); 1 gives the reference's per-iteration "
                        "scalars (its train.py:348-350)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 (data-parallel training across "
                        "cards and hosts; give all three of these flags)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total number of ranks, one process per card")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")
    return p


@dataclasses.dataclass
class TrainRun:
    """What ``main`` returns: the log root, the final state, the
    checkpoints written, every loss read back (one per step at
    ``--log_interval 1``), the wall-clock step times after the timer's
    warm-up, and the profile's summary (``--profile_dir``). On every rank
    but 0 the log root is None and there are no checkpoints."""
    log_root: Optional[Path]
    state: training.TrainState
    checkpoints: List[Path]
    losses: List[float]
    step_ms: List[float]
    profile: Optional[Dict[str, float]]


def _refuse_unported(args) -> None:
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag) is not None:  # given on the command line
            raise ValueError(f"--{flag} is not supported by the port: {why}")


def _check_architecture(args) -> None:
    """The architecture's own refusals, before any data is read: its
    builder, run on the meta device, refuses flags it has no use for, the
    input size must be its fixed one where it has one, and the crops must
    be whole multiples of its ``crop_multiple``."""
    with torch.device("meta"):
        ARCHITECTURES[args.architecture](n_classes=1, act8=args.act8, remat=args.remat,
                                         block_engine=args.block_engine)
    check_crop(args.architecture, args.network_downsampling, args.input_size)


def _distributed(args) -> bool:
    """Whether the flags ask for a process group: all three of them, or
    none."""
    given = [f"--{f}" for f in _DISTRIBUTED_FLAGS if getattr(args, f) is not None]
    if given and len(given) < len(_DISTRIBUTED_FLAGS):
        raise ValueError("data-parallel training needs --coordinator_address, "
                         "--num_processes and --process_id together; got only "
                         + ", ".join(given))
    return bool(given)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _board(batch, metrics, is_hsv: bool) -> np.ndarray:
    """The 8-row board c1, d1, sf1, df1, c2, d2, sf2, df2 (reference
    train.py:353-371, 461-479)."""
    boundary = _host(batch["boundary"])
    panels = []
    for f in ("1", "2"):
        panels += viz.training_panel(
            _host(batch[f"color_{f}"]),
            _host(metrics[f"scaled_depth_{f}"]) * boundary,
            _host(batch[f"flow_{f}"]) * boundary,
            _host(metrics[f"flows_from_depth_{f}"]), is_hsv=is_hsv)
    return viz.stack_panels(panels)


def main(argv=None) -> TrainRun:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    _check_architecture(args)
    multi = _distributed(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; --device cpu asks for "
                           "the CPU")
    if not multi:
        return _run(args, device)
    distributed.check_batch_divides(args.batch_size, args.num_processes)
    if device.type == "cuda":
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    distributed.init_distributed(args.coordinator_address, args.num_processes,
                                 args.process_id, device)
    try:
        run = _run(args, device)
        distributed.barrier("train_done")  # no rank leaves while another works
        return run
    except BaseException:
        # this rank's traceback first: leaving the group may wait, and the
        # other ranks then fail with errors of their own
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        distributed.shutdown()


def _run(args, device: torch.device) -> TrainRun:
    np.random.seed(SEED)
    random.seed(SEED)
    if not distributed.is_main():  # no log root, no writer (JAX's _NullWriter)
        return _train(args, device, None, None)

    now = datetime.datetime.now()
    log_root = Path(args.training_result_root) / (
        "depth_estimation_train_run_{}_{}_{}_{}_test_id_{}".format(
            now.month, now.day, now.hour, now.minute,
            "_".join(str(i) for i in args.testing_patient_id)))
    log_root.mkdir(parents=True, exist_ok=True)
    print(f"Logs at {log_root}")
    with contextlib.closing(viz.MetricWriter(log_root)) as writer:
        return _train(args, device, log_root, writer)


def _train(args, device: torch.device, log_root: Optional[Path], writer) -> TrainRun:
    height, width = args.input_size
    world, rank, main = distributed.world(), distributed.rank(), distributed.is_main()
    data_root = Path(args.training_data_root)
    train_files, val_files, _ = readers.get_color_file_names_by_bag(
        data_root, args.training_patient_id, args.validation_patient_id,
        args.testing_patient_id)
    folders = readers.get_parent_folder_names(data_root, args.id_range)
    common = dict(folder_list=folders, adjacent_range=args.adjacent_range,
                  downsampling=args.input_downsampling,
                  network_downsampling=args.network_downsampling,
                  inlier_percentage=args.inlier_percentage,
                  visible_interval=args.visibility_overlap,
                  store_data_root=data_root, is_hsv=args.use_hsv_colorspace,
                  num_pre_workers=args.num_pre_workers, rgb_mode=args.rgb_mode)
    train_dataset = SfMDataset(
        image_file_names=train_files, transform=TrainingAugmentation(seed=SEED),
        use_store_data=args.load_intermediate_data, phase="train",
        num_iter=args.num_iter, **common)  # samples per epoch (reference train.py:51)
    val_dataset = SfMDataset(image_file_names=val_files, transform=None,
                             use_store_data=True, phase="validation", **common)
    partition = dict(process_index=rank, process_count=world)
    train_loader = BatchLoader(train_dataset, args.batch_size, shuffle=True,
                               num_workers=args.num_workers, seed=SEED, **partition)
    val_loader = BatchLoader(val_dataset, args.batch_size, shuffle=False,
                             num_workers=args.num_workers, seed=SEED, drop_last=True,
                             **partition)

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = init_weights(ARCHITECTURES[args.architecture](
        n_classes=1, dtype=dtype, act8=args.act8, remat=args.remat,
        block_engine=args.block_engine), torch.Generator().manual_seed(SEED)).to(device)
    config = training.TrainConfig(
        sfl_weight=args.sfl_weight, dcl_weight=args.dcl_weight,
        max_lr=args.max_lr, min_lr=args.min_lr, lr_step_size=args.num_iter,
        zero_division_epsilon=args.zero_division_epsilon, compute_dtype=dtype)
    state = training.create_train_state(model)
    if args.architecture_summary and main:
        print(model)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{args.architecture}: {n_params:,} parameters, input "
              f"{height}x{width}, dtype {args.compute_dtype}, device {device}")

    start_epoch = 0
    if args.load_trained_model:
        if args.trained_model_path is None or not Path(args.trained_model_path).exists():
            raise OSError("No trained model detected")
        state, start_epoch, _ = ckpt.load_checkpoint(args.trained_model_path, state)
        if main:
            print(f"Restored model, epoch {start_epoch}, step {int(state.step)}, "
                  f"count {int(state.count)}")
    if (args.batch_size // world) % args.grad_accum:
        raise ValueError(f"the batch of each of the {world} process(es), "
                         f"{args.batch_size // world}, must be divisible by "
                         f"--grad_accum {args.grad_accum}")
    if world > 1:
        distributed.broadcast_state(state)
        if main:
            print(f"Data parallel over {world} processes, {args.batch_size // world} "
                  f"rows each")

    mean_sfl = 0.0
    timer = StepTimer()
    checkpoints, losses, profile = [], [], None
    for epoch in range(start_epoch, args.number_epoch + 1):
        train_dataset.seed(SEED + 1 + epoch)
        train_loader.set_epoch(epoch)
        timer.reset_epoch()
        dcl_weight = torch.tensor(training.dcl_weight_for_epoch(epoch, config),
                                  dtype=torch.float32, device=device)

        pending = None  # one-step-delayed metric readback
        means = {}
        count = 0
        traced = args.profile_dir is not None and epoch == start_epoch and main
        with device_trace(args.profile_dir, enabled=traced) as trace:
            for batch_idx, batch in enumerate(device_prefetch(train_loader, device)):
                display = (args.display_interval > 0
                           and batch_idx % args.display_interval == 0)
                state, metrics = training.train_step(
                    state, batch, dcl_weight, config, with_images=display,
                    grad_accum=args.grad_accum)
                if display:
                    if main:  # the board shows rank 0's rows
                        writer.add_image("Training/Images/Results",
                                         _board(batch, metrics, args.use_hsv_colorspace),
                                         int(state.step))
                    metrics = {k: v for k, v in metrics.items() if k not in _IMAGE_KEYS}
                if pending is not None and batch_idx % args.log_interval == 0:
                    vals = {k: float(pending[k]) for k in _LOSS_KEYS}
                    losses.append(vals["loss"])
                    timer.tick()
                    count += 1
                    for k, v in vals.items():
                        means[k] = means.get(k, 0.0) + (v - means.get(k, 0.0)) / count
                    if main:
                        writer.add_scalars("Training", {
                            "overall": means["loss"],
                            "depth_consistency": means["depth_consistency_loss"],
                            "sparse_flow": means["sparse_flow_loss"]}, int(state.step))
                    if batch_idx % 50 == 0 and main:
                        print(f"epoch {epoch} it {batch_idx} "
                              f"loss {vals['loss']:.5f} (avg {means['loss']:.5f}) "
                              f"sfl {vals['sparse_flow_loss']:.5f} "
                              f"dcl {vals['depth_consistency_loss']:.5f}")
                pending = metrics
        if trace:
            profile = trace
            print(f"epoch {epoch} profile: {profile}")
        if pending is not None:
            losses.append(float(pending["loss"]))
            if main:
                print(f"epoch {epoch} final loss {losses[-1]:.5f}")
        summary = timer.summary()
        if summary and main:
            scale = max(1, args.log_interval)  # ticks come once per log_interval steps
            print(f"epoch {epoch} step time: mean {summary['mean_ms']/scale:.1f} ms, "
                  f"p50 {summary['p50_ms']/scale:.1f}, "
                  f"p90 {summary['p90_ms']/scale:.1f}")

        if epoch % args.validation_interval != 0:
            continue

        # validation (reference train.py:378-485)
        val_means = {}
        n = 0
        for batch_idx, batch in enumerate(device_prefetch(val_loader, device)):
            metrics = training.eval_step(state, batch, dcl_weight, config,
                                         with_images=True, use_batch_stats=True)
            n += 1
            for k in _LOSS_KEYS:
                v = float(metrics[k])
                val_means[k] = val_means.get(k, 0.0) + (v - val_means.get(k, 0.0)) / n
            if main and args.display_interval > 0 and batch_idx % args.display_interval == 0:
                writer.add_image("Validation/Images/Results",
                                 _board(batch, metrics, args.use_hsv_colorspace),
                                 int(state.step))
        if val_means and main:
            writer.add_scalars("Validation", {
                "overall": val_means["loss"],
                "depth_consistency": val_means["depth_consistency_loss"],
                "sparse_flow": val_means["sparse_flow_loss"]}, epoch)
        mean_sfl = val_means.get("sparse_flow_loss", mean_sfl)

        if main:
            model_path = log_root / f"checkpoint_model_epoch_{epoch}_validation_{mean_sfl}.pt"
            ckpt.save_checkpoint(model_path, state, epoch + 1, mean_sfl)
            checkpoints.append(model_path)
            writer.export_scalars_to_json(log_root / f"all_scalars_{epoch}.json")
            print(f"epoch {epoch}: validation sfl {mean_sfl:.5f}, saved {model_path}")
        distributed.barrier(f"saved_epoch_{epoch}")

    return TrainRun(log_root=log_root, state=state, checkpoints=checkpoints,
                    losses=losses, step_ms=list(timer.times_ms), profile=profile)


if __name__ == "__main__":
    main()
