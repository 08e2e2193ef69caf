"""The self-supervised train step, validation step and inference step
(JAX package ``training.py``).

One ``train_step`` runs both frames through the model as one stacked 2B
batch (BatchNorm normalizes over both frames jointly), recovers the
scale, computes flow from depth and the bidirectional depth warp, forms
SFL + DCL, and applies clip-by-global-norm(10) and momentum SGD at the
cyclic rate, with the non-finite guard. Nothing in it reads a value back
to the host: every decision that depends on the loss or the gradients is
a ``torch.where`` on the device.

Non-finite handling, as the JAX step (itself the reference's
train.py:317-322, 339) does it with ``optax.apply_if_finite``: on a
non-finite loss the gradients are poisoned to NaN, so params, momentum
and the LR count stay put and ``step`` does not advance; when the loss is
finite but a gradient is not, params, momentum and count stay put but
``step`` advances. The BatchNorm running statistics advance on every step.

The port's state is mutable: ``train_step`` updates the model's
parameters, its running statistics and the optimizer state in place, and
returns the same ``TrainState``.

In a process group (``parallel.distributed``) each rank passes its own
rows of the global batch: BatchNorm normalizes with the global batch's
statistics, the gradients are averaged over the ranks after the backward
in one all-reduce, and the loss and the scalars in another, before the
update, so every rank applies the same update (JAX
``make_shardmap_train_step``, parallel/mesh.py:180-256). ``eval_step``
averages its metrics the same way. At world size 1 neither runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from . import losses, step_graph
from .ops import geometry
from .ops import sgd_update as multi_tensor_sgd
from .parallel import distributed
from .schedule import make_cyclic_schedule
from .utils import profiling


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of the self-supervised objective; the defaults are
    the reference CLI's (train.py:42-57)."""
    sfl_weight: float = 20.0
    dcl_weight: float = 5.0
    dcl_warmup_weight: float = 0.1      # epochs <= dcl_warmup_epochs
    dcl_warmup_epochs: int = 20         # reference train.py:239-242
    max_lr: float = 1.0e-3
    min_lr: float = 1.0e-4
    lr_step_size: int = 1000            # half-cycle = num_iter (train.py:203)
    momentum: float = 0.9
    grad_clip_norm: float = 10.0        # reference train.py:327
    zero_division_epsilon: float = 1.0e-8
    compute_dtype: torch.dtype = torch.float32  # the model's activation dtype
    # (set when the model is built, FCDenseNet(dtype=...); train_step and
    # eval_step refuse a model built with another)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), one momentum
    buffer per parameter, ``count`` (optimizer steps whose gradients were
    all finite: the schedule's clock) and ``step`` (steps with a finite
    loss). ``count`` and ``step`` are int32 tensors on the model's device."""
    model: nn.Module
    momentum: List[torch.Tensor]
    count: torch.Tensor
    step: torch.Tensor

    def __post_init__(self):
        # the parameters in ``momentum``'s order, listed once: a walk of the
        # module tree costs ~0.4 ms of host time a FC-DenseNet-103 step
        self._params = list(self.model.parameters())
        self.graphs = step_graph.StepGraphs()  # the step's CUDA graphs

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self._params)


def create_train_state(model: nn.Module) -> TrainState:
    """Zero momentum, count and step for ``model`` (already initialized,
    on its device)."""
    device = next(model.parameters()).device
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TrainState(model=model,
                      momentum=[torch.zeros_like(p) for p in model.parameters()],
                      count=zero.clone(), step=zero.clone())


def _check_dtype(model: nn.Module, config: TrainConfig) -> None:
    if model.dtype != config.compute_dtype:
        raise ValueError(f"the model computes in {model.dtype}, the config "
                         f"asks for {config.compute_dtype}")


def _views(model: nn.Module, views: int) -> Dict[str, int]:
    """The keyword that tells a network which declares ``views_per_pair``
    (VGGT) how many frames a sample holds; none for any other network."""
    return {"views": views} if hasattr(model, "views_per_pair") else {}


def _forward_pair(model: nn.Module, batch: Dict[str, torch.Tensor],
                  buffers: Dict[str, torch.Tensor] | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward over both frames stacked to (2B, H, W, 3), NHWC in and
    out, in the model's current mode (JAX training.py:91-111). With
    ``buffers`` the model runs on those in place of its own BN running
    statistics. A network that declares ``views_per_pair`` is called with
    ``views=2``: rows i and B + i, frame 1 and frame 2 of pair i, are one
    sequence, view 0 first; any row split that keeps pairs whole
    (``grad_accum``'s microbatches, a rank's rows) keeps its sequences."""
    boundaries = torch.cat([batch["boundary"], batch["boundary"]], 0)
    colors = torch.cat([batch["color_1"], batch["color_2"]], 0) * boundaries
    x = colors.permute(0, 3, 1, 2)  # NCHW in channels_last memory
    views = _views(model, 2)
    depths = (model(x, **views) if buffers is None
              else torch.func.functional_call(model, buffers, (x,), views))
    return depths.permute(0, 2, 3, 1).chunk(2, 0)


def compute_losses(d1, d2, batch, sfl_weight, dcl_weight, epsilon: float):
    """The objective from the two raw depth predictions (JAX
    training.py:114-179): scale recovery, flow from depth against the
    sparse flow (SFL), and the depth warp in both directions, stacked
    into one batch-2B call, against the prediction (DCL)."""
    def stack(a, b):
        return torch.cat([a, b], 0)

    bound2 = stack(batch["boundary"], batch["boundary"])
    k2 = stack(batch["intrinsic"], batch["intrinsic"])
    t_fwd = stack(batch["translation_1_wrt_2"], batch["translation_2_wrt_1"])
    r_fwd = stack(batch["rotation_1_wrt_2"], batch["rotation_2_wrt_1"])

    scaled, stds_vec, scales_vec = geometry.scale_recovery_per_sample(
        stack(d1, d2),
        stack(batch["sparse_depth_1"], batch["sparse_depth_2"]),
        stack(batch["depth_mask_1"], batch["depth_mask_2"]), epsilon)
    scaled_1, scaled_2 = scaled.chunk(2, 0)
    # per-frame diagnostics: each frame's cross-batch std over its own half
    stds_1v, stds_2v = stds_vec.chunk(2, 0)
    scales_1v, scales_2v = scales_vec.chunk(2, 0)
    std_1 = geometry.normalized_scale_std(stds_1v, scales_1v)
    std_2 = geometry.normalized_scale_std(stds_2v, scales_2v)

    flows_from_depth = geometry.flow_from_depth(
        scaled, bound2, t_fwd, r_fwd, k2) * bound2
    flows_from_depth_1, flows_from_depth_2 = flows_from_depth.chunk(2, 0)

    sfl = sfl_weight * losses.sparse_masked_l1_loss(
        stack(batch["flow_1"], batch["flow_2"]) * bound2,
        flows_from_depth,
        stack(batch["flow_mask_1"], batch["flow_mask_2"]) * bound2)

    warped, intersect = geometry.warp_depth(
        scaled, stack(scaled_2, scaled_1), bound2, t_fwd, r_fwd, k2, epsilon)
    warped_2_to_1, warped_1_to_2 = warped.chunk(2, 0)
    intersect_1, intersect_2 = intersect.chunk(2, 0)

    dcl = dcl_weight * losses.normalized_distance_loss(scaled, warped,
                                                       intersect, k2)
    aux = {
        "sparse_flow_loss": sfl,
        "depth_consistency_loss": dcl,
        "scale_std_1": std_1,
        "scale_std_2": std_2,
        "scaled_depth_1": scaled_1,
        "scaled_depth_2": scaled_2,
        "flows_from_depth_1": flows_from_depth_1,
        "flows_from_depth_2": flows_from_depth_2,
        "warped_depth_2_to_1": warped_2_to_1,
        "warped_depth_1_to_2": warped_1_to_2,
        "intersect_masks_1": intersect_1,
        "intersect_masks_2": intersect_2,
    }
    return sfl + dcl, aux


@torch.no_grad()
def sgd_update(state: TrainState, loss: torch.Tensor, grads: List[torch.Tensor],
               config: TrainConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The optimizer of the JAX step (training.py:60-70, 182-211) and of
    its ``distill_step`` (distill.py:60-66): ``optax.apply_if_finite(chain(
    clip_by_global_norm(10), sgd(cyclic schedule, momentum 0.9)))`` behind
    the loss gate. Updates ``state`` in place; returns (isfinite(loss),
    the gradients' global norm).

    - a non-finite loss poisons every gradient to NaN;
    - clip as optax does: g * 10/|g| only when |g| >= 10, as
      ``g / |g| * 10`` (no 1e-6, unlike ``clip_grad_norm_``);
    - b = 0.9*b + g, then p -= lr*b, with lr the schedule at ``count``;
    - unless every gradient is finite, params, momentum and ``count``
      stay put; ``step`` advances by isfinite(loss) regardless.

    On the card one C call of the multi-tensor kernel
    (``ops.sgd_update``), on the CPU its plain loop; nothing is read back.
    """
    lr = make_cyclic_schedule(config.min_lr, config.max_lr,
                              config.lr_step_size)(state.count)
    return multi_tensor_sgd.update(state.params, state.momentum, grads, loss, lr,
                                   state.count, state.step, config.grad_clip_norm,
                                   config.momentum)


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    grads: List[torch.Tensor], scalars: Dict[str, torch.Tensor],
                    config: TrainConfig) -> Dict[str, torch.Tensor]:
    """``sgd_update`` of the train step; returns the step's metrics."""
    finite, grad_norm = sgd_update(state, loss, grads, config)
    return {
        "loss": loss,
        "sparse_flow_loss": scalars["sparse_flow_loss"],
        "depth_consistency_loss": scalars["depth_consistency_loss"],
        "scale_std": 0.5 * (scalars["scale_std_1"] + scalars["scale_std_2"]),
        "finite": finite.to(torch.float32),
        "grad_norm": grad_norm,
    }


_IMAGE_KEYS = ("scaled_depth_1", "flows_from_depth_1",
               "scaled_depth_2", "flows_from_depth_2")
_SCALAR_KEYS = ("sparse_flow_loss", "depth_consistency_loss",
                "scale_std_1", "scale_std_2")


def _all_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar ``values`` averaged over the ranks, in one all-reduce."""
    packed = distributed.all_mean_(torch.stack([v.float() for v in values.values()]))
    return dict(zip(values, packed))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               dcl_weight: torch.Tensor, config: TrainConfig,
               with_images: bool = False, grad_accum: int = 1
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step on ``batch`` (NHWC tensors on the model's
    device, the keys of the JAX batch). ``dcl_weight`` is a tensor, so
    the warmup switch (train.py:239-242) changes no code path.

    ``with_images=True`` also returns both frames' scaled depths and dense
    flows (detached). ``grad_accum=n`` splits the batch into n row-strided
    microbatches (rows m::n), runs forward and backward on each, and
    applies one update on the mean gradient; each microbatch normalizes
    with its own batch statistics, so the running statistics advance n
    times (JAX training.py:231-243). In a process group each rank takes
    rows m::n of its own rows; their union over the ranks is the global
    batch's microbatch m, whose statistics BatchNorm uses.

    On a card a step is captured as one CUDA graph the second time its
    signature comes, and replayed from then on (``step_graph``), unless
    it has ``with_images``, ``grad_accum`` > 1 or a process group.

    Under ``torch.profiler`` the step is a root span with the phases
    ``forward``, ``losses``, ``backward``, ``all_reduce`` (in a process
    group) and ``optimizer`` (``utils.profiling``); a graphed step has the
    one phase ``replay``.
    """
    with profiling.root_span("train_step"):
        return step_graph.run(state, batch, dcl_weight, config, with_images, grad_accum,
                              _train_step)


def _train_step(state, batch, dcl_weight, config, with_images, grad_accum):
    model = state.model
    _check_dtype(model, config)
    model.train()
    params = state.params
    n = grad_accum
    batch_size = batch["color_1"].shape[0]
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by grad_accum {n}")
    grad_sum, loss_sum, scalar_sum, images = None, None, None, []
    for m in range(n):
        mbatch = batch if n == 1 else {k: v[m::n] for k, v in batch.items()}
        with profiling.span("forward"):
            d1, d2 = _forward_pair(model, mbatch)
        with profiling.span("losses"):
            loss, aux = compute_losses(d1, d2, mbatch, config.sfl_weight,
                                       dcl_weight, config.zero_division_epsilon)
        with profiling.span("backward"):
            grads = torch.autograd.grad(loss, params)
        if grad_sum is None:
            grad_sum, loss_sum = list(grads), loss.detach()
            scalar_sum = {k: aux[k].detach() for k in _SCALAR_KEYS}
        else:
            grad_sum = [a + g for a, g in zip(grad_sum, grads)]
            loss_sum = loss_sum + loss.detach()
            scalar_sum = {k: scalar_sum[k] + aux[k].detach() for k in _SCALAR_KEYS}
        if with_images:
            images.append({k: aux[k].detach() for k in _IMAGE_KEYS})
    if n > 1:
        grad_sum = [g * (1.0 / n) for g in grad_sum]
        loss_sum = loss_sum * (1.0 / n)
        scalar_sum = {k: v * (1.0 / n) for k, v in scalar_sum.items()}
    if distributed.group() is not None:
        with profiling.span("all_reduce"):
            grad_sum = distributed.average_gradients(grad_sum)
            scalar_sum = _all_mean({"loss": loss_sum, **scalar_sum})
            loss_sum = scalar_sum.pop("loss")
    with profiling.span("optimizer"):
        metrics = apply_gradients(state, loss_sum, grad_sum, scalar_sum, config)
    if with_images:
        for k in _IMAGE_KEYS:
            # microbatch m holds rows m::n: interleave back to row order
            stacked = torch.stack([im[k] for im in images], 1)
            metrics[k] = stacked.reshape(batch_size, *stacked.shape[2:])
    return state, metrics


def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              dcl_weight: torch.Tensor, config: TrainConfig,
              with_images: bool = False,
              use_batch_stats: bool = False) -> Dict[str, torch.Tensor]:
    """Validation step: the same objective, no gradient. With
    ``use_batch_stats=True`` BatchNorm uses the batch statistics, as the
    reference's training-loop validation does (it never leaves train
    mode, train.py:234, 380); by default the running ones, as its
    evaluate.py does. The running statistics are never written, and the
    model is left in the mode it was in. In a process group the batch
    statistics are the global batch's and the three losses are averaged
    over the ranks (JAX ``make_parallel_eval_step``); images stay the
    rank's own rows."""
    model = state.model
    _check_dtype(model, config)
    was_training = model.training
    try:
        with torch.no_grad():
            model.train(use_batch_stats)
            # a train-mode forward advances the running statistics: give it
            # copies to advance
            buffers = ({k: v.clone() for k, v in model.named_buffers()}
                       if use_batch_stats else None)
            d1, d2 = _forward_pair(model, batch, buffers)
            loss, aux = compute_losses(d1, d2, batch, config.sfl_weight,
                                       dcl_weight, config.zero_division_epsilon)
    finally:
        model.train(was_training)
    metrics = {"loss": loss,
               "sparse_flow_loss": aux["sparse_flow_loss"],
               "depth_consistency_loss": aux["depth_consistency_loss"]}
    if distributed.group() is not None:
        metrics = _all_mean(metrics)
    if with_images:
        metrics.update({k: aux[k] for k in (
            "scaled_depth_1", "scaled_depth_2", "flows_from_depth_1",
            "flows_from_depth_2", "warped_depth_2_to_1", "warped_depth_1_to_2",
            "intersect_masks_1", "intersect_masks_2")})
    return metrics


def predict_step(model: nn.Module, colors: torch.Tensor,
                 boundaries: torch.Tensor) -> torch.Tensor:
    """Depth inference: model(boundary * color) with running BN
    statistics (reference evaluate.py:322-327). colors (B, H, W, 3) and
    boundaries (B, H, W, 1), NHWC as in the JAX package -> depth
    (B, H, W, 1) float32. ``model`` must be in eval mode: a train-mode
    forward would use and advance the batch statistics."""
    if model.training:
        raise ValueError("predict_step needs the model in eval mode "
                         "(model.eval())")
    with torch.inference_mode():
        x = (colors * boundaries).permute(0, 3, 1, 2)  # NCHW, channels_last
        return model(x, **_views(model, 1)).permute(0, 2, 3, 1)  # VGGT: a frame a sequence


def dcl_weight_for_epoch(epoch: int, config: TrainConfig) -> float:
    """DCL warmup (reference train.py:239-242)."""
    return (config.dcl_warmup_weight if epoch <= config.dcl_warmup_epochs
            else config.dcl_weight)
