"""Teacher-student distillation (JAX package ``distill.py``:
``distill_loss`` :23, ``distill_step`` :43).

The paper's full method warm-starts a student network from a teacher
with a scale-invariant log loss; the reference keeps the machinery in
utils.py:1462-1482 (``learn_from_teacher``) and its best-model selection
in utils.py:1546-1612 (``failure.save_if_best``). One step: the teacher's
eval-mode forward without gradient (K1 at every dense layer), the
student's train-mode forward and backward over both frames stacked (the
block engine, K4/K5/K6, with BatchNorm over the 2B batch as in the train
step), and the train step's clipped momentum SGD. There is no CLI, as in
JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from . import losses, training


def _nhwc_pair(depths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return depths.permute(0, 2, 3, 1).chunk(2, 0)


def distill_loss(student: nn.Module, teacher: nn.Module, colors_1: torch.Tensor,
                 colors_2: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """0.5 * (SI(student_1, teacher_1) + SI(student_2, teacher_2)) on NHWC
    colors and boundaries (reference utils.py:1462-1482): the teacher's
    depth, in eval mode and detached, is the goal; both depths pass
    through abs. The student runs in the mode it is in; the teacher is
    left in the mode it was in."""
    bound2 = torch.cat([boundaries, boundaries], 0)
    x = (torch.cat([colors_1, colors_2], 0) * bound2).permute(0, 3, 1, 2)
    was_training = teacher.training
    try:
        teacher.eval()
        with torch.no_grad():
            g1, g2 = _nhwc_pair(teacher(x).abs())
    finally:
        teacher.train(was_training)
    p1, p2 = _nhwc_pair(student(x).abs())
    return 0.5 * (losses.scale_invariant_loss(p1, g1, boundaries) +
                  losses.scale_invariant_loss(p2, g2, boundaries))


def distill_step(student: training.TrainState, teacher: training.TrainState,
                 batch: Dict[str, torch.Tensor], config: training.TrainConfig
                 ) -> Tuple[training.TrainState, Dict[str, torch.Tensor]]:
    """One student update toward the frozen teacher's depth. The student's
    BN running statistics advance once; the teacher's never move. On a
    non-finite loss the gradients turn NaN, so the parameters, momentum
    and ``count`` stay put and ``step`` does not advance (JAX :66-71,
    ``training.sgd_update``). Updates ``student`` in place."""
    model = student.model
    training._check_dtype(model, config)
    model.train()
    loss = distill_loss(model, teacher.model, batch["color_1"], batch["color_2"],
                        batch["boundary"])
    grads = torch.autograd.grad(loss, student.params)
    finite, _ = training.sgd_update(student, loss.detach(), list(grads), config)
    return student, {"loss": loss.detach(), "finite": finite.to(torch.float32)}
