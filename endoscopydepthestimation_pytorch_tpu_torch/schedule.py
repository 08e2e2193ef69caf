"""Cyclic learning rate as a function of the step (JAX package
``schedule.py``, itself the reference's ``CyclicLR``, scheduler.py:16-161).

A plain function of a step tensor, so the train step reads the rate on the
device without a host round trip. All three published policies
(triangular, triangular2, exp_range).
"""
from __future__ import annotations

import torch


def cyclic_lr(step, base_lr: float, max_lr: float, step_size: int,
              mode: str = "triangular", gamma: float = 1.0) -> torch.Tensor:
    """Triangle wave between base_lr and max_lr with half-cycle
    ``step_size``, in float32:

        cycle = floor(1 + step / (2 * step_size))
        x     = |step/step_size - 2*cycle + 1|
        lr    = base_lr + (max_lr - base_lr) * max(0, 1 - x) * scale
    """
    step = torch.as_tensor(step).to(torch.float32)
    step_size_f = float(step_size)
    cycle = torch.floor(1.0 + step / (2.0 * step_size_f))
    x = torch.abs(step / step_size_f - 2.0 * cycle + 1.0)
    base_height = (max_lr - base_lr) * torch.clamp(1.0 - x, min=0.0)
    if mode == "triangular":
        scale = 1.0
    elif mode == "triangular2":
        scale = 1.0 / (2.0 ** (cycle - 1.0))
    elif mode == "exp_range":
        scale = torch.pow(torch.tensor(gamma, dtype=torch.float32), step)
    else:
        raise ValueError(f"unknown cyclic mode {mode!r}")
    return base_lr + base_height * scale


def make_cyclic_schedule(base_lr: float, max_lr: float, step_size: int,
                         mode: str = "triangular", gamma: float = 1.0):
    """``schedule(count) -> lr``, the count of finite optimizer steps."""
    def schedule(count):
        return cyclic_lr(count, base_lr, max_lr, step_size, mode, gamma)
    return schedule
