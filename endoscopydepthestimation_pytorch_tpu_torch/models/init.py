"""Weight initialization (reference utils.py:655-671; JAX package
``models/init.py`` and ``fcdensenet.py:24-27``).

Convolutions get Kaiming-normal(fan_in, relu), i.e. std = sqrt(2/fan_in),
with zero biases; BatchNorm gets weight 1 and bias 0, running mean 0 and
running variance 1. A transposed conv's fan-in is taken over its input
channels, as flax's ``ConvTranspose`` kernel (kh, kw, in, out) takes it:
torch stores that weight as (in, out, kh, kw), where this is its fan-out.
"""
from __future__ import annotations

import torch
from torch import nn


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``model`` in place from ``generator``; returns it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                mode = "fan_out" if isinstance(m, nn.ConvTranspose2d) else "fan_in"
                nn.init.kaiming_normal_(m.weight, mode=mode, nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
    return model
