"""Weight initialization (reference utils.py:655-671; JAX package
``models/init.py`` and ``fcdensenet.py:24-27``).

Convolutions get Kaiming-normal(fan_in, relu), i.e. std = sqrt(2/fan_in),
with zero biases; BatchNorm gets weight 1 and bias 0, running mean 0 and
running variance 1. A transposed conv's fan-in is taken over its input
channels, as flax's ``ConvTranspose`` kernel (kh, kw, in, out) takes it:
torch stores that weight as (in, out, kh, kw), where this is its fan-out.

The transformer's parts follow DINOv2's ``init_weights_vit_timm`` and
``init_weights`` (Depth Anything V2's ``dinov2.py``): Linear weights
truncated normal with std 0.02 (cut at +-2), zero biases; LayerNorm
weight 1 and bias 0; LayerScale at its ``init_values``; the position
embedding truncated normal 0.02 and the class token normal with std 1e-6.
DINOv2's register tokens and VGGT's camera and register tokens are normal
with std 1e-6 (``aggregator.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from .depth_anything import DinoVisionTransformer, LayerScale
from .vggt import Aggregator


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
            elif isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_values)
            elif isinstance(m, DinoVisionTransformer):
                nn.init.trunc_normal_(m.pos_embed, std=0.02, generator=generator)
                nn.init.normal_(m.cls_token, std=1e-6, generator=generator)
                if hasattr(m, "register_tokens"):
                    nn.init.normal_(m.register_tokens, std=1e-6, generator=generator)
            elif isinstance(m, Aggregator):
                nn.init.normal_(m.camera_token, std=1e-6, generator=generator)
                nn.init.normal_(m.register_token, std=1e-6, generator=generator)
    return model
