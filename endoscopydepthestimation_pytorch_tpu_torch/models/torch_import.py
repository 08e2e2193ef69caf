"""Weights in and out of the port's FCDenseNet and UNet.

The port's module names are the reference's state_dict keys, so a
reference ``checkpoint_model_epoch_*.pt`` (reference utils.py:674-682,
``state['model']`` with DataParallel's ``module.`` prefix) loads as it is.
Weights trained by the JAX package cross over either as such a ``.pt``
(its ``models.torch_import.save_reference_checkpoint``) or, in memory, as
its ``{params, batch_stats}`` numpy trees through ``from_jax_variables``
(FCDenseNet's tree, or UNet's, which has no ``batch_stats``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .unet import UP_MODES


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value))  # a writable, contiguous copy


def _put_conv(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping) -> None:
    sd[f"{prefix}.weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _tensor(node["bias"])


def _unet_state_dict(params: Mapping, up_mode: str) -> Dict[str, torch.Tensor]:
    """UNet's tree, names as they are: HWIO kernels become OIHW; with
    ``up_mode="upconv"`` each ``up{i}_conv`` kernel (kh, kw, in, out),
    which flax does not flip, becomes the flipped (in, out, kh, kw) weight
    of ``nn.ConvTranspose2d`` (``models/unet.py``)."""
    if up_mode not in UP_MODES:
        raise ValueError(f"unknown up_mode {up_mode!r}")
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if "kernel" in node:  # up{i}_conv, last
            _put_conv(sd, name, node)
            if up_mode == "upconv" and name.endswith("_conv"):
                kernel = np.flip(np.asarray(node["kernel"]), (0, 1))
                sd[f"{name}.weight"] = _tensor(kernel.transpose(2, 3, 0, 1))
        else:  # down{i}, up{i}_block: conv0, conv1
            for conv, leaf in node.items():
                _put_conv(sd, f"{name}.{conv}", leaf)
    return sd


def from_jax_variables(params: Mapping, batch_stats: Mapping,
                       down_blocks=(4, 4, 4, 4, 4), up_blocks=(4, 4, 4, 4, 4),
                       bottleneck_layers: int = 4,
                       up_mode: str = "upsample") -> Dict[str, torch.Tensor]:
    """The JAX package's Flax ``params`` / ``batch_stats`` (numpy leaves)
    -> the port's state_dict: HWIO kernels become OIHW, BN {scale, bias,
    mean, var} become {weight, bias, running_mean, running_var,
    num_batches_tracked}. Same keys and values as the JAX package's
    ``export_reference_state_dict(..., module_prefix=False)``.

    A UNet tree (it has ``last``; its ``batch_stats`` is empty) maps name
    for name onto the port's ``UNet``; ``up_mode`` says how its
    ``up{i}_conv`` kernels were used, which their shapes do not tell. The
    FCDenseNet arguments do not apply to it."""
    if "last" in params:
        return _unet_state_dict(params, up_mode)
    sd: Dict[str, torch.Tensor] = {}

    def put_bn(prefix, p_node, s_node):
        sd[f"{prefix}.weight"] = _tensor(p_node["scale"])
        sd[f"{prefix}.bias"] = _tensor(p_node["bias"])
        sd[f"{prefix}.running_mean"] = _tensor(s_node["mean"])
        sd[f"{prefix}.running_var"] = _tensor(s_node["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def dense_block(flax_name, prefix, n_layers):
        for j in range(n_layers):
            p = params[flax_name][f"layers{j}"]
            s = batch_stats[flax_name][f"layers{j}"]
            put_bn(f"{prefix}.layers.{j}.norm", p["norm"], s["norm"])
            _put_conv(sd, f"{prefix}.layers.{j}.conv", p["conv"])

    _put_conv(sd, "firstconv", params["firstconv"])
    for i, n in enumerate(down_blocks):
        dense_block(f"denseBlocksDown{i}", f"denseBlocksDown.{i}", n)
        put_bn(f"transDownBlocks.{i}.norm", params[f"transDownBlocks{i}"]["norm"],
               batch_stats[f"transDownBlocks{i}"]["norm"])
        _put_conv(sd, f"transDownBlocks.{i}.conv", params[f"transDownBlocks{i}"]["conv"])
    dense_block("bottleneck", "bottleneck.bottleneck", bottleneck_layers)
    for i, n in enumerate(up_blocks):
        _put_conv(sd, f"transUpBlocks.{i}.convTrans.1", params[f"transUpBlocks{i}"]["conv"])
        dense_block(f"denseBlocksUp{i}", f"denseBlocksUp.{i}", n)
    _put_conv(sd, "finalConv", params["finalConv"])
    return sd


def load_reference_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Read a reference-format ``.pt`` -> (state_dict without the
    ``module.`` prefix, {epoch, step, validation})."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    has_model = isinstance(state, dict) and "model" in state
    model_sd = {k.removeprefix("module."): v
                for k, v in (state["model"] if has_model else state).items()}
    meta = ({k: state.get(k) for k in ("epoch", "step", "validation")}
            if has_model else {})
    return model_sd, meta


def save_reference_checkpoint(path, model: torch.nn.Module, epoch: int = 0,
                              step: int = 0, validation: float = 0.0) -> None:
    """Write ``model`` as a reference-format ``.pt`` (utils.py:674-682:
    {'model', 'optimizer', 'epoch', 'step', 'validation'}, keys with the
    ``module.`` prefix the reference's own checkpoints carry)."""
    model_sd = {f"module.{k}": v.detach().cpu()
                for k, v in model.state_dict().items()}
    torch.save({"model": model_sd,
                "optimizer": {"state": {}, "param_groups": []},
                "epoch": int(epoch), "step": int(step),
                "validation": float(validation)}, str(path))
