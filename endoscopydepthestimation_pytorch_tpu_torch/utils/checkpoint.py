"""Checkpoints of the port (JAX package ``utils/checkpoint.py``:
``save_checkpoint`` :30, ``load_checkpoint`` :44, ``load_any_checkpoint``
:84).

The port writes and reads reference-format ``.pt`` files (reference
utils.py:674-682): ``model`` (the state_dict with DataParallel's
``module.`` prefix), ``optimizer``, ``epoch``, ``step`` and
``validation``. ``optimizer`` has the layout of a torch SGD state_dict:
``state`` holds each parameter's ``momentum_buffer`` by its position in
``model.parameters()``, and the one param group holds the parameter
positions and ``count``, the schedule's clock (optimizer steps whose
gradients were all finite). A resume restores the model, the
momentum, ``count`` and ``step`` exactly. The JAX package's
``load_any_checkpoint`` reads the same file (weights and step).

The JAX package's own checkpoints are orbax directories; that package
converts them with its ``models.torch_import.save_reference_checkpoint``
(or ``utils.checkpoint.export_torch_checkpoint``), and the resulting
``.pt`` loads here.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch
from torch import nn

from ..models.torch_import import load_reference_checkpoint


def save_checkpoint(path, state, epoch: int, validation_loss: float) -> None:
    """Write ``state`` (a ``training.TrainState``) to ``path`` as a
    reference-format ``.pt`` with its optimizer state."""
    model_sd = {f"module.{k}": v.detach().cpu()
                for k, v in state.model.state_dict().items()}
    optimizer = {
        "state": {i: {"momentum_buffer": b.detach().cpu()}
                  for i, b in enumerate(state.momentum)},
        "param_groups": [{"params": list(range(len(state.momentum))),
                          "count": int(state.count)}],
    }
    torch.save({"model": model_sd, "optimizer": optimizer, "epoch": int(epoch),
                "step": int(state.step), "validation": float(validation_loss)},
               str(path))


def load_checkpoint(path, state) -> Tuple[object, int, float]:
    """Restore ``path`` into ``state`` in place: the model (``strict``),
    and, where the file has them, the momentum buffers and ``count``;
    ``step`` from the file. A reference ``.pt`` without optimizer state
    (the reference's own, or the JAX package's export) leaves the momentum
    at zero and ``count`` at 0. Returns (state, epoch, validation loss)."""
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    state.model.load_state_dict({k.removeprefix("module."): v
                                 for k, v in raw["model"].items()}, strict=True)
    groups = raw.get("optimizer", {}).get("param_groups", [])
    if groups and "count" in groups[0]:
        saved = raw["optimizer"]["state"]
        if len(saved) != len(state.momentum):
            raise ValueError(f"{path} holds {len(saved)} momentum buffers, the "
                             f"model has {len(state.momentum)} parameters")
        with torch.no_grad():
            for i, b in enumerate(state.momentum):
                b.copy_(saved[i]["momentum_buffer"])
        count = int(groups[0]["count"])
    else:
        with torch.no_grad():
            for b in state.momentum:
                b.zero_()
        count = 0
    state.count.fill_(count)
    state.step.fill_(int(raw.get("step") or 0))
    return state, int(raw.get("epoch") or 0), float(raw.get("validation") or 0.0)


def load_any_checkpoint(path, model: nn.Module) -> Tuple[nn.Module, int, float]:
    """Load a reference-format ``.pt``'s weights into ``model``
    (``strict=True``). Returns (model, epoch, validation loss)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); "
            "the port reads reference-format .pt files: convert it with the "
            "JAX package's models.torch_import.save_reference_checkpoint")
    state_dict, meta = load_reference_checkpoint(path)
    model.load_state_dict(state_dict, strict=True)
    return model, int(meta.get("epoch") or 0), float(meta.get("validation") or 0.0)
