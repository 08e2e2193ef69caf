"""Checkpoint loading for the port (JAX package ``utils/checkpoint.py``,
``load_any_checkpoint`` :84-96).

The port reads reference-format ``.pt`` files only. The JAX package's own
checkpoints are orbax directories; that package converts them with its
``models.torch_import.save_reference_checkpoint`` (or
``utils.checkpoint.export_torch_checkpoint``), and the resulting ``.pt``
loads here.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

from torch import nn

from ..models.torch_import import load_reference_checkpoint


def load_any_checkpoint(path, model: nn.Module) -> Tuple[nn.Module, int, float]:
    """Load a reference-format ``.pt`` into ``model`` (``strict=True``).

    Returns (model, epoch, validation loss)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); "
            "the port reads reference-format .pt files: convert it with the "
            "JAX package's models.torch_import.save_reference_checkpoint")
    state_dict, meta = load_reference_checkpoint(path)
    model.load_state_dict(state_dict, strict=True)
    return model, int(meta.get("epoch") or 0), float(meta.get("validation") or 0.0)
