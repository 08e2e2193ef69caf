"""Failure detection and outlier-robust model selection (JAX package
``failure.py``: ``detect_outlier_batches`` :20, ``worst_sample_report``
:33, ``outlier_robust_validation_loss_delta`` :49, ``save_if_best`` :68).

The reference's dormant per-batch failure detector (utils.py:1451-1459),
driven by the per-sample SFL; the non-interactive core of its outlier
visualizer (utils.py:1415-1448); and its outlier-robust comparison of
per-batch validation-loss vectors for best-model selection
(utils.py:1734-1744, 1546-1612). Host-side numpy; the inputs may be
numpy arrays or tensors on any device.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import losses


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def detect_outlier_batches(flows, flows_from_depth, flow_masks,
                           failure_threshold: float) -> Tuple[List[int], np.ndarray]:
    """The indexes of the batch's samples whose per-sample SFL exceeds the
    threshold, and that per-sample SFL (reference utils.py:1451-1459)."""
    per_sample = _numpy(losses.sparse_masked_l1_loss_per_sample(
        _tensor(flows), _tensor(flows_from_depth), _tensor(flow_masks)))
    indexes = [int(j) for j in np.where(per_sample > failure_threshold)[0]]
    return indexes, per_sample


def worst_sample_report(per_sample_losses_1, per_sample_losses_2,
                        folders: Sequence[str]) -> Dict:
    """The worst sample of each frame of a failing batch (reference
    ``outlier_detection``, utils.py:1415-1448, without its windows)."""
    l1 = _numpy(per_sample_losses_1)
    l2 = _numpy(per_sample_losses_2)
    i1, i2 = int(np.argmax(l1)), int(np.argmax(l2))
    return {
        "worst_index_1": i1, "worst_loss_1": float(l1[i1]),
        "worst_index_2": i2, "worst_loss_2": float(l2[i2]),
        "worst_folder_1": folders[i1] if folders else None,
        "worst_folder_2": folders[i2] if folders else None,
    }


def outlier_robust_validation_loss_delta(validation_losses,
                                         previous_validation_losses) -> float:
    """Signed comparison of two per-batch validation-loss vectors; negative
    means the new model is better. Each side's sum is weighted by how many
    batches moved in that direction, which damps single-batch outliers.
    Vectors of unequal length: -1 when the new one is longer, else 1
    (reference utils.py:1734-1744)."""
    new = np.asarray(_numpy(validation_losses), dtype=np.float64)
    old = np.asarray(_numpy(previous_validation_losses), dtype=np.float64)
    if len(new) == len(old):
        diff = new - old
        positive = np.sum(np.sum(np.int32(diff > 0.0)) * (diff > 0.0) * diff)
        negative = np.sum(np.sum(np.int32(diff < 0.0)) * (diff < 0.0) * diff)
        return float(positive + negative)
    if len(new) > len(old):
        return -1.0
    return 1.0


def save_if_best(save_fn, model_root, best_path, epoch_tag: str,
                 validation_losses, best_validation_losses,
                 save_best_only: bool = True):
    """Best-model selection around any checkpoint writer ``save_fn(path)``
    (reference utils.py:1546-1612, its student and teacher savers in one
    policy): always writes ``model_root/checkpoint_model_epoch_<tag>``;
    writes ``best_path`` when the robust comparison says the new vector is
    better, or always when ``save_best_only`` is False. Returns the best
    vector from now on."""
    model_root = Path(model_root)
    save_fn(model_root / f"checkpoint_model_epoch_{epoch_tag}")
    validation_losses = np.asarray(_numpy(validation_losses))
    best_validation_losses = np.asarray(_numpy(best_validation_losses))
    if not save_best_only:
        save_fn(best_path)
        return validation_losses
    if outlier_robust_validation_loss_delta(validation_losses,
                                            best_validation_losses) < 0.0:
        print("Found better model in terms of validation loss: "
              f"{np.mean(validation_losses):.5f}")
        save_fn(best_path)
        return validation_losses
    return best_validation_losses
