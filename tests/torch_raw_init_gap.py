#!/usr/bin/env python3
"""How far the trainer's two-process run drifts from one process, from a raw
and from a conditioned start, on the CPU.

    python3 tests/torch_raw_init_gap.py [--seeds 10085 10086]

``test_torch_train_cli.py::test_two_process_cli_matches_single_process``
starts from a conditioned checkpoint (the head's weights x0.1, its bias +3).
For each seed of the trainer's init and for each start (raw, conditioned)
this runs the port's trainer at 64x64 b4 f32 for one step and validation,
as that test does, and prints the final loss of one process, the relative
gap of the two-process run (gloo, 2 rows a rank) to it, and a witness with
no collective: one process from the same start with every weight moved by
one f32 ulp in a random direction. If the raw start's two-process gap is f32
order noise, the witness shows a gap of its size, and both shrink from the
conditioned start. Writes into a temporary directory; prints one JSON line
of the readings last.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
from test_torch_train_cli import _argv, _communicate, _final_loss, _trainer_process  # noqa: E402
from torch_parallel_ranks import free_port  # noqa: E402
from torch_sfm_sequence import write_sequence  # noqa: E402

from endoscopydepthestimation_pytorch_tpu_torch import train, training  # noqa: E402
from endoscopydepthestimation_pytorch_tpu_torch.models import (FCDenseNet57,  # noqa: E402
                                                                 init_weights)
from endoscopydepthestimation_pytorch_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


def start(seed: int, conditioned: bool, ulp: bool) -> FCDenseNet57:
    model = init_weights(FCDenseNet57(), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        if conditioned:
            model.finalConv.weight.mul_(0.1)
            model.finalConv.bias.mul_(0.1).add_(3.0)
        if ulp:
            g = torch.Generator().manual_seed(seed + 1)
            for p in model.parameters():
                away = torch.where(torch.rand(p.shape, generator=g) < 0.5, -1.0, 1.0)
                p.copy_(torch.nextafter(p, p + away * float("inf")))
    return model


def _validation_sfl(root: Path) -> float:
    """The epoch-0 validation SFL at full precision, from the checkpoint's
    name under a result root."""
    (path,) = root.glob("*/checkpoint_model_epoch_0_validation_*.pt")
    return float(path.stem.split("_validation_")[1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[train.SEED, train.SEED + 1])
    seeds = ap.parse_args().seeds
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_sequence(tmp / "data", seed=7)
        load = ()  # the first run writes the precompute, alone
        for seed in seeds:
            for conditioned in (False, True):
                tag = f"{seed}_{'conditioned' if conditioned else 'raw'}"
                argv = {}
                for form in ("start", "ulp"):
                    path = tmp / f"{tag}_{form}.pt"
                    ckpt.save_checkpoint(path, training.create_train_state(
                        start(seed, conditioned, form == "ulp")), 0, 0.0)
                    argv[form] = _argv(tmp / "data", tmp / "unused", "--batch_size", "4",
                                       "--number_epoch", "0", "--load_trained_model",
                                       "--trained_model_path", str(path))
                roots = {k: tmp / f"{tag}_{k}" for k in ("single", "ulp")}
                (code, out, err), = _communicate(
                    [_trainer_process(argv["start"], roots["single"], *load)])
                assert code == 0, err[-3000:]
                load = ("--load_intermediate_data",)
                port = free_port()
                results = _communicate([_trainer_process(argv["ulp"], roots["ulp"], *load)] + [
                    _trainer_process(argv["start"], tmp / f"{tag}_pair_{rank}", *load,
                                     "--coordinator_address", f"127.0.0.1:{port}",
                                     "--num_processes", "2", "--process_id", str(rank))
                    for rank in range(2)])
                assert [c for c, _, _ in results] == [0, 0, 0], \
                    "\n".join(e[-3000:] for _, _, e in results)
                losses = {"single": _final_loss(out), "ulp": _final_loss(results[0][1]),
                          "pair": _final_loss(results[1][1])}
                sfl = {k: _validation_sfl(roots.get(k, tmp / f"{tag}_pair_0")) for k in losses}
                row = {"seed": seed, "start": "conditioned" if conditioned else "raw",
                       "loss": losses, "validation_sfl": sfl}
                for name, v in (("loss", losses), ("validation_sfl", sfl)):
                    for k in ("pair", "ulp"):
                        row[f"{name}_{k}_rel"] = abs(v[k] - v["single"]) / abs(v["single"])
                readings.append(row)
                print(f"seed {seed}, {row['start']} start: step loss (5 decimals) one "
                      f"process {losses['single']}, two processes {losses['pair']} (rel "
                      f"{row['loss_pair_rel']:.3e}), one ulp away {losses['ulp']} (rel "
                      f"{row['loss_ulp_rel']:.3e}); validation SFL after the step one "
                      f"process {sfl['single']!r}, two processes rel "
                      f"{row['validation_sfl_pair_rel']:.3e}, one ulp away rel "
                      f"{row['validation_sfl_ulp_rel']:.3e}", flush=True)
    print(json.dumps({"readings": readings}))


if __name__ == "__main__":
    main()
