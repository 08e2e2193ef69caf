#!/usr/bin/env python3
"""Serving forward latency of the PyTorch port in this checkout, on one CUDA GPU.

    python3 torch_forward_latency.py [--label NAME]

Imports ``chip_smoke`` and the port package that sit beside this file,
builds FCDenseNet-57 from seed 0 as ``chip_smoke.py`` does, and prints one
JSON line: the label, the card's name and power limit, and the bf16
``predict_step`` ms (``chip_smoke.forward_ms``: CUDA events over 10
back-to-back forwards after 3 warm-ups) at batch 8 256x320, batch 1 256x320
and batch 1 512x576. The host's speed differs between machines, so compare
two checkouts on one card, in turns (A, B, B, A): copy this file into the
other checkout and run each copy from its own tree. Exits 2 without a CUDA
device.
"""
import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = Path(tmp) / "seeded_fcdensenet57.pt"
        chip_smoke.save_reference_checkpoint(checkpoint, chip_smoke.seeded_model(chip_smoke.SEED))
        for key, (b, h, w) in {"b8_256x320": (8, 256, 320), "b1_256x320": (1, 256, 320),
                               "b1_512x576": (1, 512, 576)}.items():
            with contextlib.redirect_stdout(io.StringIO()):
                ms[key] = chip_smoke.forward_ms(checkpoint, card, h, w, b)
    print(json.dumps({"label": args.label or str(root), "card": card, "forward_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
