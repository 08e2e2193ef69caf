#!/usr/bin/env python3
"""Time the bf16 K6 (``block_engine_dweight``) at several ring depths
(``DW_DEPTH``: the stages, tiles whose copies are in flight), on one CUDA
GPU.

    python3 torch_dweight_tuning.py [--depths 2 3]

Each depth builds one copy of ``csrc/block_engine.cu`` with that
``DW_DEPTH`` (text-substituted, nvcc started together, into the
git-ignored ``build/tuning/``) and prints ptxas's registers and spills for
its bf16 K6. Then, at each of FCDenseNet-57's 44 layers at 2B = 16,
256x320, it launches every depth through ``ops.block_engine.layer_dweight``
with its own library and the wrapper's n_split, checks it against the
plain version (mean rel <= 1e-4) and times it alone (CUDA graph replay) in
two rounds, the depths in turns, the order reversed in the second. Prints
the device ms by level and in total for each depth and round.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from endoscopydepthestimation_pytorch_tpu_torch.ops import _build, block_engine


def build_variant(depth: int):
    """The library with DW_DEPTH = depth, and ptxas's report lines of its
    bf16 K6."""
    source = (_build.CSRC / "block_engine.cu").read_text()
    line = re.search(r"constexpr int DW_DEPTH = \d+;", source)
    if line is None:
        raise RuntimeError("no DW_DEPTH in block_engine.cu")
    out = _build.BUILD_DIR.parent / "tuning"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"block_engine_depth{depth}.cu"
    src.write_text(source.replace(line.group(0), f"constexpr int DW_DEPTH = {depth};"))
    lib = out / f"block_engine_depth{depth}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for DW_DEPTH = {depth}:\n{proc.stderr}")
    report, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", line.split("'")[1])[:30]
        elif "dweight_mma" in (name or "") and ("Used" in line or "stack frame" in line):
            report.append(f"  {name}: {line.strip()}")
    return block_engine.bind(ctypes.CDLL(str(lib))), report


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--depths", type=int, nargs="+", default=[2, 3])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_dweight_tuning: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False  # the f32 plain version's conv
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    with ThreadPoolExecutor(len(args.depths)) as pool:
        built = dict(zip(args.depths, pool.map(build_variant, args.depths)))
    for depth, (_, report) in built.items():
        print(f"DW_DEPTH = {depth}:\n" + "\n".join(report))

    batch, height, width = 16, 256, 320
    levels = chip_smoke._levels(height, width)
    ms = {(n, r): dict.fromkeys(levels, 0.0) for n in args.depths for r in range(2)}
    worst = dict.fromkeys(args.depths, 0.0)
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 14)
    library = block_engine._library
    for h, w, c0 in chip_smoke.dense_block_shapes(height, width):
        buf = torch.randn(batch, h, w, c0 + 48, generator=g, device="cuda").bfloat16()
        grad = torch.randn(batch, h, w, c0 + 48, generator=g, device="cuda").bfloat16()
        for j in range(4):
            c, f = c0 + 12 * j, 12
            scale = torch.rand(c, generator=g, device="cuda") + 0.5
            shift = torch.randn(c, generator=g, device="cuda") * 0.3
            c1 = torch.randn(f, generator=g, device="cuda") * 0.1
            c2 = torch.randn(f, generator=g, device="cuda") * 0.1
            ref = block_engine.layer_dweight_reference(grad, buf, c, f, scale, shift, c1, c2)

            def call():
                return block_engine.layer_dweight(grad, buf, c, f, scale, shift, c1, c2)

            for r in range(2):
                for depth in (args.depths if r == 0 else args.depths[::-1]):
                    block_engine._library = lambda lib=built[depth][0]: lib
                    try:
                        got = call()
                        rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
                        worst[depth] = max(worst[depth], rel)
                        ms[(depth, r)][chip_smoke._level(h, height, width)] += \
                            chip_smoke._graph_ms(call)
                    finally:
                        block_engine._library = library
        del buf, grad
    for (depth, r), t in ms.items():
        print(f"timing [{card}] bf16 K6 DW_DEPTH = {depth}, round {r + 1}, 44 layers b16 "
              f"256x320, device ms alone: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" (total {sum(t.values()):.4f})")
    print("mean rel against the plain version: "
          + ", ".join(f"DW_DEPTH = {n}: {v:.3e}" for n, v in worst.items()))
    if max(worst.values()) > 1e-4:
        raise AssertionError("a variant disagrees with the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
