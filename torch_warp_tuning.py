#!/usr/bin/env python3
"""Time K3 (``warp_sample_bwd``, the warp sampler's backward) in variants
of its scatter kernel, on one CUDA GPU.

    python3 torch_warp_tuning.py

Each variant is a text-substituted copy of ``csrc/warp_sample.cu``, built
by nvcc (all started together) into the git-ignored ``build/tuning/``:
the shipped source; no tile summed in shared memory (every contribution a
global atomic: the design without the window); tiles of 8x32 and 32x64
queries; a 3072-entry window with 6 CTAs an SM; 4 CTAs an SM (the
registers free); g loaded with the coordinates, before the CTA's first
barrier; a flat scatter (one query a thread, no shared memory, global
atomics), alone and with a warp merge of neighbouring queries' shared
texels; and, as diagnostics whose dimg is wrong, the tiled and the flat
scatter with their atomics removed (the cost of their loads and stores
alone). ptxas's registers for each scatter kernel are printed. At the
train step's image (16, 256, 320, 2) f32, each variant's dimg is checked
against the twin ``_backward_plain`` bit for bit (the diagnostics
excepted) and timed alone (CUDA graph replay): grad-first and full at a
smooth warp, and grad-first at a random warp. Two rounds, the variants in
turns, the order reversed in the second. Then the shipped K3's device
time by launch (torch.profiler).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from endoscopydepthestimation_pytorch_tpu_torch.ops import _build, warp_sample

ATOMICS = """        if (in_window)
          atomicAdd(window + ((yi - lo_y) * bw + xi - lo_x) * CG + c,
                    (unsigned long long)q);
        else
          atomicAdd(acc + at, (unsigned long long)q);"""
COORDS = "    y[r] = live ? py[base + (long long)qy * Wq + qx] : 0.f;\n"
G_LOAD = "    float gq[CS];\n    load_texel<CS>(g + i * CS, gq);"
LAUNCH = """  warp_sample_bwd_kernel<CG, CS><<<tiles, NT, 0, s>>>(
      img, px, py, g, dpx, dpy, acc, marks, max_bits, tiles_fit, H, W, Hq, Wq,
      h);"""
# A flat scatter: one query a thread, no shared memory, each tap's sum added
# by a global atomic; with MERGE, a lane's taps 01 and 11 first take its
# right neighbour's taps 00 and 10 where they fall on the same texels
# (warp shuffles), which halves the atomics of a smooth warp.
FLAT = r"""
template <int CG, int CS, bool MERGE>
__global__ void __launch_bounds__(NT) flat_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ g,
    float* __restrict__ dpx, float* __restrict__ dpy,
    unsigned long long* __restrict__ acc, unsigned char* __restrict__ marks,
    const unsigned* __restrict__ max_bits, int B, int H, int W, long long Q,
    int h) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  const bool live = i < (long long)B * Q;
  const size_t texel0 = live ? (size_t)(i / Q) * H * W : 0;
  const Taps t = taps_of(live ? px[i] : -4.f, live ? py[i] : -4.f, H, W);
  float v[4][CG], gq[CS];
  gather<CG>(img + texel0 * CS, t, W, CS, v);
  #pragma unroll
  for (int c = 0; c < CS; ++c) gq[c] = 0.f;
  if (live) load_texel<CS>(g + i * CS, gq);
  float gx = 0.f, gy = 0.f;
  #pragma unroll
  for (int c = 0; c < CG; ++c) {
    gx += gq[c] * ((1.f - t.wy) * (v[1][c] - v[0][c]) + t.wy * (v[3][c] - v[2][c]));
    gy += gq[c] * ((1.f - t.wx) * (v[2][c] - v[0][c]) + t.wx * (v[3][c] - v[1][c]));
  }
  if (live) {
    dpx[i] = gx;
    dpy[i] = gy;
  }
  const double scale = pow2(fixed_shift(max_bits, h));
  const bool valid[4] = {t.vy0 && t.vx0, t.vy0 && t.vx1, t.vy1 && t.vx0, t.vy1 && t.vx1};
  long long q[4][CG], at[4];
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ky = k >> 1, kx = k & 1;
    at[k] = valid[k] ? (long long)(texel0 + (size_t)(t.y0 + ky) * W + t.x0 + kx) : -1 - k;
    const float wr = ky ? t.wy : 1.f - t.wy, wc = kx ? t.wx : 1.f - t.wx;
    #pragma unroll
    for (int c = 0; c < CG; ++c) {
      const float d = __fmul_rn(__fmul_rn(gq[c], wr), wc);
      q[k][c] = 0;
      if (!valid[k]) continue;
      if (!isfinite(d)) marks[at[k] * CG + c] = 1;
      else q[k][c] = __double2ll_rn(__dmul_rn((double)d, scale));
    }
  }
  bool skip0 = false, skip2 = false;
  if constexpr (MERGE) {
    const int lane = threadIdx.x & 31;
    const bool take0 = __shfl_down_sync(~0u, at[0], 1) == at[1] && lane < 31;
    const bool take2 = __shfl_down_sync(~0u, at[2], 1) == at[3] && lane < 31;
    #pragma unroll
    for (int c = 0; c < CG; ++c) {
      const long long q0 = __shfl_down_sync(~0u, q[0][c], 1);
      const long long q2 = __shfl_down_sync(~0u, q[2][c], 1);
      if (take0) q[1][c] += q0;
      if (take2) q[3][c] += q2;
    }
    skip0 = __shfl_up_sync(~0u, take0, 1) && lane > 0;
    skip2 = __shfl_up_sync(~0u, take2, 1) && lane > 0;
  }
  #pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((k == 0 && skip0) || (k == 2 && skip2)) continue;
    #pragma unroll
    for (int c = 0; c < CG; ++c)
      if (q[k][c]) atomicAdd(acc + at[k] * CG + c, (unsigned long long)q[k][c]);
  }
}

// K3 step 4:"""


def flat(source: str, merge: bool) -> str:
    return source.replace("// K3 step 4:", FLAT, 1).replace(LAUNCH, f"""\
  flat_bwd_kernel<CG, CS, {str(merge).lower()}><<<blocks_for((long long)B * Q), NT, 0, s>>>(
      img, px, py, g, dpx, dpy, acc, marks, max_bits, B, H, W, Q, h);""")


def variants(source: str) -> dict:
    """name -> (source, whether its dimg must equal the twin's)."""
    g_early = source.replace(
        "  float x[ROWS], y[ROWS];", "  float x[ROWS], y[ROWS], g_early[ROWS][CS];").replace(
        COORDS, COORDS + "    for (int c = 0; c < CS; ++c) g_early[r][c] = 0.f;\n"
        "    if (live) load_texel<CS>(g + (base + (long long)qy * Wq + qx) * CS, g_early[r]);\n"
        ).replace(G_LOAD, "    const float (&gq)[CS] = g_early[r];")
    out = {
        "shipped": (source, True),
        "no window": (source.replace("* CG <= WINDOW;", "* CG <= 0;"), True),
        "tile 8x32": (source.replace("TILE_H = 16, TILE_W = 64", "TILE_H = 8, TILE_W = 32"), True),
        "tile 32x64": (source.replace("TILE_H = 16, TILE_W = 64", "TILE_H = 32, TILE_W = 64"), True),
        "window 3072, 6 CTAs/SM": (source.replace("WINDOW = 5120", "WINDOW = 3072").replace(
            "BWD_CTAS = 5", "BWD_CTAS = 6"), True),
        "4 CTAs/SM": (source.replace("BWD_CTAS = 5", "BWD_CTAS = 4"), True),
        "g with the coordinates": (g_early, True),
        "no atomics (diagnostic)": (source.replace(ATOMICS, "        if (q == 1) marks[at] = 2;"),
                                    False),
        "flat": (flat(source, False), True),
        "flat, warp merge": (flat(source, True), True),
        "flat, no atomics (diagnostic)": (flat(source, True).replace(
            "      if (q[k][c]) atomicAdd(acc + at[k] * CG + c, (unsigned long long)q[k][c]);",
            "      if (q[k][c] == 1) marks[at[k]] = 2;"), False),
    }
    for name, (text, _) in out.items():
        if name != "shipped" and text == source:
            raise RuntimeError(f"variant {name!r} found nothing to substitute")
    return out


def build_variant(item):
    """The bound library of one variant, and its scatter kernels' registers."""
    index, (name, (text, _)) = item
    out = _build.BUILD_DIR.parent / "tuning"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"warp_sample_{index}.cu", out / f"warp_sample_{index}.so"
    src.write_text(text)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    registers, kernel = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif re.search(r"(warp_sample|flat)_bwd_kernel", kernel) and "Used" in line:
            cg_cs = re.search(r"ILi(\d)ELi(\d)E", kernel).groups()
            registers.append(f"CG {cg_cs[0]} CS {cg_cs[1]}: {line.split('Used')[1].split(',')[0]}")
    return warp_sample.bind(ctypes.CDLL(str(lib))), registers


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_warp_tuning: needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    table = variants((_build.CSRC / "warp_sample.cu").read_text())
    with ThreadPoolExecutor(len(table)) as pool:
        built = dict(zip(table, pool.map(build_variant, enumerate(table.items()))))
    for name, (_, registers) in built.items():
        print(f"{name}: " + "; ".join(registers))

    b, h, w = 16, 256, 320
    g = torch.Generator().manual_seed(chip_smoke.SEED + 10)
    image = torch.randn(b, h, w, 2, generator=g).cuda()
    cot = torch.randn(b, h, w, 2, generator=g).cuda()
    rx = (torch.rand(b, h, w, generator=g) * (w + 6) - 3).clamp(-2, w + 1).cuda()
    ry = (torch.rand(b, h, w, generator=g) * (h + 6) - 3).clamp(-2, h + 1).cuda()
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    sx = (xx + 2 * torch.sin(yy / 17) + 0.3).expand(b, h, w).contiguous().cuda()
    sy = (yy + 2 * torch.cos(xx / 23) - 0.2).expand(b, h, w).contiguous().cuda()
    cases = {"grad-first": (sx, sy, 1), "full": (sx, sy, 2), "random warp": (rx, ry, 1)}
    twins = {k: warp_sample._backward_plain(image, x, y, cot, cg)[0]
             for k, (x, y, cg) in cases.items()}
    library = warp_sample._library
    try:
        for rnd, names in enumerate((list(built), list(built)[::-1])):
            for name in names:
                warp_sample._library = lambda lib=built[name][0]: lib
                same = all(torch.equal(warp_sample._backward(image, x, y, cot, cg)[0],
                                       twins[k]) for k, (x, y, cg) in cases.items())
                if table[name][1] and not same:
                    raise AssertionError(f"{name}: dimg differs from the twin's bits")
                ms = {k: chip_smoke._graph_ms(
                    lambda x=x, y=y, cg=cg: warp_sample._backward(image, x, y, cot, cg))
                    for k, (x, y, cg) in cases.items()}
                print(f"round {rnd} [{card}] {name}: K3 alone ms "
                      + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                      + f"; dimg = the twin's bits: {same}")
    finally:
        warp_sample._library = library
    launches = chip_smoke._device_launches(
        lambda: warp_sample._backward(image, sx, sy, cot, 1))
    print(f"[{card}] shipped K3, grad-first, smooth warp, device us by launch: "
          + ", ".join(f"{n} {us:.2f}" for n, us in launches))
    return 0


if __name__ == "__main__":
    sys.exit(main())
