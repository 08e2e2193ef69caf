"""The native (C++) host rasterizer (JAX package ``data/native.py``
:27-117 over ``native/rasterizer.cpp``).

``csrc/rasterizer.cpp`` is compiled with ``g++ -O3 -fPIC -shared`` at
first use into ``<checkout>/build/native/rasterizer-<key>.so``, keyed by
a hash of the source and the flags, written under a temporary name and
renamed, so a concurrent build never loads a torn file. A failed build
raises: the port has no silent numpy fallback. ``rasterize_pair_native``
has the signature and returns of ``rasterizer.rasterize_pair``, its plain
version, and agrees with it bit for bit. ctypes releases the GIL for the
call, so loader threads rasterize in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "rasterizer.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")

LAUNCHES = 0  # calls of the native kernel, counted under _lock
_lock = threading.Lock()
_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = [_D, ctypes.c_int64, _D, _D, _D, _D, _F, _F, _F, ctypes.c_int,
             ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
             _F, _F, _F, _F]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"rasterizer-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists. Raises ``RuntimeError`` with
    g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rasterize_pair.restype = None
            lib.rasterize_pair.argtypes = _ARGTYPES
            _lib = lib
    return _lib


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def rasterize_pair_native(pair_extrinsics, pair_projections, pair_indexes,
                          point_cloud, mask_boundary, view_indexes_per_point,
                          clean_point_list, visible_view_indexes: List[int]):
    """``rasterizer.rasterize_pair`` in C++: (depth_masks, sparse_depths,
    flow_masks, flows), (2, H, W, 1) x 3 and (2, H, W, 2), float32."""
    global LAUNCHES
    lib = _library()
    points = _f64(np.asarray(point_cloud).reshape(-1, 4))
    n = points.shape[0]
    height, width = mask_boundary.shape[:2]
    col_1 = visible_view_indexes.index(pair_indexes[0])
    col_2 = visible_view_indexes.index(pair_indexes[1])
    vis_1 = _f32(view_indexes_per_point[:, col_1])
    vis_2 = _f32(view_indexes_per_point[:, col_2])
    if vis_1.shape != (n,):
        raise ValueError(f"visibility of {vis_1.shape[0]} points for {n} points")
    clean = _f32(clean_point_list)
    has_clean = 1 if clean.size else 0
    if has_clean and clean.shape != (n,):
        raise ValueError(f"clean_point_list of {clean.size} points for {n} points")
    if not has_clean:
        clean = np.zeros(1, np.float32)
    mask = np.ascontiguousarray(mask_boundary, dtype=np.uint8)
    matrices = [_f64(m) for m in (pair_projections[0], pair_extrinsics[0],
                                  pair_projections[1], pair_extrinsics[1])]
    if [m.shape for m in matrices] != [(3, 4), (4, 4)] * 2:
        raise ValueError(f"projection/extrinsic shapes {[m.shape for m in matrices]}")

    depth_mask = np.zeros((2, height, width), np.float32)
    depth = np.zeros((2, height, width), np.float32)
    flow_mask = np.zeros((2, height, width), np.float32)
    flow = np.zeros((2, height, width, 2), np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.rasterize_pair(
        ptr(points, ctypes.c_double), n,
        *(ptr(m, ctypes.c_double) for m in matrices),
        ptr(vis_1, ctypes.c_float), ptr(vis_2, ctypes.c_float),
        ptr(clean, ctypes.c_float), has_clean,
        ptr(mask, ctypes.c_uint8), height, width,
        ptr(depth_mask, ctypes.c_float), ptr(depth, ctypes.c_float),
        ptr(flow_mask, ctypes.c_float), ptr(flow, ctypes.c_float))
    with _lock:
        LAUNCHES += 1
    return (depth_mask[..., None], depth[..., None],
            flow_mask[..., None], flow)
