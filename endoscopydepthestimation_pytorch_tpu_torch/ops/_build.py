"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` into a plain-C-interface ``.so`` and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
output lives in ``<checkout>/build/kernels/``, keyed by a hash of the
sources, of every header in ``csrc/`` (``*.cuh``, which a source may
include and nvcc is not given as a source) and of the flags, so a changed
source, header or flag builds anew and an unchanged one is loaded from
disk. ``ptxas``'s register and spill report
(``-Xptxas -v``) is kept beside the library as ``<name>-<key>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the CUDA
    toolkit's standard location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str, sources) -> Path:
    digest = hashlib.sha256()
    for src in [*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        digest.update(src.encode() + b"\0" + (CSRC / src).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, sources) -> Path:
    """Compile ``csrc/<sources>`` into ``build/kernels/<name>-<key>.so``
    unless that file exists. Raises ``RuntimeError`` with nvcc's output
    when the build fails."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def load(name: str, sources) -> ctypes.CDLL:
    """Build if needed, then ``ctypes``-load the library (once per process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name, sources)))
    return _LOADED[name]


def build_report(name: str, sources) -> str:
    """The ``-Xptxas -v`` report of the library's build (registers, shared
    memory and spills per kernel instantiation)."""
    return library_path(name, sources).with_suffix(".log").read_text()
