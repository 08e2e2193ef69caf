"""Build the serving host and the op library it loads, against libtorch.

``csrc/dense_conv_op.cpp`` (``endodepth::fused_dense_conv`` registered in
C++) becomes the op library and ``csrc/serve_host.cpp`` the host binary.
Unlike ``_build``'s kernel libraries these include PyTorch's headers, so
g++ compiles them with torch's include and library paths, its C++ ABI and
an rpath to ``torch/lib`` (the host runs with no ``LD_LIBRARY_PATH``).
Where torch has CUDA, both are built with ``-DENDODEPTH_CUDA``, and the op
library links in ``csrc/dense_conv.cu`` (K1), compiled to an object by
nvcc with ``_build``'s flags and the static CUDA runtime, as the kernel
library is; otherwise they are CPU-only. Outputs go to
``<checkout>/build/libtorch/<name>-<key>``, keyed by a hash of the
sources, every ``csrc/*.cuh``, the flags and torch's version, written under
a temporary name and renamed. A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import _build

BUILD_DIR = _build.PACKAGE_DIR.parent / "build" / "libtorch"
# g++ on the PATH, as the rasterizer's build uses: this module's builds and
# an AOTInductor bundle's compile (which would otherwise take $CXX)
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")


def with_cuda() -> bool:
    """Whether this torch has CUDA, and the builds a CUDA implementation."""
    return torch.version.cuda is not None


def _cuda_home() -> Path:
    return Path(_build.nvcc_path()).resolve().parents[1]


def _compile_flags() -> list:
    from torch.utils import cpp_extension
    flags = [*CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             *(f"-I{p}" for p in cpp_extension.include_paths())]
    if with_cuda():
        flags += ["-DENDODEPTH_CUDA", f"-I{_cuda_home() / 'include'}"]
    return flags


def _link_flags() -> list:
    from torch.utils import cpp_extension
    libs = cpp_extension.library_paths()
    flags = [*(f"-L{p}" for p in libs), *(f"-Wl,-rpath,{p}" for p in libs),
             "-Wl,--no-as-needed", "-lc10", "-ltorch_cpu", "-ltorch"]
    if with_cuda():
        flags += ["-lc10_cuda", "-ltorch_cuda"]
    return flags


def _nvcc_flags() -> list:
    return [f for f in _build.NVCC_FLAGS if f != "-shared"] + ["-c"]


def _output(name: str, sources, suffix: str) -> Path:
    digest = hashlib.sha256()
    for path in [*sources, *sorted(_build.CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    for flags in (_compile_flags(), _link_flags(), _nvcc_flags() if with_cuda() else []):
        digest.update(" ".join(flags).encode() + b"\0")
    digest.update(torch.__version__.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{suffix}"


def _run(cmd) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def _tmp(out: Path, suffix: str = ".tmp") -> Path:
    return out.parent / f"{out.name}.{os.getpid()}.{threading.get_ident()}{suffix}"


def op_library() -> Path:
    """Build ``build/libtorch/dense_conv_op-<key>.so`` unless it exists;
    return its path."""
    op_src = _build.CSRC / "dense_conv_op.cpp"
    kernel_src = _build.CSRC / "dense_conv.cu"
    out = _output("dense_conv_op", [op_src, kernel_src] if with_cuda() else [op_src], ".so")
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    op_obj, kernel_obj, tmp = _tmp(out, ".op.o"), _tmp(out, ".k1.o"), _tmp(out)
    jobs = [[CXX, *_compile_flags(), "-c", "-o", str(op_obj), str(op_src)]]
    link = [CXX, "-shared", "-o", str(tmp), str(op_obj)]
    if with_cuda():
        jobs.append([_build.nvcc_path(), *_nvcc_flags(), "-o", str(kernel_obj),
                     str(kernel_src)])
        link += [str(kernel_obj), f"-L{_cuda_home() / 'lib64'}", "-lcudart_static",
                 "-ldl", "-lrt", "-lpthread"]
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            for job in [pool.submit(_run, cmd) for cmd in jobs]:
                job.result()
        _run(link + _link_flags())
        os.replace(tmp, out)
    finally:
        for path in (op_obj, kernel_obj, tmp):
            path.unlink(missing_ok=True)
    return out


def host_binary() -> Path:
    """Build ``build/libtorch/serve_host-<key>`` unless it exists; return
    its path."""
    src = _build.CSRC / "serve_host.cpp"
    out = _output("serve_host", [src], "")
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(out)
    try:
        _run([CXX, *_compile_flags(), "-o", str(tmp), str(src), *_link_flags(), "-ldl"])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
