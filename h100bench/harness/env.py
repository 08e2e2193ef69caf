"""The run's surroundings: where caches go, what the machine is, and the
check that nothing of JAX was loaded."""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Iterable, List

from .registry import ROOT

# Compared by the whole top-level name (the part before the first dot):
# the port, endoscopydepthestimation_pytorch_tpu_torch, passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "endoscopydepthestimation_pytorch_tpu")
PORT = "endoscopydepthestimation_pytorch_tpu_torch"
CACHE_DIR = ROOT / "build" / "h100bench"


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds go to build/kernels/, fixed in its code);
    keep libraries that could load JAX from doing so."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _nvidia_smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"unavailable ({err.__class__.__name__})"
    return out.stdout.strip().replace("\n", "; ") or "unavailable"


def cpu_model() -> str:
    """The host CPU's model name, else what /proc/cpuinfo says of it."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        info = []
    for key in ("model name", "Model", "cpu model", "CPU part", "vendor_id"):
        for line in info:
            name, _, value = line.partition(":")
            if name.strip() == key and value.strip() not in ("", "unknown"):
                return f"{value.strip()} ({platform.machine()})"
    return platform.processor() or platform.machine() or "unknown"


def source_rev() -> str:
    """The git commit where there is one, else a hash of the port's and the
    benchmark's files (a checkout without .git)."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    digest = hashlib.sha256()
    for top in (ROOT / PORT, ROOT / "h100bench"):
        for p in sorted(top.rglob("*")):
            if p.is_file() and "__pycache__" not in p.parts:
                digest.update(str(p.relative_to(ROOT)).encode() + p.read_bytes())
    return "files-sha256:" + digest.hexdigest()[:16]


def info_lines(device) -> List[str]:
    import torch
    lines = []
    if device.type == "cuda":
        lines.append(f"card: {torch.cuda.get_device_name(device)} x "
                     f"{torch.cuda.device_count()} visible; nvidia-smi name, power.limit: "
                     f"{_nvidia_smi('name,power.limit')}")
    else:
        lines.append(f"device: {device} (no card: a rehearsal, no device metric)")
    lines.append(f"host cpu: {cpu_model()}, {os.cpu_count()} cores")
    lines.append(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
                 f"python {platform.python_version()}, rev {source_rev()}")
    return lines
