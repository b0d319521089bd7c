"""Build the port's CUDA kernels: nvcc compiles ``csrc/<name>.cu`` at first
use into a shared library with a plain C interface under build/kernels/,
keyed by a hash of the source and the flags, which the wrappers load with
ctypes.  Nothing here runs on import, and nothing falls back: a missing
toolkit or a failed compile raises.  :func:`check_tensor` is the wrappers'
common check of what they pass a kernel.
"""
from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232448   # what one block may hold on an H100


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


@functools.cache
def build_kernel(name: str) -> tuple[Path, str, float]:
    """Compile csrc/<name>.cu if its build is missing; returns (library
    path, the compiler's resource report, seconds spent building)."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text(), 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stderr, seconds


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """Raise unless t is a contiguous float32 tensor of this shape on this
    device: a kernel reads raw pointers and checks nothing itself."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
