"""Build the port's CUDA kernels: nvcc compiles ``csrc/<name>.cu`` at first
use into a shared library with a plain C interface under build/kernels/,
keyed by a hash of the source and the flags, which the wrappers load with
ctypes.  Nothing here runs on import, and nothing falls back: a missing
toolkit or a failed compile raises.  :func:`check_tensor` is the wrappers'
common check of what they pass a kernel; :func:`launch_leapfrog` is the
one launch of the two leapfrog trajectory kernels (B1/B2, B5), behind
B1's and B2's contracts in :class:`LeapfrogKernel`, and
:func:`launch_riemannian` that of the four Riemannian trajectory kernels
(B3, B4, B6, B6c): the kernels of each family share their C interface, B6c's
with a workspace and its grid besides (B4's on its wide path).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
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


def _error_strings(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.starcat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.starcat_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def leapfrog_library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu's library (built at first use), its leapfrog entry
    typed."""
    lib = ctypes.CDLL(str(build_kernel(name)[0]))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, f"starcat_{name}")
    fn.argtypes = [vp] * 6 + [ci] + [vp] * 6 + [ci] * 4 + [cf] * 6 + [vp]
    fn.restype = ci
    return _error_strings(lib)


def leapfrog_scalars(spec, prior) -> tuple:
    """The scene and prior constants the leapfrog kernels take."""
    return riemannian_scalars(spec, prior, 0.0)[:6]


def launch_leapfrog(name: str, image: torch.Tensor, kmax: int, scalars: tuple,
                    theta: torch.Tensor, p: torch.Tensor, eps, inv_mass: torch.Tensor,
                    mask: torch.Tensor, n_steps: torch.Tensor, grad):
    """One launch of csrc/<name>.cu's leapfrog kernel on CUDA tensors, after
    checking what it is given: theta, p and grad (None: evaluated first)
    (C, K, 3), eps a scalar or (C,), inv_mass (K, 3), mask (K,) or (C, K),
    n_steps one int32 on the device.  Returns (theta', p', u', grad');
    raises if the launch fails."""
    dev, k = theta.device, kmax
    c = theta.shape[0]
    if c < 1:
        raise ValueError("the fused leapfrog needs at least one chain")
    if image.device != dev:
        raise ValueError(f"image is on {image.device}, theta on {dev}")
    check_tensor("theta", theta, (c, k, 3), dev)
    check_tensor("p", p, (c, k, 3), dev)
    check_tensor("inv_mass", inv_mass, (k, 3), dev)
    if grad is not None:
        check_tensor("grad", grad, (c, k, 3), dev)
    if mask.ndim == 1:
        check_tensor("mask", mask, (k,), dev)
        mask_stride = 0
    else:
        check_tensor("mask", mask, (c, k), dev)
        mask_stride = k
    eps_c = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    if eps_c.ndim > 1 or (eps_c.ndim == 1 and eps_c.shape[0] != c):
        raise ValueError(f"eps must be a scalar or ({c},), got {tuple(eps_c.shape)}")
    eps_c = eps_c.reshape(-1).expand(c).contiguous()
    if n_steps.dtype != torch.int32 or n_steps.numel() != 1 or n_steps.device != dev:
        raise ValueError("n_steps must be one int32 on the chains' device")
    theta_out = torch.empty_like(theta)
    p_out = torch.empty_like(p)
    grad_out = torch.empty_like(theta)
    u_out = torch.empty((c,), dtype=torch.float32, device=dev)
    lib = leapfrog_library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"starcat_{name}")(
            theta.data_ptr(), p.data_ptr(), None if grad is None else grad.data_ptr(),
            eps_c.data_ptr(), inv_mass.data_ptr(), mask.data_ptr(), mask_stride,
            image.data_ptr(), n_steps.data_ptr(), theta_out.data_ptr(), p_out.data_ptr(),
            u_out.data_ptr(), grad_out.data_ptr(), c, k, image.shape[0], image.shape[1],
            *scalars, stream)
    if rc != 0:
        msg = lib.starcat_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    return theta_out, p_out, u_out, grad_out



class LeapfrogKernel:
    """csrc/<name>.cu's leapfrog trajectory bound to one scene, prior and
    catalog capacity, behind B1's and B2's call contracts:

        LeapfrogKernel(...).static(n_steps)
            -> fused(theta, p, eps, inv_mass, mask, grad=None)
        LeapfrogKernel(...)  (B2's contract itself)
            -> fused(theta, p, eps, inv_mass, mask, n_steps, grad)

    n_steps is an int or one device int32 that the kernel reads without a
    host sync.  On CPU tensors a call returns ``reference`` (the plain
    version, same arguments); on CUDA tensors it launches the kernel, one
    launch a call, and calls ``count(contract)`` with "static" or "dyn"."""

    def __init__(self, name: str, spec, image: torch.Tensor, prior, kmax: int,
                 check_domain, reference, count):
        self.name, self.spec, self.prior, self.kmax = name, spec, prior, kmax
        self.reference, self.count = reference, count
        self.image = image.to(torch.float32).contiguous()
        if tuple(self.image.shape) != (spec.height, spec.width):
            raise ValueError(f"image must be ({spec.height}, {spec.width}), "
                             f"got {tuple(self.image.shape)}")
        if self.image.device.type == "cuda":
            check_domain(spec, kmax)
        self.scalars = leapfrog_scalars(spec, prior)

    def __call__(self, theta, p, eps, inv_mass, mask, n_steps, grad, contract="dyn"):
        if not isinstance(n_steps, torch.Tensor) and int(n_steps) < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        if theta.device.type == "cpu":
            return self.reference(self.spec, self.image.to(theta.device), self.prior, theta,
                                  p, eps, inv_mass, mask, n_steps, grad)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused leapfrog for device {theta.device}")
        if not isinstance(n_steps, torch.Tensor):
            n_steps = torch.full((1,), int(n_steps), dtype=torch.int32, device=theta.device)
        out = launch_leapfrog(self.name, self.image, self.kmax, self.scalars, theta, p, eps,
                              inv_mass, mask, n_steps, grad)
        self.count(contract)
        return out

    def static(self, n_steps: int):
        """B1's contract: the static step count, written once into the
        device scalar the kernel reads."""
        if int(n_steps) < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        n_dev = (torch.full((1,), int(n_steps), dtype=torch.int32, device=self.image.device)
                 if self.image.device.type == "cuda" else int(n_steps))

        def fused(theta, p, eps, inv_mass, mask, grad=None):
            return self(theta, p, eps, inv_mass, mask, n_dev, grad, "static")

        return fused


# the Riemannian kernels whose entry takes a workspace's pointer and the
# grid it is sized for, before the stream (B4's one-tile path takes a null
# pointer and 0)
WORKSPACE_KERNELS = frozenset({"fused_rhmc_crowded", "fused_rhmc_diag_crowded"})


@functools.cache
def riemannian_library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu's library (built at first use), its trajectory entry
    typed."""
    lib = ctypes.CDLL(str(build_kernel(name)[0]))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, f"starcat_{name}")
    fn.argtypes = ([vp] * 4 + [ci] + [vp] * 8 + [ci] * 6 + [cf] * 7
                   + ([vp, ci] if name in WORKSPACE_KERNELS else []) + [vp])
    fn.restype = ci
    return _error_strings(lib)


def query_layout(lib: ctypes.CDLL, entry: str, c: int, kmax: int, height: int,
                 width: int) -> dict:
    """A build's launch layout for c chains from its ``entry`` (threads per
    block, the blocks an SM holds, the SMs the grid fills)."""
    fn = getattr(lib, entry)
    ci = ctypes.c_int
    fn.argtypes = [ci] * 4 + [ctypes.POINTER(ci)] * 3
    fn.restype = ci
    out = [ci() for _ in range(3)]
    rc = fn(c, kmax, height, width, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"{entry} failed ({rc})")
    return dict(zip(("threads", "blocks_per_sm", "sms_filled"), (x.value for x in out)))


def riemannian_scalars(spec, prior, jitter: float) -> tuple:
    """The scene, prior and jitter constants the Riemannian kernels take."""
    sig = float(spec.psf_sigma)
    return (sig, 1.0 / (math.sqrt(2.0 * math.pi) * sig), float(spec.background),
            float(prior.logf_mean), float(prior.logf_sigma),
            -math.log(prior.logf_sigma) - 0.5 * math.log(2.0 * math.pi), float(jitter))


def launch_riemannian(name: str, image: torch.Tensor, kmax: int, n_steps: int,
                      fpi: int, scalars: tuple, theta: torch.Tensor,
                      xi: torch.Tensor, eps, mask: torch.Tensor, beta, workspace=None):
    """One launch of csrc/<name>.cu's trajectory kernel on CUDA tensors,
    after checking what it is given: theta, xi (C, K, 3), eps a scalar or
    (C,), mask (K,) or (C, K), beta a float or one float32 on the device;
    ``workspace``, for a kernel that takes one, (a float32 tensor on the
    device, the grid it is sized for; (None, 0) on B4's one-tile path).
    Returns (theta', p', h0, h1, u1, resid); raises if the launch
    fails."""
    dev, k = theta.device, kmax
    c = theta.shape[0]
    if c < 1:
        raise ValueError("a Riemannian trajectory needs at least one chain")
    if image.device != dev:
        raise ValueError(f"image is on {image.device}, theta on {dev}")
    check_tensor("theta", theta, (c, k, 3), dev)
    check_tensor("xi", xi, (c, k, 3), dev)
    if mask.ndim == 1:
        check_tensor("mask", mask, (k,), dev)
        mask_stride = 0
    else:
        check_tensor("mask", mask, (c, k), dev)
        mask_stride = k
    eps_c = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    if eps_c.ndim > 1 or (eps_c.ndim == 1 and eps_c.shape[0] != c):
        raise ValueError(f"eps must be a scalar or ({c},), got {tuple(eps_c.shape)}")
    eps_c = eps_c.reshape(-1).expand(c).contiguous()
    if isinstance(beta, torch.Tensor):
        if beta.dtype != torch.float32 or beta.numel() != 1 or beta.device != dev:
            raise ValueError("beta must be one float32 on the chains' device")
        beta_dev = beta.reshape(1).contiguous()
    else:
        beta_dev = torch.full((1,), float(beta), dtype=torch.float32, device=dev)
    theta_out = torch.empty_like(theta)
    p_out = torch.empty_like(theta)
    outs = torch.empty((4, c), dtype=torch.float32, device=dev)
    extra = ()
    if (workspace is None) == (name in WORKSPACE_KERNELS):
        raise ValueError(f"{name} takes {'a' if name in WORKSPACE_KERNELS else 'no'} workspace")
    if workspace is not None:
        work, grid = workspace
        if work is not None and (work.device != dev or work.dtype != torch.float32
                                 or not work.is_contiguous()):
            raise ValueError("the workspace must be a contiguous float32 tensor on the "
                             "chains' device")
        extra = (None if work is None else work.data_ptr(), int(grid))
    lib = riemannian_library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"starcat_{name}")(
            theta.data_ptr(), xi.data_ptr(), eps_c.data_ptr(), mask.data_ptr(),
            mask_stride, beta_dev.data_ptr(), image.data_ptr(), theta_out.data_ptr(),
            p_out.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), outs[3].data_ptr(), c, k, image.shape[0],
            image.shape[1], n_steps, fpi, *scalars, *extra, stream)
    if rc != 0:
        msg = lib.starcat_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    return theta_out, p_out, outs[0], outs[1], outs[2], outs[3]
