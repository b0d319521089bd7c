"""Fused leapfrog trajectory: the hand-written CUDA kernel
(csrc/fused_leapfrog.cu) behind the call contracts of the two Pallas
kernels it replaces (starcat/pallas_kernels.py):

    make_fused_leapfrog(spec, image, prior, kmax, n_steps)      # B1
        -> fused(theta, p, eps, inv_mass, mask, grad=None)
    make_fused_leapfrog_dyn(spec, image, prior, kmax)           # B2
        -> fused(theta, p, eps, inv_mass, mask, n_steps, grad)

Both return (theta', p', u' (C,), grad' (C, K, 3)).  theta, p and grad are
(C, K, 3) float32; eps is a scalar or (C,); inv_mass is (K, 3); mask is (K,)
shared or (C, K) per chain.  ``n_steps == 0`` returns (U, grad U) at theta.
Without an entry gradient the trajectory evaluates it first (n + 1 evals).

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_leapfrog_reference`, only for tensors on the
CPU.  The kernel is compiled with nvcc at first use into build/kernels/
(build.build_kernel), keyed by a hash of its source, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import MAX_SMEM_BYTES, build_kernel, check_tensor as _check
from .integrators import plain_trajectory
from .potential import PriorSpec, make_potential_and_grad
from .scene import SceneSpec

MAX_PIXELS = 48 * 48      # B1's domain: H * W <= 48^2 and K <= 16
MAX_STARS = 16

# Launch counts of the CUDA kernel: every launch, and by contract.
LAUNCHES = 0
STATIC_LAUNCHES = 0  # through make_fused_leapfrog (B1's contract)
DYN_LAUNCHES = 0     # through make_fused_leapfrog_dyn (B2's contract)


def reset_launch_counts() -> None:
    global LAUNCHES, STATIC_LAUNCHES, DYN_LAUNCHES
    LAUNCHES = STATIC_LAUNCHES = DYN_LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_kernel("fused_leapfrog")[0]))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.starcat_fused_leapfrog.argtypes = (
        [vp] * 6 + [ci] + [vp] * 6 + [ci] * 4 + [cf] * 6 + [vp])
    lib.starcat_fused_leapfrog.restype = ci
    lib.starcat_cuda_error_string.argtypes = [ci]
    lib.starcat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source)."""
    return 4 * (19 * kmax + 8 + 1 + 2 * height * width
                + kmax * (width + 2 * height))


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    hw = spec.height * spec.width
    if hw > MAX_PIXELS or kmax > MAX_STARS or kmax < 1:
        raise ValueError(
            f"the fused CUDA leapfrog takes H*W <= {MAX_PIXELS} and "
            f"1 <= K <= {MAX_STARS}, got {spec.height}x{spec.width} and "
            f"K={kmax}; crowded fields wait for the port of kernel B5 "
            "(ROADMAP.md queue B)")
    if smem_bytes(kmax, spec.height, spec.width) > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {spec.height}x{spec.width} scene with K={kmax} needs "
            f"{smem_bytes(kmax, spec.height, spec.width)} bytes of shared "
            f"memory per block, more than the card's {MAX_SMEM_BYTES}")


def fused_leapfrog_reference(spec: SceneSpec, image: torch.Tensor,
                             prior: PriorSpec, theta: torch.Tensor,
                             p: torch.Tensor, eps, inv_mass: torch.Tensor,
                             mask: torch.Tensor, n_steps,
                             grad: torch.Tensor | None = None):
    """The kernel's trajectory in plain torch, on whatever device its
    tensors are on (and in their dtype).  Same contract as the kernel:
    n_steps == 0 returns (U, grad U) at theta; without ``grad`` the entry
    gradient is evaluated first."""
    pg = make_potential_and_grad(spec, image.to(theta.dtype), prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    if int(n_steps) == 0 or grad is None:
        u, grad = grad_fn(theta)
        if int(n_steps) == 0:
            return theta, p, u, grad
    return plain_trajectory(grad_fn)(theta, p, eps, inv_mass, mask, n_steps, grad)


class _Launcher:
    """The kernel bound to one scene, prior and catalog capacity."""

    def __init__(self, spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                 kmax: int, contract: str):
        self.spec, self.prior, self.kmax = spec, prior, kmax
        self.contract = contract  # "static" (B1) or "dyn" (B2)
        self.image = image.to(torch.float32).contiguous()
        if tuple(self.image.shape) != (spec.height, spec.width):
            raise ValueError(f"image must be ({spec.height}, {spec.width}), "
                             f"got {tuple(self.image.shape)}")
        if self.image.device.type == "cuda":
            check_domain(spec, kmax)
        sig = float(spec.psf_sigma)
        self.scalars = (
            sig, 1.0 / (math.sqrt(2.0 * math.pi) * sig), float(spec.background),
            float(prior.logf_mean), float(prior.logf_sigma),
            -math.log(prior.logf_sigma) - 0.5 * math.log(2.0 * math.pi),
        )

    def __call__(self, theta, p, eps, inv_mass, mask, n_steps, grad):
        """n_steps: a Python int or a device int32 scalar tensor."""
        if not isinstance(n_steps, torch.Tensor) and int(n_steps) < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        if theta.device.type == "cpu":
            return fused_leapfrog_reference(
                self.spec, self.image.to(theta.device), self.prior, theta, p,
                eps, inv_mass, mask, n_steps, grad)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused leapfrog for device {theta.device}")
        return self._launch(theta, p, eps, inv_mass, mask, n_steps, grad)

    def _launch(self, theta, p, eps, inv_mass, mask, n_steps, grad):
        global LAUNCHES, STATIC_LAUNCHES, DYN_LAUNCHES
        dev, k = theta.device, self.kmax
        c = theta.shape[0]
        if c < 1:
            raise ValueError("the fused leapfrog needs at least one chain")
        if self.image.device != dev:
            raise ValueError(f"image is on {self.image.device}, theta on {dev}")
        _check("theta", theta, (c, k, 3), dev)
        _check("p", p, (c, k, 3), dev)
        _check("inv_mass", inv_mass, (k, 3), dev)
        if grad is not None:
            _check("grad", grad, (c, k, 3), dev)
        if mask.ndim == 1:
            _check("mask", mask, (k,), dev)
            mask_stride = 0
        else:
            _check("mask", mask, (c, k), dev)
            mask_stride = k
        eps_c = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        if eps_c.ndim > 1 or (eps_c.ndim == 1 and eps_c.shape[0] != c):
            raise ValueError(f"eps must be a scalar or ({c},), got {tuple(eps_c.shape)}")
        eps_c = eps_c.reshape(-1).expand(c).contiguous()
        if isinstance(n_steps, torch.Tensor):
            if n_steps.dtype != torch.int32 or n_steps.numel() != 1 or n_steps.device != dev:
                raise ValueError("n_steps must be one int32 on the chains' device")
            n_dev = n_steps
        else:
            n_dev = torch.full((1,), int(n_steps), dtype=torch.int32, device=dev)
        theta_out = torch.empty_like(theta)
        p_out = torch.empty_like(p)
        grad_out = torch.empty_like(theta)
        u_out = torch.empty((c,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _library().starcat_fused_leapfrog(
                theta.data_ptr(), p.data_ptr(),
                None if grad is None else grad.data_ptr(),
                eps_c.data_ptr(), inv_mass.data_ptr(), mask.data_ptr(),
                mask_stride, self.image.data_ptr(), n_dev.data_ptr(),
                theta_out.data_ptr(), p_out.data_ptr(), u_out.data_ptr(),
                grad_out.data_ptr(), c, k, self.spec.height, self.spec.width,
                *self.scalars, stream)
        if rc != 0:
            msg = _library().starcat_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused leapfrog launch failed: {msg} ({rc})")
        LAUNCHES += 1
        if self.contract == "static":
            STATIC_LAUNCHES += 1
        else:
            DYN_LAUNCHES += 1
        return theta_out, p_out, u_out, grad_out


def make_fused_leapfrog(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                        kmax: int, n_steps: int):
    """B1's contract: a static step count, the entry gradient optional."""
    launcher = _Launcher(spec, image, prior, kmax, "static")
    # the static L, written once into the device scalar the kernel reads
    n_dev = (torch.full((1,), int(n_steps), dtype=torch.int32,
                        device=launcher.image.device)
             if launcher.image.device.type == "cuda" else int(n_steps))

    def fused(theta, p, eps, inv_mass, mask, grad=None):
        return launcher(theta, p, eps, inv_mass, mask, n_dev, grad)

    return fused


def make_fused_leapfrog_dyn(spec: SceneSpec, image: torch.Tensor,
                            prior: PriorSpec, kmax: int):
    """B2's contract: the step count is a runtime argument (an int, or a
    device int32 scalar the kernel reads without a host sync)."""
    launcher = _Launcher(spec, image, prior, kmax, "dyn")

    def fused(theta, p, eps, inv_mass, mask, n_steps, grad):
        return launcher(theta, p, eps, inv_mass, mask, n_steps, grad)

    return fused
