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
Scenes or catalogs beyond its domain go to the crowded-field kernel B5
(fused_leapfrog_crowded.py), chosen by :func:`dispatch.leapfrog_module`.
"""
from __future__ import annotations

import torch

from .build import MAX_SMEM_BYTES, LeapfrogKernel
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


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source)."""
    return 4 * (19 * kmax + 8 + 1 + 2 * height * width
                + kmax * (width + 2 * height))


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    hw = spec.height * spec.width
    if hw > MAX_PIXELS or kmax > MAX_STARS or kmax < 1:
        return (f"the fused CUDA leapfrog (B1/B2) takes H*W <= {MAX_PIXELS} and "
                f"1 <= K <= {MAX_STARS}, got {spec.height}x{spec.width} and "
                f"K={kmax}; larger scenes and catalogs run on the crowded-field "
                "kernel B5 (fused_leapfrog_crowded.py)")
    if smem_bytes(kmax, spec.height, spec.width) > MAX_SMEM_BYTES:
        return (f"a {spec.height}x{spec.width} scene with K={kmax} needs "
                f"{smem_bytes(kmax, spec.height, spec.width)} bytes of shared "
                f"memory per block, more than the card's {MAX_SMEM_BYTES}")
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


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


def _count(contract: str) -> None:
    global LAUNCHES, STATIC_LAUNCHES, DYN_LAUNCHES
    LAUNCHES += 1
    if contract == "static":
        STATIC_LAUNCHES += 1
    else:
        DYN_LAUNCHES += 1


def _kernel(spec, image, prior, kmax) -> LeapfrogKernel:
    return LeapfrogKernel("fused_leapfrog", spec, image, prior, kmax, check_domain,
                          fused_leapfrog_reference, _count)


def make_fused_leapfrog(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                        kmax: int, n_steps: int):
    """B1's contract: a static step count, the entry gradient optional."""
    return _kernel(spec, image, prior, kmax).static(n_steps)


def make_fused_leapfrog_dyn(spec: SceneSpec, image: torch.Tensor,
                            prior: PriorSpec, kmax: int):
    """B2's contract: the step count is a runtime argument (an int, or a
    device int32 scalar the kernel reads without a host sync)."""
    return _kernel(spec, image, prior, kmax)
