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

from .build import MAX_SMEM_BYTES, launch_leapfrog, leapfrog_scalars
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
        self.scalars = leapfrog_scalars(spec, prior)

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
        if not isinstance(n_steps, torch.Tensor):
            n_steps = torch.full((1,), int(n_steps), dtype=torch.int32, device=theta.device)
        out = launch_leapfrog("fused_leapfrog", self.image, self.kmax, self.scalars,
                              theta, p, eps, inv_mass, mask, n_steps, grad)
        LAUNCHES += 1
        if self.contract == "static":
            STATIC_LAUNCHES += 1
        else:
            DYN_LAUNCHES += 1
        return out


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
