"""Fused leapfrog trajectory on crowded fields: the hand-written CUDA kernel
(csrc/fused_leapfrog_crowded.cu) behind the call contract of the Pallas
kernel it replaces, B5 (starcat/pallas_mxu.py: make_pallas_leapfrog_mxu),
which is B1's contract, and under B2's contract (the runtime step count of
ChEES) where B2's kernel does not take the scene:

    make_fused_leapfrog(spec, image, prior, kmax, n_steps)
        -> fused(theta, p, eps, inv_mass, mask, grad=None)
    make_fused_leapfrog_dyn(spec, image, prior, kmax)
        -> fused(theta, p, eps, inv_mass, mask, n_steps, grad)

Both return (theta', p', u' (C,), grad' (C, K, 3)).

theta, p and grad are (C, K, 3) float32; eps is a scalar or (C,); inv_mass
is (K, 3); mask is (K,) shared or (C, K) per chain.  ``n_steps == 0``
returns (U, grad U) at theta; without an entry gradient the trajectory
evaluates it first.

The kernel takes the scenes and catalogs whose working set (the residual
field and three profile sets) fits one block's shared memory: 128x128 with
K up to 103, the crowded field's K = 50 and 64 among them.  Smaller scenes
run on B1 (fused_leapfrog.py); :func:`dispatch.leapfrog_module` chooses.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_leapfrog.fused_leapfrog_reference` (the same
function; B5 differs from B1 only in how it lays the work out on the chip),
only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from .build import MAX_SMEM_BYTES, LeapfrogKernel
from .fused_leapfrog import fused_leapfrog_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 128   # one thread per element of the (K, 3) state
THREADS = 512     # kThreads in the source

# Launch count of the CUDA kernel, through either contract.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source)."""
    return 4 * (19 * kmax + 2 + 2 * (THREADS // 32) + height * width
                + kmax * (width + 2 * height))


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    if not 1 <= kmax <= MAX_STARS:
        return f"the crowded-field CUDA leapfrog (B5) takes 1 <= K <= {MAX_STARS}, got K={kmax}"
    need = smem_bytes(kmax, spec.height, spec.width)
    if need > MAX_SMEM_BYTES:
        return (f"the crowded-field CUDA leapfrog (B5) holds a {spec.height}x{spec.width} "
                f"field and K={kmax} profiles in {need} bytes of shared memory per "
                f"block, more than the card's {MAX_SMEM_BYTES}")
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


def _count(contract: str) -> None:
    global LAUNCHES
    LAUNCHES += 1


def _kernel(spec, image, prior, kmax) -> LeapfrogKernel:
    return LeapfrogKernel("fused_leapfrog_crowded", spec, image, prior, kmax, check_domain,
                          fused_leapfrog_reference, _count)


def make_fused_leapfrog(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                        kmax: int, n_steps: int):
    """B5's contract (B1's): a static step count, the entry gradient
    optional; one launch per call on a CUDA device."""
    return _kernel(spec, image, prior, kmax).static(n_steps)


def make_fused_leapfrog_dyn(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                            kmax: int):
    """B2's contract on B5: the step count is a runtime argument, an int or
    a device int32 scalar that the kernel reads without a host sync (a
    negative device count acts as 0); one launch per call on a CUDA
    device."""
    return _kernel(spec, image, prior, kmax)
