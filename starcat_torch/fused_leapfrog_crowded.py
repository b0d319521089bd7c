"""Fused leapfrog trajectory on crowded fields: the hand-written CUDA kernel
(csrc/fused_leapfrog_crowded.cu) behind the call contract of the Pallas
kernel it replaces, B5 (starcat/pallas_mxu.py: make_pallas_leapfrog_mxu),
which is B1's contract:

    make_fused_leapfrog(spec, image, prior, kmax, n_steps)
        -> fused(theta, p, eps, inv_mass, mask, grad=None)
        -> (theta', p', u' (C,), grad' (C, K, 3))

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

from .build import MAX_SMEM_BYTES, launch_leapfrog, leapfrog_scalars
from .fused_leapfrog import fused_leapfrog_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 128   # one thread per element of the (K, 3) state
THREADS = 512     # kThreads in the source

# Launch count of the CUDA kernel.
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


def make_fused_leapfrog(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                        kmax: int, n_steps: int):
    """B5's contract (B1's): a static step count, the entry gradient
    optional; one launch per call on a CUDA device."""
    if int(n_steps) < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    n_steps = int(n_steps)
    image = image.to(torch.float32).contiguous()
    if tuple(image.shape) != (spec.height, spec.width):
        raise ValueError(f"image must be ({spec.height}, {spec.width}), "
                         f"got {tuple(image.shape)}")
    on_card = image.device.type == "cuda"
    if on_card:
        check_domain(spec, kmax)
    scalars = leapfrog_scalars(spec, prior)
    # the static L, written once into the device scalar the kernel reads
    n_dev = (torch.full((1,), n_steps, dtype=torch.int32, device=image.device)
             if on_card else None)

    def fused(theta, p, eps, inv_mass, mask, grad=None):
        global LAUNCHES
        if theta.device.type == "cpu":
            return fused_leapfrog_reference(spec, image.to(theta.device), prior, theta, p,
                                            eps, inv_mass, mask, n_steps, grad)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused leapfrog for device {theta.device}")
        if n_dev is None:
            raise ValueError(f"image is on {image.device}, theta on {theta.device}")
        out = launch_leapfrog("fused_leapfrog_crowded", image, kmax, scalars, theta, p,
                              eps, inv_mass, mask, n_dev, grad)
        LAUNCHES += 1
        return out

    return fused
