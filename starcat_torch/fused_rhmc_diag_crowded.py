"""Fused diagonal-Fisher Riemannian trajectory on crowded fields: the
hand-written CUDA kernel (csrc/fused_rhmc_diag_crowded.cu) behind the call
contract of the Pallas kernel it replaces, B4
(starcat/pallas_rhmc_diag.py: make_pallas_rhmc_diag_mxu), which is B3's:

    make_fused_rhmc_diag(spec, image, prior, kmax, n_steps,
                         fixed_point_iters, jitter)
        -> fused(theta, xi, eps, mask, beta=1.0)
        -> (theta' (C, K, 3), p' (C, K, 3), h0, h1, u1, resid (C,))

theta and xi are (C, K, 3) float32, xi standard normal (the momentum is
drawn inside); eps is a scalar or (C,); mask is (K,) shared or (C, K) per
chain; beta is a float or a device scalar tensor, which the kernel reads
without a host sync.  resid is the per-chain solver residual, NaN when the
trajectory blew up.

The kernel takes scenes of at most 128 x 128 pixels (its GEMM passes tile
one such block of pixels) whose two fields and two profile sets fit one
block's shared memory: at 128x128, K up to 78, cfg4's K = 64 among them.
Smaller scenes run on B3 (fused_rhmc_diag.py);
:func:`dispatch.rhmc_diag_module` chooses.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_rhmc_diag.fused_rhmc_diag_reference` (the same
function: the reference's B4 has B3's math, pallas_rhmc_diag.py:484-505),
only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from .build import MAX_SMEM_BYTES, launch_riemannian, riemannian_scalars
from .fused_rhmc_diag import fused_rhmc_diag_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 128   # one thread per element of the (K, 3) state
MAX_SIDE = 128    # kTile in the source: H, W <= 128
THREADS = 512     # kThreads in the source
PART_FLOATS = 288  # kPartFloats in the source

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    1/lam and the working field, 128 rows by W columns each (the working
    field at least one star's 512 q-field operands); the profiles gx (K +
    3, 132) and gy (K, 128); the state and per-star scalars, 55 K floats.
    The height does not enter: every field is 128 rows tall."""
    field = MAX_SIDE * width
    return 4 * (field + max(field, 4 * MAX_SIDE) + (kmax + 3) * (MAX_SIDE + 4)
                + kmax * MAX_SIDE + 2 * (THREADS // 32) + 55 * kmax + PART_FLOATS + 8)


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    if not 1 <= kmax <= MAX_STARS:
        return (f"the crowded-field CUDA diagonal-Fisher trajectory (B4) takes "
                f"1 <= K <= {MAX_STARS}, got K={kmax}")
    if spec.height > MAX_SIDE or spec.width > MAX_SIDE:
        return (f"the crowded-field CUDA diagonal-Fisher trajectory (B4) tiles at most "
                f"{MAX_SIDE}x{MAX_SIDE} pixels in one block's shared memory, got "
                f"{spec.height}x{spec.width}")
    need = smem_bytes(kmax, spec.height, spec.width)
    if need > MAX_SMEM_BYTES:
        return (f"the crowded-field CUDA diagonal-Fisher trajectory (B4) holds two "
                f"{spec.height}x{spec.width} fields and K={kmax} profiles in {need} bytes "
                f"of shared memory per block, more than the card's {MAX_SMEM_BYTES}")
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


def make_fused_rhmc_diag(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                         kmax: int, n_steps: int, fixed_point_iters: int = 6,
                         jitter: float = 1e-3):
    """B4's contract (B3's): fused(theta, xi, eps, mask, beta=1.0) ->
    (theta', p', h0, h1, u1, resid), one launch per call on a CUDA device."""
    if int(n_steps) < 0 or int(fixed_point_iters) < 0:
        raise ValueError(f"n_steps and fixed_point_iters must be >= 0, got "
                         f"{n_steps} and {fixed_point_iters}")
    n_steps, fpi = int(n_steps), int(fixed_point_iters)
    image = image.to(torch.float32).contiguous()
    if tuple(image.shape) != (spec.height, spec.width):
        raise ValueError(f"image must be ({spec.height}, {spec.width}), "
                         f"got {tuple(image.shape)}")
    if image.device.type == "cuda":
        check_domain(spec, kmax)
    scalars = riemannian_scalars(spec, prior, jitter)

    def fused(theta, xi, eps, mask, beta=1.0):
        global LAUNCHES
        if theta.device.type == "cpu":
            return fused_rhmc_diag_reference(
                spec, image.to(theta.device), prior, theta, xi, eps, mask,
                beta, n_steps, fpi, jitter)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused RHMC trajectory for device {theta.device}")
        out = launch_riemannian("fused_rhmc_diag_crowded", image, kmax, n_steps, fpi,
                                scalars, theta, xi, eps, mask, beta)
        LAUNCHES += 1
        return out

    return fused
