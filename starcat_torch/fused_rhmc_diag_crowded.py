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

The kernel takes every scene and every catalog of K >= 1 slots, as the JAX
package's XLA route does beyond its Pallas kernel's VMEM gates
(starcat/api.py:44-53).  Inside its first domain
(:func:`one_tile`: at most 128 x 128 pixels, which its GEMM passes tile in
one block of pixels, and two fields and two profile sets that fit one
block's shared memory: at 128x128, K up to 78, cfg4's K = 64 among them) a
launch takes that one-tile code, unchanged; beyond it the wide path, which
walks the field in tiles of at most 128 x 128 pixels and the live stars in
chunks of WIDE_CHUNK, the chain's state in a workspace in device memory
that the wrapper allocates (:func:`workspace_floats` a chain, 312 KB at
256x256 with K = 256, 1.06 MB at 512x512 with K = 64), indexed in 64 bits;
its shared memory does not grow with the field or the catalog.  Where the
workspace does not fit the card, its allocation raises PyTorch's
out-of-memory error before the launch.  Smaller
scenes run on B3 (fused_rhmc_diag.py); :func:`dispatch.rhmc_diag_module`
chooses.

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

MAX_STARS = 128   # the one-tile path: one thread per element of the (K, 3) state
MAX_SIDE = 128    # kTile in the source: the one-tile path's H, W <= 128, the wide path's tile
THREADS = 512     # kThreads in the source
PART_FLOATS = 288  # kPartFloats in the source
GX_STRIDE = MAX_SIDE + 4  # kGx in the source
WIDE_CHUNK = 64   # wide::kChunk in the source: live stars a chunk

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block of the one-tile path needs (mirrors
    smem_floats in the source): 1/lam and the working field, 128 rows by
    W columns each (the working field at least one star's 512 q-field
    operands); the profiles gx (K + 3, 132) and gy (K, 128); the state and
    per-star scalars, 55 K floats.  The height does not enter: every field
    is 128 rows tall."""
    field = MAX_SIDE * width
    return 4 * (field + max(field, 4 * MAX_SIDE) + (kmax + 3) * (MAX_SIDE + 4)
                + kmax * MAX_SIDE + 2 * (THREADS // 32) + 55 * kmax + PART_FLOATS + 8)


def one_tile(kmax: int, height: int, width: int) -> bool:
    """Whether a launch takes the one-tile path (the source's launch takes
    it when the wrapper passes a null workspace): K <= 128, H and W <= 128 and
    the block's shared memory within the card's."""
    return (kmax <= MAX_STARS and height <= MAX_SIDE and width <= MAX_SIDE
            and smem_bytes(kmax, height, width) <= MAX_SMEM_BYTES)


def wide_smem_bytes() -> int:
    """Shared memory one block of the wide path needs (mirrors
    wide::smem_floats in the source), whatever the scene: the tile's 1/lam
    and working field (128 x 128 each), one chunk's profiles gx (WIDE_CHUNK
    + 3, 132) and gy (WIDE_CHUNK, 128), the block sum's doubles, the column
    halves' partial sums, 7 floats a chunk star and 8 of scratch."""
    return 4 * (2 * MAX_SIDE * MAX_SIDE + (WIDE_CHUNK + 3) * GX_STRIDE + WIDE_CHUNK * MAX_SIDE
                + 2 * (THREADS // 32) + PART_FLOATS + 7 * WIDE_CHUNK + 8)


def workspace_floats(kmax: int, height: int, width: int) -> int:
    """A chain's slice of the wide path's workspace, in floats (mirrors
    wide::work_floats in the source): a build's 1/lam, 128 rows by W
    columns a band of 128 rows, and 49 K floats of state and per-star
    scalars, rounded up to 4."""
    bands = -(-height // MAX_SIDE)
    return (bands * width * MAX_SIDE + 49 * kmax + 3) & ~3


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None: it
    takes every scene and K >= 1."""
    if kmax < 1:
        return (f"the crowded-field CUDA diagonal-Fisher trajectory (B4) takes K >= 1, "
                f"got K={kmax}")
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
        work = (None, 0)  # the one-tile path takes no workspace
        if not one_tile(kmax, spec.height, spec.width):
            c = theta.shape[0]
            work = (torch.empty(c * workspace_floats(kmax, spec.height, spec.width),
                                dtype=torch.float32, device=theta.device), c)
        out = launch_riemannian("fused_rhmc_diag_crowded", image, kmax, n_steps, fpi,
                                scalars, theta, xi, eps, mask, beta, workspace=work)
        LAUNCHES += 1
        return out

    return fused
