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

The kernel takes every scene and every catalog of K >= 1 slots, as the JAX
package's XLA route does beyond its Pallas kernel's VMEM gate
(starcat/api.py:44-53).  Inside its first domain
(:func:`one_tile`: at most 128 x 128 pixels and 1 <= K <= 128) a launch
takes that one-tile code, unchanged: its GEMM passes tile the scene in the
smallest square of 32, 64 or 128 pixels a side that holds it
(:func:`tile_side`), with a block of 32, 128 or 512 threads a chain, and
the residual field and the live stars' two profile sets fit one block's
shared memory at every such K (206 KB at 128x128 with K = 128), the
crowded field's K = 50 and 64 among them.  Beyond it the wide path walks
the field in tiles of at most 128 x 128 pixels and the catalog in chunks
of WIDE_CHUNK slots, 512 threads a chain, the chain's state in the
launch's outputs: its shared memory does not grow with the field or the
catalog, and it indexes the chains' state and the image in 64 bits.
Scenes and catalogs inside B1's domain run on B1 (fused_leapfrog.py);
:func:`dispatch.leapfrog_module` chooses.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_leapfrog.fused_leapfrog_reference` (the same
function; B5 differs from B1 only in how it lays the work out on the chip),
only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from .build import LeapfrogKernel
from .fused_leapfrog import fused_leapfrog_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 128   # kMaxStars in the source: the one-tile path's slots
MAX_SIDE = 128    # kMaxSide in the source: the one-tile path's H, W <= 128
WIDE_CHUNK = 128  # wide::kChunk in the source: catalog slots a chunk

# Launch count of the CUDA kernel, through either contract.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def tile_side(height: int, width: int) -> int:
    """The side T of the launch's pixel tile (tile_side in the source): 32,
    64 or 128, the smallest that holds the scene."""
    side = max(height, width)
    return 32 if side <= 32 else 64 if side <= 64 else 128


def tile_threads(side: int) -> int:
    """Threads a block at tile side T (Tile<T>::kThreads in the source):
    8 x 4 render pixels a thread, so 32, 128 or 512."""
    return side * side // 32


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block of the one-tile path needs (mirrors
    smem_floats in the source): the residual field, T rows by W columns;
    the profiles gx (K + 3 rows of T + 4) and gyw (K, T); the block sum's
    doubles (two floats a warp), the column halves' partial sums (3 sums
    of 4 stars for each of the pass's star groups: T / 8 lanes hold a
    group's rows, the warps hold 32 / (T / 8) groups each and, from two
    warps up, split the columns in halves), 20 K floats of state and
    per-star scalars, 4 of scratch.  The height enters only through T."""
    side = tile_side(height, width)
    warps = tile_threads(side) // 32
    halves = 2 if warps >= 2 else 1
    groups = (32 // (side // 8)) * warps // halves
    return 4 * (side * width + (kmax + 3) * (side + 4) + kmax * side + 2 * warps
                + 3 * 4 * groups + 20 * kmax + 4)


def one_tile(kmax: int, height: int, width: int) -> bool:
    """Whether a launch takes the one-tile path (one_tile in the source):
    K <= 128 and H, W <= 128, where smem_bytes fits the card at every K."""
    return kmax <= MAX_STARS and height <= MAX_SIDE and width <= MAX_SIDE


def wide_smem_bytes() -> int:
    """Shared memory one block of the wide path needs (mirrors
    wide::smem_floats in the source), whatever the scene: the tile's
    residual field (128 x 128), one chunk's profiles gx (WIDE_CHUNK + 3,
    132) and gyw (WIDE_CHUNK, 128), the block sum's doubles and the column
    halves' partial sums as at T = 128, 6 floats a chunk slot (x, y, flux,
    slot, and x's and y's remainders), the compaction's counts a warp and 4
    of scratch."""
    side, warps = 128, tile_threads(128) // 32
    return 4 * (side * side + (WIDE_CHUNK + 3) * (side + 4) + WIDE_CHUNK * side + 2 * warps
                + 3 * 4 * 16 + 6 * WIDE_CHUNK + warps + 4)


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None: it
    takes every scene and K >= 1."""
    if kmax < 1:
        return f"the crowded-field CUDA leapfrog (B5) takes K >= 1, got K={kmax}"
    return None


def launch_layout(c: int, kmax: int, height: int, width: int) -> dict:
    """How the kernel lays out a launch of c chains on the current card
    (starcat_fused_leapfrog_crowded_layout in the source, from the
    checkout's build): threads per chain, the blocks an SM holds and the
    SMs the grid fills."""
    from .build import leapfrog_library, query_layout

    return query_layout(leapfrog_library("fused_leapfrog_crowded"),
                        "starcat_fused_leapfrog_crowded_layout", c, kmax, height, width)


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
