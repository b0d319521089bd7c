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

The kernel runs a chain in a warp (two at the 32-column tile,
:func:`warps_per_chain`), CHAINS_PER_BLOCK chains a block, and takes
every scene of H * W <= 48^2 pixels and 1 <= K <= 16 stars: a scene
wider than 48 columns is held transposed (:func:`scene_frame`), its columns
sit in a compile-time tile of 16, 32 or 48 (:func:`column_tile`) and the
star count is padded to 4, 8, 10, 12 or 16 (:func:`star_pad`); the row
profiles are held CHUNK rows at a time, so its shared memory
(:func:`smem_bytes`) stays under the 48 KB a block has without opting in.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_leapfrog_reference`, only for tensors on the
CPU.  The kernel is compiled with nvcc at first use into build/kernels/
(build.build_kernel), keyed by a hash of its source, and loaded with ctypes.
Scenes or catalogs beyond its domain go to the crowded-field kernel B5
(fused_leapfrog_crowded.py), chosen by :func:`dispatch.leapfrog_module`.
"""
from __future__ import annotations

import torch

from .build import LeapfrogKernel
from .integrators import plain_trajectory
from .potential import PriorSpec, make_potential_and_grad
from .scene import SceneSpec

MAX_PIXELS = 48 * 48      # B1's domain: H * W <= 48^2 and 1 <= K <= 16
MAX_STARS = 16
MAX_COLS = 48             # kMaxCols in the source: a wider scene is transposed
CHUNK = 48                # kChunk: the rows of row profiles a chain holds at once
CHAINS_PER_BLOCK = 4      # kChainsPerBlock
EXCH = 3 * 16 + 2         # kExch: a warp's slot of its chain's exchange

# Launch counts of the CUDA kernel: every launch, and by contract.
LAUNCHES = 0
STATIC_LAUNCHES = 0  # through make_fused_leapfrog (B1's contract)
DYN_LAUNCHES = 0     # through make_fused_leapfrog_dyn (B2's contract)


def reset_launch_counts() -> None:
    global LAUNCHES, STATIC_LAUNCHES, DYN_LAUNCHES
    LAUNCHES = STATIC_LAUNCHES = DYN_LAUNCHES = 0


def scene_frame(height: int, width: int) -> tuple[int, int, bool]:
    """(rows, columns, transposed) of the scene as the kernel holds it
    (frame() in the source): a scene wider than 48 columns, which H * W <=
    48^2 makes shorter than 48 rows, is transposed."""
    swap = width > MAX_COLS
    return (width, height, True) if swap else (height, width, False)


def column_tile(cols: int) -> int:
    """The compile-time column tile that holds ``cols`` columns: 16 (a
    column a lane, the warp's lanes in two row groups), 32 (a column a
    lane) or 48 (two columns a lane)."""
    return 16 if cols <= 16 else 32 if cols <= 32 else 48


def warps_per_chain(tile: int) -> int:
    """Warps a chain at a column tile (Tile<>::kWarps in the source): two at
    32 columns, which split the rows and add their sums through shared
    memory, one at 16 and 48."""
    return 2 if tile == 32 else 1


def star_pad(kmax: int) -> int:
    """The compile-time star count that holds kmax stars: 4, 8, 10 (the
    flagship's K), 12 or 16."""
    for pad in (4, 8, 10, 12):
        if kmax <= pad:
            return pad
    return 16


def image_stride(cols: int) -> int:
    """The staged image's row stride: the least >= cols that is 2 mod 4."""
    return (cols + 1) // 4 * 4 + 2


def launch_tile(height: int, width: int, kmax: int) -> dict:
    """The instantiation a scene and catalog run on: the frame's rows and
    columns, whether it is transposed, the column tile and the star pad."""
    rows, cols, swap = scene_frame(height, width)
    return {"rows": rows, "cols": cols, "transposed": swap, "column_tile": column_tile(cols),
            "star_pad": star_pad(kmax), "warps_per_chain": warps_per_chain(column_tile(cols))}


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    the image in the kernel's frame at its padded row stride, once a block,
    to a multiple of 4 floats; each chain's row profiles gyw and gywz,
    star_pad(kmax) rows of CHUNK, split between its warps; and, with two
    warps a chain, each chain's exchange, two slots a warp."""
    rows, cols, _ = scene_frame(height, width)
    warps = warps_per_chain(column_tile(cols))
    image = -(-rows * image_stride(cols) // 4) * 4
    exchange = CHAINS_PER_BLOCK * 2 * warps * EXCH if warps > 1 else 0
    return 4 * (image + CHAINS_PER_BLOCK * 2 * star_pad(kmax) * CHUNK + exchange)


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    hw = spec.height * spec.width
    if hw > MAX_PIXELS or kmax > MAX_STARS or kmax < 1:
        return (f"the fused CUDA leapfrog (B1/B2) takes H*W <= {MAX_PIXELS} and "
                f"1 <= K <= {MAX_STARS}, got {spec.height}x{spec.width} and "
                f"K={kmax}; larger scenes and catalogs run on the crowded-field "
                "kernel B5 (fused_leapfrog_crowded.py)")
    return None


def launch_layout(c: int, kmax: int, height: int, width: int) -> dict:
    """How the kernel lays out a launch of c chains on the current card
    (starcat_fused_leapfrog_layout in the source, from the checkout's
    build): warps a chain, chains a block, threads a block, the blocks an
    SM holds and the SMs the grid fills."""
    from .build import leapfrog_library, query_layout

    lay = query_layout(leapfrog_library("fused_leapfrog"), "starcat_fused_leapfrog_layout",
                       c, kmax, height, width)
    return {"warps_per_chain": lay["threads"] // 32 // CHAINS_PER_BLOCK,
            "chains_per_block": CHAINS_PER_BLOCK, **lay}


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
