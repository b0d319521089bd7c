"""Fused full-Fisher Riemannian trajectory on crowded fields: the
hand-written CUDA kernel B6c (csrc/fused_rhmc_crowded.cu) behind B6's call
contract (fused_rhmc.py) for the scenes B6 does not take:

    make_fused_rhmc(spec, image, prior, kmax, n_steps, fixed_point_iters,
                    jitter)
        -> fused(theta, xi, eps, mask, beta=1.0)
        -> (theta' (C, K, 3), p' (C, K, 3), h0, h1, u1, resid (C,))

The JAX package has no Pallas kernel here: beyond its B6 gate it runs the
full metric on XLA (starcat/api.py:205).  The kernel takes scenes of at most
128 x 128 pixels with 1 <= K <= 64 catalog slots; :func:`dispatch.rhmc_full_module`
gives it what B6's domain does not hold.  One launch takes every chain: a
persistent grid of one block an SM walks the chains, each block in its own
slice of a workspace in device memory that the wrapper allocates
(:func:`workspace_bytes` a block), so the memory follows the card, not the
chain count.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_rhmc.fused_rhmc_reference` (the same function),
only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import launch_riemannian, riemannian_library, riemannian_scalars
from .fused_rhmc import fused_rhmc_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 64    # kMaxStars in the source
MAX_SIDE = 128    # kMaxSide in the source: H, W <= 128
THREADS = 512     # kThreads in the source

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def field_stride(width: int) -> int:
    """The row stride of the kernel's fields and column profiles
    (field_stride in the source): W rounded up to 4."""
    return (width + 3) & ~3


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    1/lam (H rows at the field stride), the three row profile sets at the
    odd star stride H | 1, 58 floats a star and 8 of scratch."""
    return 4 * (height * field_stride(width) + 3 * kmax * (height | 1) + 58 * kmax + 8)


def workspace_floats(kmax: int, height: int, width: int) -> int:
    """Device memory one block works in, in floats (mirrors work_floats in
    the source): the working field, three column profile sets, the 18 K^2
    pair contractions, G / L ((D + 1)^2), L^-1 and G^-1 (D (D + 1) each) and
    G^-1's 3x3 star blocks padded to 12 floats, each a multiple of 4."""
    fs, d = field_stride(width), 3 * kmax
    return (height * fs + 3 * kmax * fs + _round4(18 * kmax * kmax)
            + _round4((d + 1) * (d + 1)) + 2 * _round4(d * (d + 1)) + 12 * kmax * kmax)


def workspace_bytes(kmax: int, height: int, width: int, blocks: int = 1) -> int:
    """The workspace a launch of ``blocks`` blocks takes."""
    return 4 * blocks * workspace_floats(kmax, height, width)


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    if not 1 <= kmax <= MAX_STARS:
        return (f"the crowded-field CUDA full-Fisher trajectory (B6c) takes "
                f"1 <= K <= {MAX_STARS}, got K={kmax}")
    if spec.height > MAX_SIDE or spec.width > MAX_SIDE:
        return (f"the crowded-field CUDA full-Fisher trajectory (B6c) takes fields of at "
                f"most {MAX_SIDE}x{MAX_SIDE} pixels, got {spec.height}x{spec.width}")
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


@functools.cache
def _library_layout(device_index: int, kmax: int, height: int, width: int) -> dict:
    """The build's threads a block and blocks an SM on this card, once the
    build's own sizes are found equal to this module's mirrors."""
    from .build import query_layout

    lib = riemannian_library("fused_rhmc_crowded")
    fn = lib.starcat_fused_rhmc_crowded_sizes
    ci = ctypes.c_int
    fn.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
    fn.restype = ci
    smem, work = ci(), ci()
    with torch.cuda.device(device_index):
        rc = fn(kmax, height, width, ctypes.byref(smem), ctypes.byref(work))
        if rc != 0:
            raise RuntimeError(f"starcat_fused_rhmc_crowded_sizes failed ({rc})")
        if (smem.value, work.value) != (smem_bytes(kmax, height, width),
                                        workspace_floats(kmax, height, width)):
            raise RuntimeError(
                f"B6c's build sizes a block at {smem.value} bytes of shared memory and "
                f"{work.value} workspace floats; fused_rhmc_crowded.py says "
                f"{smem_bytes(kmax, height, width)} and {workspace_floats(kmax, height, width)}")
        lay = query_layout(lib, "starcat_fused_rhmc_crowded_layout", 1, kmax, height, width)
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return dict(threads=lay["threads"], blocks_per_sm=lay["blocks_per_sm"], sms=sms)


def launch_layout(c: int, kmax: int, height: int, width: int, device=None) -> dict:
    """How the kernel lays out a launch of c chains on the card: threads a
    block, the blocks an SM holds, the grid (at most the SMs times that,
    each block walking its chains), the chains a block takes at most and
    the workspace's bytes."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lay = _library_layout(index, kmax, height, width)
    grid = min(c, lay["blocks_per_sm"] * lay["sms"])
    if grid < 1:
        raise RuntimeError(f"B6c fits no block on this card ({lay})")
    return dict(threads=lay["threads"], blocks_per_sm=lay["blocks_per_sm"], grid=grid,
                chains_per_block=-(-c // grid),
                workspace_bytes=workspace_bytes(kmax, height, width, grid))


def make_fused_rhmc(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                    kmax: int, n_steps: int, fixed_point_iters: int = 6,
                    jitter: float = 1e-3):
    """B6's contract on B6c: fused(theta, xi, eps, mask, beta=1.0) ->
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
            return fused_rhmc_reference(spec, image.to(theta.device), prior, theta,
                                        xi, eps, mask, beta, n_steps, fpi, jitter)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused RHMC trajectory for device {theta.device}")
        if theta.ndim != 3 or theta.shape[0] < 1:
            raise ValueError(f"theta must be (C, {kmax}, 3) with C >= 1, "
                             f"got {tuple(theta.shape)}")
        lay = launch_layout(theta.shape[0], kmax, spec.height, spec.width, theta.device)
        work = torch.empty(lay["workspace_bytes"] // 4, dtype=torch.float32,
                           device=theta.device)
        out = launch_riemannian("fused_rhmc_crowded", image, kmax, n_steps, fpi, scalars,
                                theta, xi, eps, mask, beta, workspace=(work, lay["grid"]))
        LAUNCHES += 1
        return out

    return fused
