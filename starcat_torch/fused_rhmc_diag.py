"""Fused diagonal-Fisher Riemannian trajectory: the hand-written CUDA kernel
(csrc/fused_rhmc_diag.cu) behind the call contract of the Pallas kernel it
replaces, B3 (starcat/pallas_rhmc_diag.py: make_pallas_rhmc_diag_leapfrog):

    make_fused_rhmc_diag(spec, image, prior, kmax, n_steps,
                         fixed_point_iters, jitter)
        -> fused(theta, xi, eps, mask, beta=1.0)
        -> (theta' (C, K, 3), p' (C, K, 3), h0, h1, u1, resid (C,))

theta and xi are (C, K, 3) float32, xi standard normal: the momentum
p0 = sqrt(g(theta)) xi mask is drawn inside.  eps is a scalar or (C,); mask
is (K,) shared or (C, K) per chain; beta tempers the likelihood and may be a
float or a device scalar tensor, which the kernel reads without a host sync.
h0, h1 are the Hamiltonian at both ends, u1 = U_beta(theta'), and resid the
per-chain solver residual (NaN when the trajectory blew up).  Scenes or
catalogs beyond the kernel's domain go to the crowded-field kernel B4
(fused_rhmc_diag_crowded.py), chosen by :func:`dispatch.rhmc_diag_module`.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_rhmc_diag_reference` (the generalised leapfrog
with the autograd dH/dtheta), only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from .build import MAX_SMEM_BYTES, launch_riemannian, riemannian_scalars
from .integrators import riemannian_leapfrog
from .metric import make_diag_metric_fn
from .potential import PriorSpec, log_likelihood, log_prior
from .rhmc import make_rhmc_diag_functions
from .scene import SceneSpec

MAX_PIXELS = 48 * 48      # the kernel's domain: H * W <= 48^2 and K <= 16
MAX_STARS = 16
MAX_ROWS = 48             # the largest row tile (kMaxRows in the source)
PER_STAR = 16             # kS in the source: the per-star arrays' stride
THREADS = 256             # kThreads in the source: a chain's block

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def scene_tile(height: int, width: int) -> tuple[int, int, int, bool]:
    """(rows, columns, row tile, transposed) of the scene as one block holds
    it (scene_tile in the source): a scene taller than 48 rows is
    transposed, and the rows sit in the smallest of the 4-, 16-, 32- and
    48-row tiles that holds them."""
    swap = height > MAX_ROWS
    rows, cols = (width, height) if swap else (height, width)
    tile = 4 if rows <= 4 else 16 if rows <= 16 else 32 if rows <= 32 else 48
    return rows, cols, tile, swap


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    1/lam and the working field at the tile's row stride (the image is
    read through L2); the y-side sets gy, gy^2, gy'^2 and the x-side sets
    gx and the q field's two operands, a row per star (x-side rows W | 1
    long); the block sum's doubles and the column runs' partial sums (3
    floats a thread of the 256); nine per-star arrays, the live list, the
    contraction sums and C tensor (21), ten (K, 3) state arrays (two of
    them a sweep's weights and the next's), all at a stride of 16 stars,
    and 12 of scratch."""
    _, cols, tile, _ = scene_tile(height, width)
    return 4 * (2 * tile * cols + 3 * kmax * (tile + (cols | 1))
                + THREADS // 16 + 3 * THREADS + (9 + 1 + 21 + 30) * PER_STAR + 12)


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    hw = spec.height * spec.width
    if hw > MAX_PIXELS or kmax > MAX_STARS or kmax < 1:
        return (f"the fused CUDA diagonal-Fisher trajectory (B3) takes H*W <= "
                f"{MAX_PIXELS} and 1 <= K <= {MAX_STARS}, got "
                f"{spec.height}x{spec.width} and K={kmax}; larger scenes and "
                "catalogs run on the crowded-field kernel B4 "
                "(fused_rhmc_diag_crowded.py)")
    if smem_bytes(kmax, spec.height, spec.width) > MAX_SMEM_BYTES:
        return (f"a {spec.height}x{spec.width} scene with K={kmax} needs "
                f"{smem_bytes(kmax, spec.height, spec.width)} bytes of shared "
                f"memory per block, more than the card's {MAX_SMEM_BYTES}")
    return None


def launch_layout(c: int, kmax: int, height: int, width: int) -> dict:
    """How the kernel lays out a launch of c chains on the current card
    (starcat_fused_rhmc_diag_layout in the source, from the checkout's
    build): threads per chain (256 at every chain count), the blocks an SM
    holds and the SMs the grid fills."""
    from .build import query_layout, riemannian_library

    return query_layout(riemannian_library("fused_rhmc_diag"),
                        "starcat_fused_rhmc_diag_layout", c, kmax, height, width)


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


def fused_rhmc_diag_reference(spec: SceneSpec, image: torch.Tensor,
                              prior: PriorSpec, theta: torch.Tensor,
                              xi: torch.Tensor, eps, mask: torch.Tensor,
                              beta=1.0, n_steps: int = 6,
                              fixed_point_iters: int = 6,
                              jitter: float = 1e-3):
    """The kernel's trajectory in plain torch, on whatever device and in
    whatever dtype its tensors have: riemannian_leapfrog over
    make_rhmc_diag_functions (dH/dtheta by autograd) on the tempered
    potential U_beta = -(beta log L + log prior) and the diagonal metric."""
    img = image.to(theta.dtype)

    def potential(th, m):
        return -(beta * log_likelihood(th, m, spec, img) + log_prior(th, m, prior))

    dmetric = make_diag_metric_fn(spec, prior, jitter)
    metric = lambda th, m: dmetric(th, m, beta)  # noqa: E731
    ham, dhdt, dhdp = make_rhmc_diag_functions(potential, metric)
    p0 = torch.sqrt(metric(theta, mask)) * xi * mask[..., None]
    res = riemannian_leapfrog(lambda th, p: dhdt(th, p, mask),
                              lambda th, p: dhdp(th, p, mask),
                              theta, p0, eps, n_steps, fixed_point_iters)
    h0 = ham(theta, p0, mask)
    h1 = ham(res.theta, res.p, mask)
    return (res.theta, res.p, h0, h1, potential(res.theta, mask),
            res.solver_resid)


def make_fused_rhmc_diag(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                         kmax: int, n_steps: int, fixed_point_iters: int = 6,
                         jitter: float = 1e-3):
    """B3's contract: fused(theta, xi, eps, mask, beta=1.0) -> (theta', p',
    h0, h1, u1, resid), one launch per call on a CUDA device."""
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
        out = launch_riemannian("fused_rhmc_diag", image, kmax, n_steps, fpi, scalars,
                                theta, xi, eps, mask, beta)
        LAUNCHES += 1
        return out

    return fused
