"""Fused full-Fisher Riemannian trajectory: the hand-written CUDA kernel
(csrc/fused_rhmc.cu) behind the call contract of the Pallas kernel it
replaces, B6 (starcat/pallas_rhmc.py: make_pallas_rhmc_leapfrog):

    make_fused_rhmc(spec, image, prior, kmax, n_steps, fixed_point_iters,
                    jitter)
        -> fused(theta, xi, eps, mask, beta=1.0)
        -> (theta' (C, K, 3), p' (C, K, 3), h0, h1, u1, resid (C,))

theta and xi are (C, K, 3) float32, xi standard normal: the momentum
p0 = (L xi) mask is drawn inside, with L the Cholesky factor of the dense
metric G(theta) in the reference kernel's type-major order (parameter
t K + k for type t of star k), so the same xi gives the reference kernel's
momentum.  eps is a scalar or (C,); mask is (K,) shared or (C, K) per
chain; beta tempers the likelihood and may be a float or a device scalar
tensor, which the kernel reads without a host sync.  h0, h1 are the
Hamiltonian at both ends, u1 = U_beta(theta'), and resid the per-chain
solver residual (NaN when the trajectory blew up or G lost definiteness).

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_rhmc_reference` (the generalised leapfrog with
the autograd dH/dtheta through the Cholesky), only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from .build import MAX_SMEM_BYTES, launch_riemannian, riemannian_scalars
from .integrators import riemannian_leapfrog
from .metric import make_metric_fn
from .potential import PriorSpec, log_likelihood, log_prior
from .rhmc import cholesky_or_nan, make_rhmc_functions
from .scene import SceneSpec

MAX_PIXELS = 48 * 48      # the kernel's domain: H * W <= 48^2 and K <= 16
MAX_STARS = 16

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def matrix_stride(d: int) -> int:
    """The odd row stride of the kernel's D x D matrices (mat_ld in the
    source): a column's entries fall in distinct shared-memory banks."""
    return (d + 1) | 1


def profile_stride(n: int) -> int:
    """The odd star stride of the kernel's profile sets (prof_ld in the
    source): one row or column of different stars falls in distinct banks."""
    return n | 1


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    the per-star and per-parameter state, the image, 1/lam and a working
    field, six profile sets at the odd star stride, the 18 K^2 pair
    contractions, G^-1's 3x3 star blocks (12 K^2, padded for 16-byte loads),
    and G / L with a right-hand-side row, L^-1 and G^-1 at the odd row
    stride."""
    d = 3 * kmax
    return 4 * (30 * kmax * kmax + 58 * kmax + 3 * height * width
                + 3 * kmax * (profile_stride(height) + profile_stride(width)) + 8
                + (3 * d + 1) * matrix_stride(d))


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None."""
    hw = spec.height * spec.width
    if hw > MAX_PIXELS or kmax > MAX_STARS or kmax < 1:
        return (f"the fused CUDA full-Fisher trajectory (B6) takes H*W <= "
                f"{MAX_PIXELS} and 1 <= K <= {MAX_STARS}, got "
                f"{spec.height}x{spec.width} and K={kmax}")
    if smem_bytes(kmax, spec.height, spec.width) > MAX_SMEM_BYTES:
        return (f"the fused CUDA full-Fisher trajectory (B6): a "
                f"{spec.height}x{spec.width} scene with K={kmax} needs "
                f"{smem_bytes(kmax, spec.height, spec.width)} bytes of shared "
                f"memory per block, more than the card's {MAX_SMEM_BYTES}")
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


def launch_layout(c: int, kmax: int, height: int, width: int) -> dict:
    """How the kernel lays out a launch of c chains on the current card
    (starcat_fused_rhmc_layout in the source, from the checkout's build):
    threads per chain, the blocks an SM holds and the SMs the grid fills."""
    from .build import query_layout, riemannian_library

    return query_layout(riemannian_library("fused_rhmc"), "starcat_fused_rhmc_layout", c,
                        kmax, height, width)


def type_major(x: torch.Tensor) -> torch.Tensor:
    """(..., K, 3) -> (..., 3K) in the reference kernel's order t K + k."""
    return x.transpose(-1, -2).reshape(*x.shape[:-2], -1)


def fused_rhmc_reference(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                         theta: torch.Tensor, xi: torch.Tensor, eps,
                         mask: torch.Tensor, beta=1.0, n_steps: int = 6,
                         fixed_point_iters: int = 6, jitter: float = 1e-3):
    """The kernel's trajectory in plain torch, on whatever device and in
    whatever dtype its tensors have: riemannian_leapfrog over
    rhmc.make_rhmc_functions (dH/dtheta by autograd) on the tempered
    potential U_beta = -(beta log L + log prior) and the dense metric."""
    img = image.to(theta.dtype)
    k = theta.shape[-2]

    def potential(th, m):
        return -(beta * log_likelihood(th, m, spec, img) + log_prior(th, m, prior))

    dense = make_metric_fn(spec, prior, jitter)
    metric = lambda th, m: dense(th, m, beta)  # noqa: E731
    ham, dhdt, dhdp = make_rhmc_functions(potential, metric)
    # p0 = L xi with L the factor of G permuted to type-major order
    perm = torch.arange(3 * k, device=theta.device).reshape(k, 3).T.reshape(-1)
    g = metric(theta, mask)[..., perm, :][..., :, perm]
    p_tm = (cholesky_or_nan(g) @ type_major(xi)[..., None])[..., 0]
    p0 = p_tm.reshape(*theta.shape[:-2], 3, k).transpose(-1, -2) * mask[..., None]
    res = riemannian_leapfrog(lambda th, p: dhdt(th, p, mask),
                              lambda th, p: dhdp(th, p, mask),
                              theta, p0, eps, n_steps, fixed_point_iters)
    h0 = ham(theta, p0, mask)
    h1 = ham(res.theta, res.p, mask)
    return (res.theta, res.p, h0, h1, potential(res.theta, mask),
            res.solver_resid)


def make_fused_rhmc(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                    kmax: int, n_steps: int, fixed_point_iters: int = 6,
                    jitter: float = 1e-3):
    """B6's contract: fused(theta, xi, eps, mask, beta=1.0) -> (theta', p',
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
            return fused_rhmc_reference(spec, image.to(theta.device), prior, theta,
                                        xi, eps, mask, beta, n_steps, fpi, jitter)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused RHMC trajectory for device {theta.device}")
        out = launch_riemannian("fused_rhmc", image, kmax, n_steps, fpi, scalars,
                                theta, xi, eps, mask, beta)
        LAUNCHES += 1
        return out

    return fused
