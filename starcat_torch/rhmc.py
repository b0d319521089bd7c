"""Riemannian-manifold HMC head (port of starcat/rhmc.py) on the dense
Fisher metric (``metric="full"``, the reference's default) or its diagonal
(``metric="diag"``):

    H(theta, p) = U(theta) + 1/2 log det G(theta) + 1/2 p^T G(theta)^-1 p

integrated by the generalised leapfrog with a fixed number of Picard sweeps
(integrators.riemannian_leapfrog).  Momenta are refreshed as p = L xi mask
with L the Cholesky factor of G (sqrt(g) xi mask for the diagonal), so dead
slots never move.  A trajectory whose fixed-point residual is not below
``solver_tol`` (NaN included) is force-rejected and reported as a solver
failure, apart from Delta-H divergences; warmup's dual averaging sees the
failures through ``divergence_penalty``.

Every trajectory has the call contract of kernels B3 and B6:
``trajectory(theta, xi, eps, mask, beta) -> (theta', p', h0, h1, u1,
resid)``.  :func:`make_trajectory` supplies it: the CUDA kernel's wrapper
(fused_rhmc.make_fused_rhmc for the full metric, B6, or on crowded fields
fused_rhmc_crowded.make_fused_rhmc, B6c; for the diagonal,
fused_rhmc_diag.make_fused_rhmc_diag, B3, or on crowded fields
fused_rhmc_diag_crowded.make_fused_rhmc_diag, B4) or its plain version.
The transition is a pure function of its draws (xi, u_jit, u_acc).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from . import dist
from .driver import ChainState, run_mcmc
from .potential import make_potential_and_grad


class RHMCConfig(NamedTuple):
    step_size: float = 0.05
    n_leapfrog: int = 10
    fixed_point_iters: int = 6
    target_accept: float = 0.9
    divergence_threshold: float = 1000.0
    # "full": the dense Fisher metric (kernel B6/B6c); "diag": its diagonal (B3/B4)
    metric: str = "full"
    solver_tol: float = 0.05
    divergence_penalty: float = 5.0


class RHMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    diverged: torch.Tensor
    energy_error: torch.Tensor
    solver_fail: torch.Tensor  # force-rejected: residual not below solver_tol


def check_metric(metric: str) -> None:
    """Raise unless the metric is one the head knows."""
    if metric not in ("full", "diag"):
        raise ValueError(f"rhmc.metric must be 'full' or 'diag', got {metric!r}")


def cholesky_or_nan(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., D, D) matrix; NaN throughout for
    a matrix that is not positive definite (the reference's Cholesky gives
    NaN there too), so the trajectory reports a solver failure."""
    chol, info = torch.linalg.cholesky_ex(g)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def make_rhmc_functions(potential_fn: Callable, metric_fn: Callable):
    """(hamiltonian, dH_dtheta, dH_dp) for the dense metric, each taking
    (theta (C, K, 3), p (C, K, 3), mask) and batched over chains: H is (C,),
    the derivatives (C, K, 3).  metric_fn returns G (C, 3K, 3K) in the
    star-major order of theta.reshape(C, 3K).

    dH/dtheta is autograd of the sum of H over chains, through the metric
    build, the Cholesky and the triangular solves; the graph is built afresh
    on detached inputs at every call, so Picard sweeps do not stack graphs."""

    def _solve(theta, p, mask):
        chol = cholesky_or_nan(metric_fn(theta, mask))
        pf = p.reshape(p.shape[0], -1, 1)
        return chol, pf, torch.cholesky_solve(pf, chol)

    def ham(theta, p, mask):
        chol, pf, ginv_p = _solve(theta, p, mask)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        return (potential_fn(theta, mask) + 0.5 * logdet
                + 0.5 * torch.sum(pf * ginv_p, dim=(-2, -1)))

    def dham_dtheta(theta, p, mask):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(ham(th, p.detach(), mask).sum(), th)
        return grad

    def dham_dp(theta, p, mask):
        return _solve(theta, p, mask)[2].reshape(p.shape)

    return ham, dham_dtheta, dham_dp


def make_rhmc_diag_functions(potential_fn: Callable, diag_metric_fn: Callable):
    """(hamiltonian, dH_dtheta, dH_dp) for a diagonal position-dependent
    metric, each taking (theta (C, K, 3), p (C, K, 3), mask) and batched
    over chains: H is (C,), the derivatives (C, K, 3).

    dH/dtheta is autograd of the sum of H over chains; chains are
    independent, so each chain gets its own gradient.  The graph is built
    afresh on detached inputs at every call, so Picard sweeps do not
    stack graphs."""

    def ham(theta, p, mask):
        g = diag_metric_fn(theta, mask)
        return (potential_fn(theta, mask)
                + 0.5 * torch.sum(torch.log(g), dim=(-2, -1))
                + 0.5 * torch.sum(p * p / g, dim=(-2, -1)))

    def dham_dtheta(theta, p, mask):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(ham(th, p.detach(), mask).sum(), th)
        return grad

    def dham_dp(theta, p, mask):
        return p / diag_metric_fn(theta, mask)

    return ham, dham_dtheta, dham_dp


def rhmc_transition(states: ChainState, xi: torch.Tensor, u_jit: torch.Tensor,
                    u_acc: torch.Tensor, trajectory: Callable, eps,
                    mask: torch.Tensor, beta=1.0,
                    divergence_threshold: float = 1000.0,
                    solver_tol: float = 0.05):
    """One RHMC transition of every chain on a B3/B6-contract trajectory.

    xi (C, K, 3) standard normal (the trajectory makes the momentum), u_jit
    and u_acc (C,) uniform on [0, 1): eps is jittered by +-20% per chain.
    ``states.u`` must hold U_beta at ``states.theta``; the gradient is not
    used and passes through."""
    eps_c = eps * (0.8 + 0.4 * u_jit)
    theta_n, _, h0, h1, u_n, resid = trajectory(states.theta, xi, eps_c, mask, beta)
    e_err = h1 - h0
    e_err = torch.where(torch.isfinite(e_err), e_err, torch.full_like(e_err, math.inf))
    accept_prob = torch.exp(torch.clamp(-e_err, max=0.0))
    diverged = e_err > divergence_threshold
    # the solver's NaN residual fails too: the proposal is then not the
    # reversible map the MH ratio assumes
    solver_fail = ~(resid < solver_tol)
    accept_prob = torch.where(solver_fail, torch.zeros_like(accept_prob), accept_prob)
    accept = u_acc < accept_prob
    theta = torch.where(accept[:, None, None], theta_n, states.theta)
    u = torch.where(accept, u_n, states.u)
    return ChainState(theta, u, states.grad), RHMCInfo(
        accept_prob, accept, diverged, e_err, solver_fail)


def make_rhmc_kernel(trajectory: Callable, mask: torch.Tensor,
                     config: RHMCConfig, generator: torch.Generator, beta=1.0, mesh=None):
    """Batched kernel with driver.py's signature (states, eps, inv_mass);
    inv_mass is ignored (the metric is the mass).  Draws xi, u_jit and
    u_acc for all chains, in that order (under a ``mesh`` at full width,
    keeping this rank's rows)."""

    def kernel(states: ChainState, eps, inv_mass):
        del inv_mass
        th = states.theta

        def draws(c):
            return (torch.randn((c,) + th.shape[1:], generator=generator, dtype=th.dtype,
                                device=th.device),
                    torch.rand((c,), generator=generator, device=th.device),
                    torch.rand((c,), generator=generator, device=th.device))

        xi, u_jit, u_acc = dist.draw(draws, th.shape[0], mesh)
        return rhmc_transition(states, xi, u_jit, u_acc, trajectory, eps, mask,
                               beta, config.divergence_threshold,
                               config.solver_tol)

    return kernel


def make_trajectory(spec, image: torch.Tensor, prior, kmax: int,
                    config: RHMCConfig, fused: bool, jitter: float = 1e-3):
    """The trajectory of ``config.metric``: the CUDA kernel's wrapper, B6
    or, beyond its domain, B6c for "full" and B3 or, on crowded fields, B4
    for "diag" (which run the plain version only for CPU tensors), or, with
    ``fused=False``, the plain version on any device."""
    # imported here: the kernels' modules build their plain versions from
    # this one
    from .dispatch import make_rhmc_diag, make_rhmc_full
    from .fused_rhmc import fused_rhmc_reference
    from .fused_rhmc_diag import fused_rhmc_diag_reference

    check_metric(config.metric)
    full = config.metric == "full"
    if fused:
        make = make_rhmc_full if full else make_rhmc_diag
        return make(spec, image, prior, kmax, config.n_leapfrog,
                    config.fixed_point_iters, jitter)
    return functools.partial(fused_rhmc_reference if full else fused_rhmc_diag_reference,
                             spec, image, prior, n_steps=config.n_leapfrog,
                             fixed_point_iters=config.fixed_point_iters,
                             jitter=jitter)


def make_fused_rhmc_kernel(spec, image: torch.Tensor, prior, mask: torch.Tensor,
                           config: RHMCConfig, generator: torch.Generator,
                           beta=1.0, jitter: float = 1e-3, mesh=None):
    """The RHMC kernel with every trajectory in one launch of the CUDA
    kernel of ``config.metric`` (B6/B6c, or B3/B4); mask is (K,) or per chain (C, K)."""
    traj = make_trajectory(spec, image, prior, int(mask.shape[-1]), config,
                           True, jitter)
    return make_rhmc_kernel(traj, mask, config, generator, beta, mesh)


def _run(kernel, spec, image, prior, theta0, mask, n_samples, n_warmup,
         config: RHMCConfig, thin: int, generator, durability: dict):
    pg = make_potential_and_grad(spec, image, prior)
    return run_mcmc(kernel, lambda th: pg(th, mask), theta0, n_samples,
                    n_warmup, step_size=config.step_size,
                    target_accept=config.target_accept, thin=thin,
                    adapt_mass=False,
                    divergence_penalty=config.divergence_penalty,
                    generator=generator, **durability)


def run_rhmc(generator: torch.Generator, spec, image: torch.Tensor, prior,
             theta0: torch.Tensor, mask: torch.Tensor, n_samples: int,
             n_warmup: int, config: RHMCConfig = RHMCConfig(), thin: int = 1,
             **durability):
    """init -> step-size-only warmup -> sample on the plain trajectory.
    ``durability``: driver.run_mcmc's block_size, checkpoint_path, resume,
    logger and mesh."""
    traj = make_trajectory(spec, image, prior, int(mask.shape[-1]), config, False)
    kernel = make_rhmc_kernel(traj, mask, config, generator,
                              mesh=durability.get("mesh"))
    return _run(kernel, spec, image, prior, theta0, mask, n_samples, n_warmup,
                config, thin, generator, durability)


def run_rhmc_fused(generator: torch.Generator, spec, image: torch.Tensor, prior,
                   theta0: torch.Tensor, mask: torch.Tensor, n_samples: int,
                   n_warmup: int, config: RHMCConfig = RHMCConfig(),
                   thin: int = 1, **durability):
    """run_rhmc with every trajectory in one launch of kernel B6, B6c, B3 or B4."""
    kernel = make_fused_rhmc_kernel(spec, image, prior, mask, config, generator,
                                    mesh=durability.get("mesh"))
    return _run(kernel, spec, image, prior, theta0, mask, n_samples, n_warmup,
                config, thin, generator, durability)
