"""HMC head (port of starcat/hmc.py): a batched transition over all chains
with ±20% per-chain step-size jitter.  Without the jitter, fixed-length
trajectories on the mass-adapted (nearly isotropic) posterior are
near-periodic and R-hat stalls near 1.2 even at accept ~0.9.

The transition is a pure function of its random inputs (``p0``, ``u_jit``,
``u_acc``); :func:`make_hmc_kernel` draws them from the run's generator.
The trajectory is pluggable with the fused kernel's dyn contract
``trajectory(theta, p, eps, inv_mass, mask, n_steps, grad) -> (theta, p,
u, grad)``: the plain leapfrog over a batched ``grad_fn`` (:func:`run_hmc`)
or the CUDA kernel, B1 or B5 by the scene's size (:func:`run_hmc_fused`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import dist
from .driver import ChainState, run_mcmc
from .dispatch import make_leapfrog
from .integrators import kinetic_energy, plain_trajectory
from .potential import make_potential_and_grad


class HMCConfig(NamedTuple):
    step_size: float = 0.1
    n_leapfrog: int = 20
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0


class StepInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    diverged: torch.Tensor
    energy_error: torch.Tensor


def hmc_transition(states: ChainState, eps, inv_mass: torch.Tensor,
                   mask: torch.Tensor, p0: torch.Tensor, u_jit: torch.Tensor,
                   u_acc: torch.Tensor, trajectory: Callable, n_leapfrog: int,
                   divergence_threshold: float = 1000.0):
    """One HMC transition of every chain.

    p0 (C, K, 3) standard normal, u_jit and u_acc (C,) uniform on [0, 1).
    ``mask`` freezes dead catalog slots: their momentum is zeroed, so masked
    coordinates never move.
    """
    mask3 = mask[..., None]
    eps_c = eps * (0.8 + 0.4 * u_jit)                   # (C,) step jitter
    p0 = p0 / torch.sqrt(inv_mass) * mask3
    h0 = states.u + kinetic_energy(p0, inv_mass)
    theta_n, p_n, u_n, grad_n = trajectory(
        states.theta, p0, eps_c, inv_mass, mask, n_leapfrog, states.grad)
    h1 = u_n + kinetic_energy(p_n, inv_mass)
    # NaN-safe: non-finite trajectories are rejected, never propagated
    e_err = h1 - h0
    e_err = torch.where(torch.isfinite(e_err), e_err, torch.full_like(e_err, float("inf")))
    accept_prob = torch.exp(torch.clamp(-e_err, max=0.0))
    diverged = e_err > divergence_threshold

    accept = u_acc < accept_prob
    acc3 = accept[:, None, None]
    theta = torch.where(acc3, theta_n, states.theta)
    u = torch.where(accept, u_n, states.u)
    grad = torch.where(acc3, grad_n, states.grad)
    return ChainState(theta, u, grad), StepInfo(accept_prob, accept, diverged, e_err)


def make_hmc_kernel(trajectory: Callable, mask: torch.Tensor,
                    config: HMCConfig, generator: torch.Generator, mesh=None):
    """Batched kernel with driver.py's signature (states, eps, inv_mass);
    draws p0, u_jit and u_acc for all chains, in that order (under a
    ``mesh`` at full width, keeping this rank's rows)."""

    def kernel(states: ChainState, eps, inv_mass):
        th = states.theta

        def draws(c):
            return (torch.randn((c,) + th.shape[1:], generator=generator, dtype=th.dtype,
                                device=th.device),
                    torch.rand((c,), generator=generator, device=th.device),
                    torch.rand((c,), generator=generator, device=th.device))

        p0, u_jit, u_acc = dist.draw(draws, th.shape[0], mesh)
        return hmc_transition(states, eps, inv_mass, mask, p0, u_jit, u_acc,
                              trajectory, config.n_leapfrog,
                              config.divergence_threshold)

    return kernel


def run_hmc(generator: torch.Generator, grad_fn: Callable,
            theta0: torch.Tensor, mask: torch.Tensor, n_samples: int,
            n_warmup: int, config: HMCConfig = HMCConfig(), thin: int = 1,
            block_size: int | None = None, checkpoint_path: str | None = None,
            resume: bool = False, logger=None, mesh=None):
    """init -> warmup -> sample on the plain leapfrog (batched grad_fn).
    block_size, checkpoint_path, resume, logger and mesh: driver.run_mcmc's."""
    kernel = make_hmc_kernel(plain_trajectory(grad_fn), mask, config, generator, mesh)
    return run_mcmc(kernel, grad_fn, theta0, n_samples, n_warmup,
                    step_size=config.step_size,
                    target_accept=config.target_accept, thin=thin,
                    block_size=block_size, checkpoint_path=checkpoint_path,
                    resume=resume, logger=logger, generator=generator, mesh=mesh)


def run_hmc_fused(generator: torch.Generator, spec, image: torch.Tensor,
                  prior, theta0: torch.Tensor, mask: torch.Tensor,
                  n_samples: int, n_warmup: int,
                  config: HMCConfig = HMCConfig(), thin: int = 1,
                  block_size: int | None = None, checkpoint_path: str | None = None,
                  resume: bool = False, logger=None, mesh=None):
    """run_hmc with every trajectory in one launch of the fused leapfrog
    kernel that takes the scene, B1 or B5 (B1's contract; the entry
    gradient comes from the chain state)."""
    pg = make_potential_and_grad(spec, image, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    fused = make_leapfrog(spec, image, prior, int(mask.shape[-1]), config.n_leapfrog)
    trajectory = lambda th, p, e, im, m, n, g: fused(th, p, e, im, m, grad=g)  # noqa: E731
    kernel = make_hmc_kernel(trajectory, mask, config, generator, mesh)
    return run_mcmc(kernel, grad_fn, theta0, n_samples, n_warmup,
                    step_size=config.step_size,
                    target_accept=config.target_accept, thin=thin,
                    block_size=block_size, checkpoint_path=checkpoint_path,
                    resume=resume, logger=logger, generator=generator, mesh=mesh)
