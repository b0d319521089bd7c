"""Shared warmup/sampling driver for the MCMC heads (port of
starcat/driver.py).

A *kernel* is a batched callable ``kernel(states, eps, inv_mass) ->
(states, info)`` over all chains at once, where ``info`` exposes
``accept_prob`` and ``diverged`` (C,).  The random numbers come from the
run's one ``torch.Generator``, which the kernel closes over; nothing here
draws any.  Chain-pooled adaptation statistics are plain means over the
chain axis, kept on the device: no step of warmup or sampling waits for the
host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .adapt import (
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)


class ChainState(NamedTuple):
    theta: torch.Tensor  # (C, K, 3) unconstrained params
    u: torch.Tensor      # (C,) potential at theta
    grad: torch.Tensor   # (C, K, 3) dU/dtheta


def init_chain_states(theta0: torch.Tensor, grad_fn: Callable) -> ChainState:
    """theta0 is (C, K, 3); grad_fn is batched over chains."""
    u, g = grad_fn(theta0)
    return ChainState(theta0, u, g)


class WarmupResult(NamedTuple):
    states: ChainState
    step_size: torch.Tensor     # () dual-averaged eps
    inv_mass: torch.Tensor      # param-shaped diagonal inverse mass


def warmup(states: ChainState, kernel: Callable, n_warmup: int,
           step_size: float = 0.1, target_accept: float = 0.8,
           adapt_mass: bool = True,
           divergence_penalty: float = 0.0) -> WarmupResult:
    """Three-phase pooled warmup (15% eps / 60% eps + mass / 25% eps).

    adapt_mass=False keeps the unit mass (the Riemannian heads, whose
    metric is the mass).  divergence_penalty > 0 makes dual averaging see
    mean(accept_prob) - penalty * frac(diverged | solver_fail), so eps
    settles where failures are rare (at equilibrium the fraction is at most
    (1 - target_accept) / penalty)."""
    n1 = max(n_warmup * 15 // 100, 1)
    n3 = max(n_warmup * 25 // 100, 1)
    n2 = max(n_warmup - n1 - n3, 1)
    device = states.theta.device
    param_shape = states.theta.shape[1:]

    def run_phase(st, da, wf, inv_mass, n, accumulate):
        for _ in range(n):
            st, info = kernel(st, torch.exp(da.log_eps), inv_mass)
            stat = info.accept_prob.mean()
            if divergence_penalty:
                stat = stat - divergence_penalty * _bad_frac(info)
            da = da_update(da, stat, target=target_accept)
            if accumulate:
                wf = welford_update_batch(wf, st.theta)
        return st, da, wf

    da = da_init(step_size, device)
    wf = welford_init(param_shape, device)
    inv_mass = torch.ones(param_shape, dtype=torch.float32, device=device)

    st, da, wf = run_phase(states, da, wf, inv_mass, n1, False)
    st, da, wf = run_phase(st, da, wf, inv_mass, n2, adapt_mass)
    if adapt_mass:
        inv_mass = welford_variance(wf)
        da = da_restart(da)
    st, da, wf = run_phase(st, da, wf, inv_mass, n3, False)
    return WarmupResult(st, torch.exp(da.log_eps_bar), inv_mass)


def _bad_frac(info) -> torch.Tensor:
    """Pooled fraction of divergent or solver-failed transitions."""
    bad = info.diverged
    sf = getattr(info, "solver_fail", None)
    if sf is not None:
        bad = bad | sf
    return bad.to(torch.float32).mean()


class SampleResult(NamedTuple):
    thetas: torch.Tensor       # (C, N, K, 3)
    accept_prob: torch.Tensor  # (C, N)
    diverged: torch.Tensor     # (C, N)
    final_states: ChainState
    # solver force-rejections (C, N) of the Riemannian heads; None for
    # kernels whose info has no solver_fail
    solver_fail: torch.Tensor | None = None


def sample(states: ChainState, kernel: Callable, n_samples: int,
           step_size: torch.Tensor, inv_mass: torch.Tensor,
           thin: int = 1) -> SampleResult:
    """Post-warmup sampling at fixed eps and mass, draws kept on the device.

    thin: record every thin-th transition — n_samples draws are recorded,
    n_samples * thin transitions run; accept/diverged/solver_fail are those
    of the last transition of each record.
    """
    c = states.theta.shape[0]
    dev = states.theta.device
    thetas = torch.empty((c, n_samples) + tuple(states.theta.shape[1:]),
                         dtype=states.theta.dtype, device=dev)
    aprob = torch.empty((c, n_samples), dtype=torch.float32, device=dev)
    div = torch.empty((c, n_samples), dtype=torch.bool, device=dev)
    sf = None
    st = states
    for i in range(n_samples):
        for _ in range(thin):
            st, info = kernel(st, step_size, inv_mass)
        thetas[:, i] = st.theta
        aprob[:, i] = info.accept_prob
        div[:, i] = info.diverged
        if getattr(info, "solver_fail", None) is not None:
            if sf is None:
                sf = torch.empty((c, n_samples), dtype=torch.bool, device=dev)
            sf[:, i] = info.solver_fail
    return SampleResult(thetas, aprob, div, st, sf)


def run_mcmc(kernel: Callable, grad_fn: Callable, theta0: torch.Tensor,
             n_samples: int, n_warmup: int, step_size: float = 0.1,
             target_accept: float = 0.8, thin: int = 1,
             adapt_mass: bool = True, divergence_penalty: float = 0.0):
    """init -> warmup -> sample; returns (SampleResult, WarmupResult)."""
    states = init_chain_states(theta0, grad_fn)
    wr = warmup(states, kernel, n_warmup, step_size=step_size,
                target_accept=target_accept, adapt_mass=adapt_mass,
                divergence_penalty=divergence_penalty)
    res = sample(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass,
                 thin=thin)
    return res, wr
