"""Warmup adaptation (port of starcat/adapt.py): dual-averaging step size
(Hoffman & Gelman 2014, §3.2) and a pooled Welford estimate of the
posterior variance over all chains x warmup draws.

Every state field is a tensor on the run's device, so an update launches a
few tiny kernels and never waits for the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor      # current step size (log)
    log_eps_bar: torch.Tensor  # averaged iterate (used after warmup)
    h_bar: torch.Tensor        # running MH-error statistic
    mu: torch.Tensor           # shrinkage target log(10 * eps0)
    t: torch.Tensor            # iteration counter (float)


def da_init(eps0: float, device) -> DualAveragingState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return DualAveragingState(
        log_eps=z + math.log(eps0),
        log_eps_bar=z,
        h_bar=z,
        mu=z + math.log(10.0 * eps0),
        t=z,
    )


def da_update(state: DualAveragingState, accept_prob: torch.Tensor,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    """One dual-averaging update from the (pooled) acceptance probability."""
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, state.mu, t)


def da_restart(state: DualAveragingState) -> DualAveragingState:
    """Reset the averaging (after the mass matrix changes mid-warmup),
    keeping the averaged step size as the new starting point."""
    eps0 = torch.exp(state.log_eps_bar)
    z = torch.zeros_like(state.h_bar)
    return DualAveragingState(
        log_eps=torch.log(eps0),
        log_eps_bar=z,
        h_bar=z,
        mu=torch.log(10.0 * eps0),
        t=z,
    )


class WelfordState(NamedTuple):
    mean: torch.Tensor   # running mean, param-shaped
    m2: torch.Tensor     # sum of squared deviations
    count: torch.Tensor  # scalar float


def welford_init(shape, device) -> WelfordState:
    return WelfordState(
        mean=torch.zeros(shape, dtype=torch.float32, device=device),
        m2=torch.zeros(shape, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.float32, device=device),
    )


def welford_update_batch(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Merge a batch with leading chain axis (Chan et al. parallel merge)."""
    nb = float(x.shape[0])
    mb = x.mean(dim=0)
    m2b = ((x - mb) ** 2).sum(dim=0)
    delta = mb - state.mean
    tot = state.count + nb
    mean = state.mean + delta * (nb / torch.clamp(tot, min=1.0))
    m2 = state.m2 + m2b + delta ** 2 * (state.count * nb / torch.clamp(tot, min=1.0))
    return WelfordState(mean, m2, tot)


def welford_variance(state: WelfordState, reg: float = 1e-3) -> torch.Tensor:
    """Regularised variance -> inverse mass diagonal (Stan-style shrinkage
    toward a small identity keeps the mass positive definite)."""
    n = torch.clamp(state.count, min=2.0)
    var = state.m2 / (n - 1.0)
    w = n / (n + 5.0)
    return w * var + (1.0 - w) * reg
