"""ADVI head (port of starcat/advi.py): a Gaussian variational family over
the unconstrained catalog params, fit by maximising the reparameterised
ELBO

    ELBO = E_q[-U(theta)] + H[q],    theta = mu + sigma * xi,  xi ~ N(0, I)

with Adam (optax.adam's arithmetic, adapt.adam_update) on a cosine-decay
learning rate equal to ``optax.cosine_decay_schedule(lr, n_steps, 1e-2)``.
The gradients are written out from the potential's analytic gradient g at
the n_mc draws: dU/dmu = mean(g), dU/dlog_sigma = mean(g sigma xi), and the
entropy adds -1 to each live log sigma.

``grad_fn`` is batched: the n_mc draws of a step take one call, the fused
kernel at n_steps = 0 on the card (dispatch.make_grad_fn) or the plain
potential.  The fits are pure functions of their draws ``xi``, one block
of (n_steps, n_mc, ...) standard normals; the caller draws it.

Dead slots (mask == 0) are frozen: their gradient is zero by the masked
potential and the mask, their entropy term is left out of the ELBO, and
advi_sample pins them at mu.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .adapt import AdamState, adam_update

_LOG_2PI_E = math.log(2.0 * math.pi) + 1.0
_ALPHA = 1e-2   # the cosine schedule's floor, as a fraction of the learning rate


class ADVIConfig(NamedTuple):
    n_steps: int = 2000
    n_mc: int = 8              # MC samples per ELBO gradient
    learning_rate: float = 5e-2
    log_sigma0: float = -2.0   # initial log sd
    full_rank: bool = False    # N(mu, L L^T) with dense lower-triangular L


class ADVIResult(NamedTuple):
    mu: torch.Tensor          # (K, 3) variational mean
    log_sigma: torch.Tensor   # (K, 3) variational log sd
    elbo_trace: torch.Tensor  # (n_steps,) before each update


class FullRankADVIResult(NamedTuple):
    mu: torch.Tensor          # (K, 3)
    scale_tril: torch.Tensor  # (3K, 3K) lower-triangular L with positive diagonal
    elbo_trace: torch.Tensor  # (n_steps,) after each update, on that step's draws


def cosine_decay(learning_rate: float, n_steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(learning_rate, n_steps, 1e-2) at update
    ``count`` (0 for the first)."""
    c = min(count, n_steps)
    return learning_rate * ((1.0 - _ALPHA) * 0.5 * (1.0 + math.cos(math.pi * c / n_steps))
                            + _ALPHA)


def _adam_init(x: torch.Tensor) -> AdamState:
    z = torch.zeros_like(x)
    return AdamState(z, z, torch.zeros((), dtype=x.dtype, device=x.device))


def fit_advi(grad_fn: Callable, mu0: torch.Tensor, mask: torch.Tensor, xi: torch.Tensor,
             config: ADVIConfig = ADVIConfig()) -> ADVIResult:
    """Fit the mean-field family.  xi (n_steps, n_mc, K, 3) standard normal;
    the trace records the ELBO of each step's draws before its update."""
    mask3 = mask[..., None]
    mu, log_sigma = mu0.clone(), torch.full_like(mu0, config.log_sigma0)
    st_mu, st_ls = _adam_init(mu), _adam_init(mu)
    elbos = torch.empty(config.n_steps, dtype=mu0.dtype, device=mu0.device)
    for step in range(config.n_steps):
        sigma = torch.exp(log_sigma)
        u, g = grad_fn(mu + sigma * xi[step] * mask3)
        ent = torch.sum(mask3 * (log_sigma + 0.5 * _LOG_2PI_E))
        elbos[step] = ent - torch.mean(u)
        grad_mu = torch.mean(g, 0) * mask3
        grad_ls = torch.mean(g * sigma * xi[step], 0) * mask3 - mask3  # d(-H)/dlog_sigma = -1
        lr = cosine_decay(config.learning_rate, config.n_steps, step)
        st_mu, d_mu = adam_update(st_mu, grad_mu, lr)
        st_ls, d_ls = adam_update(st_ls, grad_ls, lr)
        mu, log_sigma = mu - d_mu, log_sigma - d_ls
    return ADVIResult(mu, log_sigma, elbos)


def advi_sample(generator: torch.Generator, result: ADVIResult, mask: torch.Tensor,
                n: int) -> torch.Tensor:
    """n draws (n, K, 3) from the fitted q, dead slots pinned at mu."""
    mu = result.mu
    xi = torch.randn((n,) + tuple(mu.shape), generator=generator, dtype=mu.dtype,
                     device=mu.device)
    return mu + torch.exp(result.log_sigma) * xi * mask[..., None]


def fit_advi_fullrank(grad_fn: Callable, mu0: torch.Tensor, xi: torch.Tensor,
                      config: ADVIConfig = ADVIConfig()) -> FullRankADVIResult:
    """Fit q = N(mu, L L^T) over the flattened params, L = strictly lower
    part + diag(exp(log_diag)).  xi (n_steps, n_mc, 3K) standard normal.

    Every slot must be alive: the dense L couples coordinates.  As in the
    reference, the trace records the ELBO at the updated parameters on the
    same step's draws (the mean-field trace records it before the update)."""
    d, kshape = mu0.numel(), tuple(mu0.shape)
    n_mc = xi.shape[1]
    mu = mu0.reshape(d).clone()
    log_diag = torch.full((d,), config.log_sigma0, dtype=mu0.dtype, device=mu0.device)
    lower = torch.zeros((d, d), dtype=mu0.dtype, device=mu0.device)
    tril = torch.tril(torch.ones_like(lower), diagonal=-1)
    states = [_adam_init(x) for x in (mu, log_diag, lower)]
    elbos = torch.empty(config.n_steps, dtype=mu0.dtype, device=mu0.device)

    def scale_tril(log_diag, lower):
        return lower * tril + torch.diag(torch.exp(log_diag))

    def neg_elbo(mu, log_diag, lower, x):
        theta = mu + x @ scale_tril(log_diag, lower).T
        u, g = grad_fn(theta.reshape((n_mc,) + kshape))
        return torch.mean(u) - (torch.sum(log_diag) + 0.5 * d * _LOG_2PI_E), g.reshape(n_mc, d)

    for step in range(config.n_steps):
        _, g = neg_elbo(mu, log_diag, lower, xi[step])
        outer = g.T @ xi[step] / n_mc          # mean over draws of g xi^T
        grads = (torch.mean(g, 0), torch.diagonal(outer) * torch.exp(log_diag) - 1.0,
                 outer * tril)
        lr = cosine_decay(config.learning_rate, config.n_steps, step)
        params = []
        for i, (x, gx) in enumerate(zip((mu, log_diag, lower), grads)):
            states[i], dx = adam_update(states[i], gx, lr)
            params.append(x - dx)
        mu, log_diag, lower = params
        elbos[step] = -neg_elbo(mu, log_diag, lower, xi[step])[0]
    return FullRankADVIResult(mu.reshape(kshape), scale_tril(log_diag, lower), elbos)


def advi_sample_fullrank(generator: torch.Generator, result: FullRankADVIResult,
                         n: int) -> torch.Tensor:
    """n draws (n, K, 3) from the fitted full-rank q."""
    mu = result.mu
    d = mu.numel()
    xi = torch.randn((n, d), generator=generator, dtype=mu.dtype, device=mu.device)
    return (mu.reshape(d) + xi @ result.scale_tril.T).reshape((n,) + tuple(mu.shape))
