"""Velocity-Verlet leapfrog and the generalised (implicit) Riemannian
leapfrog (port of starcat/integrators.py).

``grad_fn(theta) -> (U, dU/dtheta)`` is batched over the leading chain
axis, so every chain advances in lockstep.  The Riemannian leapfrog's
callables are batched the same way, and its per-chain reductions run over
the (K, 3) axes only, where the reference vmaps a single-chain function.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LeapfrogResult(NamedTuple):
    theta: torch.Tensor
    p: torch.Tensor
    u: torch.Tensor     # potential at the final theta
    grad: torch.Tensor  # gradient at the final theta


def leapfrog(grad_fn: Callable, theta: torch.Tensor, p: torch.Tensor,
             u: torch.Tensor, grad: torch.Tensor, eps, n_steps: int,
             inv_mass: torch.Tensor) -> LeapfrogResult:
    """n_steps of velocity Verlet with a diagonal inverse mass.

    Reuses the gradient at the initial point, so the cost is exactly
    ``n_steps`` gradient evaluations.  ``eps`` is a scalar or a per-chain
    tensor broadcastable against theta (e.g. (C, 1, 1)).
    """
    for _ in range(n_steps):
        p_half = p - 0.5 * eps * grad
        theta = theta + eps * inv_mass * p_half
        u, grad = grad_fn(theta)
        p = p_half - 0.5 * eps * grad
    return LeapfrogResult(theta, p, u, grad)


def plain_trajectory(grad_fn: Callable) -> Callable:
    """The fused kernel's trajectory contract, ``trajectory(theta, p, eps,
    inv_mass, mask, n_steps, grad) -> (theta, p, u, grad)``, on the plain
    leapfrog over ``grad_fn`` (which applies the mask itself).  eps is a
    scalar or per chain (C,); a device step count is read back to the host."""

    def trajectory(theta, p, eps, inv_mass, mask, n_steps, grad):
        eps = torch.as_tensor(eps, dtype=theta.dtype, device=theta.device)
        if eps.ndim == 1:
            eps = eps.reshape(-1, 1, 1)
        return tuple(leapfrog(grad_fn, theta, p, None, grad, eps,
                              int(n_steps), inv_mass))

    return trajectory


def kinetic_energy(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """0.5 p^T M^-1 p per chain: p (C, K, 3) -> (C,)."""
    return 0.5 * torch.sum(inv_mass * p * p, dim=(-2, -1))


class RiemannianLeapfrogResult(NamedTuple):
    theta: torch.Tensor
    p: torch.Tensor
    # per-chain max, over steps and both implicit solves, of the last
    # Picard sweep's relative delta (fp_delta): large or NaN means the
    # solver did not converge and the proposal must be rejected
    solver_resid: torch.Tensor


def fp_delta(x_new: torch.Tensor, x_old: torch.Tensor) -> torch.Tensor:
    """Relative sup-norm Picard delta per chain: (C, K, 3) -> (C,).  NaN in
    either argument gives NaN (amax propagates it), so a blown-up sweep
    counts as a solver failure."""
    num = torch.amax(torch.abs(x_new - x_old), dim=(-2, -1))
    return num / (1.0 + torch.amax(torch.abs(x_new), dim=(-2, -1)))


def riemannian_leapfrog(dH_dtheta: Callable, dH_dp: Callable,
                        theta: torch.Tensor, p: torch.Tensor, eps,
                        n_steps: int, fixed_point_iters: int = 6
                        ) -> RiemannianLeapfrogResult:
    """Generalised leapfrog for H = U + 1/2 log det G + 1/2 p^T G^-1 p with
    ``fixed_point_iters`` Picard sweeps per implicit equation (static
    counts, as the reference):

        p_half    = p      - eps/2 * dH/dtheta(theta,  p_half)
        theta_new = theta  + eps/2 * [dH/dp(theta, p_half) + dH/dp(theta_new, p_half)]
        p_new     = p_half - eps/2 * dH/dtheta(theta_new, p_half)

    theta, p (C, K, 3); eps a scalar or per chain (C,).  The theta fixed
    point starts at theta + eps * dH/dp(theta, p_half)."""
    eps = torch.as_tensor(eps, dtype=theta.dtype, device=theta.device)
    if eps.ndim == 1:
        eps = eps.reshape(-1, 1, 1)
    zero = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)

    def fp(f, x0):
        x, delta = x0, zero
        for _ in range(fixed_point_iters):
            x_new = f(x)
            x, delta = x_new, fp_delta(x_new, x)
        return x, delta

    resid = zero
    for _ in range(n_steps):
        p_b, theta_b = p, theta
        p_half, d1 = fp(lambda ph: p_b - 0.5 * eps * dH_dtheta(theta_b, ph), p_b)
        v0 = dH_dp(theta_b, p_half)
        theta, d2 = fp(lambda th: theta_b + 0.5 * eps * (v0 + dH_dp(th, p_half)),
                       theta_b + eps * v0)
        p = p_half - 0.5 * eps * dH_dtheta(theta, p_half)
        resid = torch.maximum(resid, torch.maximum(d1, d2))
    return RiemannianLeapfrogResult(theta, p, resid)
