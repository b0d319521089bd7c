"""Velocity-Verlet leapfrog (port of starcat/integrators.py:23-68).

``grad_fn(theta) -> (U, dU/dtheta)`` is batched over the leading chain
axis, so every chain advances in lockstep.  The Riemannian leapfrog comes
with the Riemannian heads.
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
