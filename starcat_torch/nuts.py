"""NUTS head (port of starcat/nuts.py): the No-U-Turn sampler with a fixed
maximum depth, multinomial sampling within a subtree and the biased
progressive merge across doublings (Betancourt 2017), batched over chains.

Every chain builds its tree in lockstep: doubling d runs 2^d leaves for all
chains at once, and a chain whose tree has ended, or whose subtree turned
or diverged, stays unchanged under ``torch.where`` while the others go on
(what the reference gets from ``vmap`` of its ``while_loop``).  A leaf is
one leapfrog step with a per-chain signed step size, negative in a
backward subtree: the plain step over a batched ``grad_fn``
(:func:`plain_leaf`) or the fused kernel at n_steps = 1
(dispatch.make_leapfrog, B1 on small scenes, B5 on crowded fields).

U-turn checks inside a subtree use the reference's O(max_depth) checkpoint
scheme.  Leaf i (0-based, in generation order) ends one balanced subtree of
size 2^k for every k <= t(i), the number of trailing one-bits of i, and the
partner leaf i - 2^k + 1 of each sits at checkpoint slot popcount(i) - k:

    even i : store (theta, v) at slot popcount(i)
    odd  i : check against slots [popcount(i) - t(i), popcount(i >> 1)]

Since every chain is at the same leaf index, the slots are host ints
(:func:`checkpoint_slots`).  Backward subtrees generate leaves in reverse
time order, so the u-turn products are sign-corrected to time order.

The transition is a pure function of its random numbers (:class:`NUTSDraws`);
:func:`make_nuts_kernel` draws all of them for a transition at once, so
that where the tree stops never moves the generator's stream.  The host
asks whether any chain is still building once a doubling (at most
max_depth waits a transition) and never waits on a leaf: with 1024 chains
some chain reaches the last doubling in nearly every transition, so a
check inside a doubling would save almost nothing.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .driver import ChainState, run_mcmc
from .integrators import kinetic_energy, plain_trajectory


class NUTSConfig(NamedTuple):
    step_size: float = 0.1
    max_depth: int = 8
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0


class NUTSDraws(NamedTuple):
    """One transition's random numbers, for C chains and depth D."""

    p0: torch.Tensor       # (C, K, 3) standard normal momentum
    right: torch.Tensor    # (C, D) bool: doubling d extends forward in time
    u_leaf: torch.Tensor   # (C, D, 2^(D-1)) uniform: the multinomial pick at leaf i of doubling d
    u_merge: torch.Tensor  # (C, D) uniform: the progressive merge after doubling d


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) mean MH statistic over visited leaves (for DA)
    diverged: torch.Tensor     # (C,)
    depth: torch.Tensor        # (C,) tree depth reached
    n_leaves: torch.Tensor     # (C,) leapfrog steps taken


class _Z(NamedTuple):
    """Phase-space points of every chain with their potential and gradient."""

    theta: torch.Tensor
    p: torch.Tensor
    u: torch.Tensor
    grad: torch.Tensor


class _Subtree(NamedTuple):
    z_edge: _Z
    z_prop: _Z
    log_sum_w: torch.Tensor
    sum_acc: torch.Tensor
    n_leaves: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def _select(pred: torch.Tensor, a: _Z, b: _Z) -> _Z:
    p3 = pred.view(-1, 1, 1)
    return _Z(torch.where(p3, a.theta, b.theta), torch.where(p3, a.p, b.p),
              torch.where(pred, a.u, b.u), torch.where(p3, a.grad, b.grad))


def checkpoint_slots(i: int) -> tuple[int | None, range]:
    """Leaf i's checkpoint slot (even i; None for odd i) and the slots its
    u-turn check reads (odd i; empty for even i)."""
    pop = bin(i).count("1")
    if i % 2 == 0:
        return pop, range(0)
    t = ((i + 1) & -(i + 1)).bit_length() - 1  # trailing ones of i
    return None, range(pop - t, bin(i >> 1).count("1") + 1)


def plain_leaf(grad_fn: Callable) -> Callable:
    """One plain leapfrog step with the fused kernel's leaf contract,
    ``leaf(theta, p, eps, inv_mass, mask, grad) -> (theta, p, u, grad)``,
    over a batched ``grad_fn``; eps is per chain (C,)."""
    traj = plain_trajectory(grad_fn)
    return lambda th, p, eps, im, m, grad: traj(th, p, eps, im, m, 1, grad)  # noqa: E731


def _build_subtree(leaf, z_start: _Z, depth: int, eps_signed, inv_mass, mask, h0,
                   live: torch.Tensor, log_u_leaf, div_threshold: float) -> _Subtree:
    """2^depth new leaves from z_start in the direction of each chain's
    eps_signed, for the chains in ``live``; a chain stops at the leaf where
    it turns or diverges and keeps its values from then on."""
    sign = torch.sign(eps_signed).view(-1, 1, 1)
    z, z_prop = z_start, z_start
    inf = torch.full_like(h0, float("inf"))
    zero = torch.zeros_like(h0)
    log_sum_w = -inf
    sum_acc = zero
    n_leaves = torch.zeros_like(live, dtype=torch.int32)
    turning = torch.zeros_like(live)
    diverging = torch.zeros_like(live)
    ck_theta, ck_v = {}, {}
    for i in range(1 << depth):
        z_new = _Z(*leaf(z.theta, z.p, eps_signed, inv_mass, mask, z.grad))
        v_new = inv_mass * z_new.p
        h = z_new.u + 0.5 * torch.sum(v_new * z_new.p, dim=(-2, -1))   # kinetic_energy
        delta = torch.where(torch.isfinite(h), h - h0, inf)
        log_w = -delta                       # -inf for divergent/NaN leaves
        log_sum_w_new = torch.logaddexp(log_sum_w, log_w)
        take = log_u_leaf[:, i] < log_w - log_sum_w_new
        z = _select(live, z_new, z)
        z_prop = _select(live & take, z_new, z_prop)
        log_sum_w = torch.where(live, log_sum_w_new, log_sum_w)
        sum_acc = sum_acc + torch.where(live, torch.exp(torch.clamp(log_w, max=0.0)), zero)
        n_leaves = n_leaves + live

        stop = delta > div_threshold
        diverging = diverging | (live & stop)
        store, check = checkpoint_slots(i)
        if store is not None:
            ck_theta[store], ck_v[store] = z_new.theta, v_new
        if check:
            turn = None
            for s in check:
                dtheta = sign * (z_new.theta - ck_theta[s])  # time-ordered
                t = ((torch.sum(dtheta * ck_v[s], dim=(-2, -1)) < 0)
                     | (torch.sum(dtheta * v_new, dim=(-2, -1)) < 0))
                turn = t if turn is None else turn | t
            turning = turning | (live & turn)
            stop = stop | turn
        live = live & ~stop
    return _Subtree(z, z_prop, log_sum_w, sum_acc, n_leaves, turning, diverging)


def nuts_transition(states: ChainState, eps, inv_mass: torch.Tensor, mask: torch.Tensor,
                    draws: NUTSDraws, leaf: Callable, max_depth: int,
                    divergence_threshold: float = 1000.0):
    """One NUTS transition of every chain on the given draws.

    ``eps`` is a scalar (the driver's adapted step size); ``mask`` (K,) or
    (C, K) freezes dead catalog slots by zeroing their momentum."""
    theta = states.theta
    c = theta.shape[0]
    eps = torch.as_tensor(eps, dtype=theta.dtype, device=theta.device).expand(c)
    p0 = draws.p0 / torch.sqrt(inv_mass) * mask[..., None]
    z0 = _Z(theta, p0, states.u, states.grad)
    h0 = states.u + kinetic_energy(p0, inv_mass)
    log_u_leaf, log_u_merge = torch.log(draws.u_leaf), torch.log(draws.u_merge)

    z_minus = z_plus = z_prop = z0
    log_sum_w = torch.zeros_like(h0)
    sum_acc = torch.zeros_like(h0)
    depth = torch.zeros(c, dtype=torch.int32, device=theta.device)
    n_leaves = torch.zeros_like(depth)
    turning = torch.zeros(c, dtype=torch.bool, device=theta.device)
    diverging = torch.zeros_like(turning)
    for d in range(max_depth):
        building = ~(turning | diverging)
        if d and not bool(building.any()):
            break
        right = draws.right[:, d]
        z_edge = _select(right, z_plus, z_minus)
        eps_signed = torch.where(right, eps, -eps)
        sub = _build_subtree(leaf, z_edge, d, eps_signed, inv_mass, mask, h0, building,
                             log_u_leaf[:, d], divergence_threshold)
        ok = building & ~sub.turning & ~sub.diverging
        z_plus = _select(right & ok, sub.z_edge, z_plus)
        z_minus = _select(~right & ok, sub.z_edge, z_minus)
        # biased progressive merge: take the subtree's proposal w.p. min(1, W_new/W_old)
        take = ok & (log_u_merge[:, d] < sub.log_sum_w - log_sum_w)
        z_prop = _select(take, sub.z_prop, z_prop)
        log_sum_w = torch.where(ok, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w)
        # full-trajectory u-turn check (time-ordered endpoints)
        dtheta = z_plus.theta - z_minus.theta
        turn_full = ((torch.sum(dtheta * inv_mass * z_minus.p, dim=(-2, -1)) < 0)
                     | (torch.sum(dtheta * inv_mass * z_plus.p, dim=(-2, -1)) < 0))
        turning = turning | sub.turning | (ok & turn_full)
        diverging = diverging | sub.diverging
        depth = depth + building.to(torch.int32)
        sum_acc = sum_acc + sub.sum_acc
        n_leaves = n_leaves + sub.n_leaves

    new = ChainState(z_prop.theta, z_prop.u, z_prop.grad)
    info = NUTSInfo(sum_acc / torch.clamp(n_leaves, min=1).to(sum_acc.dtype), diverging,
                    depth, n_leaves)
    return new, info


def draw_nuts(generator: torch.Generator, theta: torch.Tensor, max_depth: int) -> NUTSDraws:
    """A transition's draws for theta's chains, in NUTSDraws' field order."""
    c, dev = theta.shape[0], theta.device
    p0 = torch.randn(theta.shape, generator=generator, dtype=theta.dtype, device=dev)
    right = torch.rand((c, max_depth), generator=generator, device=dev) < 0.5
    u_leaf = torch.rand((c, max_depth, 1 << (max_depth - 1)), generator=generator, device=dev)
    u_merge = torch.rand((c, max_depth), generator=generator, device=dev)
    return NUTSDraws(p0, right, u_leaf, u_merge)


def make_nuts_kernel(leaf: Callable, mask: torch.Tensor, config: NUTSConfig,
                     generator: torch.Generator):
    """Batched kernel with driver.py's signature (states, eps, inv_mass)."""

    def kernel(states: ChainState, eps, inv_mass):
        draws = draw_nuts(generator, states.theta, config.max_depth)
        return nuts_transition(states, eps, inv_mass, mask, draws, leaf, config.max_depth,
                               config.divergence_threshold)

    return kernel


def run_nuts(generator: torch.Generator, grad_fn: Callable, theta0: torch.Tensor,
             mask: torch.Tensor, n_samples: int, n_warmup: int,
             config: NUTSConfig = NUTSConfig(), thin: int = 1, leaf: Callable | None = None,
             block_size: int | None = None, checkpoint_path: str | None = None,
             resume: bool = False, logger=None):
    """init -> warmup -> sample; every leaf on ``leaf`` (the fused kernel's
    leaf contract), the plain step over ``grad_fn`` when None.  block_size,
    checkpoint_path, resume and logger: driver.run_mcmc's.  A transition
    draws all its random numbers at its start, so a block boundary never
    splits a tree."""
    kernel = make_nuts_kernel(leaf or plain_leaf(grad_fn), mask, config, generator)
    return run_mcmc(kernel, grad_fn, theta0, n_samples, n_warmup,
                    step_size=config.step_size, target_accept=config.target_accept,
                    thin=thin, block_size=block_size, checkpoint_path=checkpoint_path,
                    resume=resume, logger=logger, generator=generator)
