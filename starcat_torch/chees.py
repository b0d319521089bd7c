"""ChEES-HMC head (port of starcat/chees.py): jittered HMC whose trajectory
length T adapts by Adam ascent on log T of the ChEES criterion (Hoffman,
Radul & Sountsov 2021).  Every chain runs the same number of leapfrog steps
per iteration, n = clip(ceil(u_i T / eps), 1, max_leapfrog) with u_i the
base-2 Halton sequence, so all chains stay in lockstep.

Step size adapts by dual averaging and the diagonal mass by pooled Welford,
in the three-phase schedule of driver.warmup.  After warmup a T-drift gate
extends the ascent while log T still moves, and an equilibration gate runs
discarded block pairs until the chains agree on U and total log flux.  The
relocate move (transdim.relocate_step) runs every ``relocate_every``
iterations in the equilibration blocks and the sampling leg.

One iteration is a pure function of its random inputs (``p0``, ``u_acc``;
:func:`_chees_iteration`).  The adapted step count is a device int32 that
the fused kernel reads (:func:`make_fused_leapfrog_impl`), so the kernel
path never waits for the host inside warmup or sampling.

Durability and records follow the reference: a ChEESBlockCheckpoint after
warmup and its gates and after every sampling block (chees_sample_blocked),
a resume that restores eps, mass, T, the warmup divergences and the
generator, and the warmup's records (T extensions, equilibration stages,
three phases, its end) and one a block for ``logger``.

Under a device mesh (``mesh``, dist.py) each rank runs its chains' draws
and trajectories; the criterion's gradient, the pooled acceptance and
Welford moments, the divergence counts and the equilibration statistic are
computed from the gathered chains, so every rank adapts eps, mass and T as
the one-process run does.
"""
from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import torch

from . import dist, metrics
from .adapt import (
    AdamState,
    adam_update,
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .checkpoint import restore_state, save_state
from .driver import (
    ChainState,
    SampleResult,
    block_sizes,
    concat_blocks,
    init_chain_states,
    log_warmup_phases,
)
from .dispatch import make_leapfrog_dyn
from .integrators import kinetic_energy, plain_trajectory
from .potential import log_likelihood
from .transdim import relocate_step


class ChEESConfig(NamedTuple):
    step_size: float = 0.1
    traj_length: float = 1.0        # initial trajectory length T
    target_accept: float = 0.75
    adam_lr: float | None = None    # None: resolve_adam_lr(n_chains)
    max_leapfrog: int = 1024        # hard cap on steps per iteration
    divergence_threshold: float = 1000.0
    # T-convergence gate: while |drift of mean log T| between the halves of
    # the last warmup phase exceeds t_drift_tol, run up to
    # max_warmup_extensions extra T-adaptation blocks at fixed eps and mass
    t_drift_tol: float = 0.25
    max_warmup_extensions: int = 2
    # equilibration gate: discarded block pairs until _eq_disagreement of
    # per-chain block means is <= eq_tol (each further pair at doubled T,
    # capped at 4x); 0 stages disables it
    eq_tol: float = 0.5
    max_eq_stages: int = 2
    # one relocate attempt per chain every relocate_every iterations
    # (equilibration blocks and sampling); 0 disables
    relocate_every: int = 1


class ChEESInfo(NamedTuple):
    accept_prob: torch.Tensor
    diverged: torch.Tensor
    n_leapfrog: torch.Tensor
    traj_length: torch.Tensor


# log T confined to T in [1e-3, 1e3] so a run of bad Adam steps cannot push
# n_steps = ceil(u T / eps) into absurd territory
_LOG_T_MIN, _LOG_T_MAX = -6.9, 6.9


def _halton2(i: int) -> float:
    """Base-2 radical inverse of i (16 bits) in (0, 1)."""
    return sum(((i >> b) & 1) * 0.5 ** (b + 1.0) for b in range(16)) + 2.0 ** -17


def resolve_adam_lr(n_chains: int) -> float:
    """Chain-count-aware log-T Adam learning rate: 0.025 * sqrt(C / 256)
    clipped to [0.025, 0.05] (the pooled gradient's noise falls ~1/sqrt(C))."""
    return float(min(0.05, max(0.025, 0.025 * math.sqrt(n_chains / 256.0))))


def _chees_iteration(states: ChainState, grad_fn: Callable, eps, inv_mass,
                     mask, u_jit: float, traj_length, max_leapfrog: int,
                     div_threshold: float, p0: torch.Tensor,
                     u_acc: torch.Tensor, leapfrog_impl: Callable | None = None,
                     mesh=None):
    """One jittered-HMC sweep over all chains; returns (states, info,
    g_logT), the pooled ChEES gradient with respect to log T.

    p0 (C, K, 3) standard normal and u_acc (C,) uniform are the iteration's
    random inputs.  leapfrog_impl: a fused trajectory with signature
    (theta, p, u, grad, eps, n_steps, inv_mass, mask) -> (theta, p, u,
    grad); the default is the plain lockstep leapfrog over grad_fn.  Under
    a ``mesh`` the states and draws are this rank's and the gradient is
    taken over every rank's chains.
    """
    mask3 = mask[..., None]
    t = u_jit * traj_length
    n_steps = torch.clamp(torch.ceil(t / eps), 1, max_leapfrog).to(torch.int32)

    p0 = p0 / torch.sqrt(inv_mass) * mask3
    h0 = states.u + kinetic_energy(p0, inv_mass)
    with metrics.span("chees.trajectory"):
        if leapfrog_impl is None:
            theta_n, p_n, u_n, grad_n = plain_trajectory(grad_fn)(
                states.theta, p0, eps, inv_mass, mask, n_steps, states.grad)
        else:
            theta_n, p_n, u_n, grad_n = leapfrog_impl(
                states.theta, p0, states.u, states.grad, eps, n_steps, inv_mass,
                mask)
    metrics.count("chees.leapfrog_steps", n_steps, states.theta.shape[0])
    h1 = u_n + kinetic_energy(p_n, inv_mass)
    e_err = h1 - h0
    e_err = torch.where(torch.isfinite(e_err), e_err, torch.full_like(e_err, math.inf))
    accept_prob = torch.exp(torch.clamp(-e_err, max=0.0))
    diverged = e_err > div_threshold

    accept = u_acc < accept_prob
    acc3 = accept[:, None, None]
    theta = torch.where(acc3, theta_n, states.theta)
    u = torch.where(accept, u_n, states.u)
    grad = torch.where(acc3, grad_n, states.grad)

    # ChEES gradient estimator.  Finite-chain guard: a chain whose
    # trajectory overflowed leaves NaN/Inf in theta_n/p_n; its accept_prob
    # is already 0, but 0 * NaN = NaN would still poison the pooled mean and,
    # through Adam, every later trajectory length.  Mask such chains out.
    ok = torch.isfinite(e_err) & torch.all(
        torch.isfinite(theta_n) & torch.isfinite(p_n), dim=2).all(dim=1)
    g_logT = _chees_grad_log_t(
        *dist.gather((states.theta, theta_n, p_n, accept_prob, ok), mesh), inv_mass, t)
    info = ChEESInfo(accept_prob, diverged, n_steps, traj_length)
    return ChainState(theta, u, grad), info, g_logT


def _chees_grad_log_t(theta0, theta_n, p_n, accept_prob, ok, inv_mass, t):
    """The pooled ChEES gradient with respect to log T over the chains of
    (theta0, the proposals theta_n and p_n, their acceptance), the chains
    with a non-finite trajectory (ok False) left out."""
    ok3 = ok[:, None, None]
    theta_f = torch.where(ok3, theta_n, torch.zeros_like(theta_n))
    p_f = torch.where(ok3, p_n, torch.zeros_like(p_n))
    n_ok = torch.clamp(ok.sum(), min=1)
    mu0 = theta0.mean(dim=0, keepdim=True)
    mu1 = theta_f.sum(dim=0, keepdim=True) / n_ok
    dsq = (((theta_f - mu1) ** 2).sum(dim=(1, 2))
           - ((theta0 - mu0) ** 2).sum(dim=(1, 2)))
    proj = ((theta_f - mu1) * (inv_mass * p_f)).sum(dim=(1, 2))
    w = accept_prob * ok
    g_t = (w * dsq * proj).sum() / torch.clamp(w.sum(), min=1e-6)
    g_logT = g_t * t  # chain rule through t = u_jit * T
    return torch.where(torch.isfinite(g_logT), g_logT, torch.zeros_like(g_logT))


def _draw(generator: torch.Generator, theta: torch.Tensor, mesh=None):
    """The iteration's random inputs for all chains: p0, then u_acc (under a
    ``mesh`` at full width, keeping this rank's rows)."""
    def draws(c):
        return (torch.randn((c,) + theta.shape[1:], generator=generator, dtype=theta.dtype,
                            device=theta.device),
                torch.rand((c,), generator=generator, device=theta.device))

    return dist.draw(draws, theta.shape[0], mesh)


def make_chees_relocate(spec, image: torch.Tensor, prior,
                        generator: torch.Generator, resid_floor: float = 1e-2,
                        flux_sigma: float | None = 0.1,
                        pos_sigma: float = 0.12, mesh=None):
    """Batch relocate sweep: one transdim.relocate_step attempt per chain in
    the data-driven mode (matched-filter flux and centroid-refined
    sub-pixel position).  Returns relocate_fn(theta (C, K, 3), mask (K,)) ->
    (theta', accepted (C,)); its random inputs are drawn in a fixed order
    (under a ``mesh`` at full width, keeping this rank's rows)."""
    tiny = torch.finfo(torch.float32).tiny

    def gumbel(shape, device):
        u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    def sweep(theta, mask):
        dev = theta.device

        def draws(c):
            return (gumbel((c, theta.shape[1]), dev),
                    gumbel((c, spec.height * spec.width), dev),
                    torch.rand((c, 2), generator=generator, device=dev),
                    torch.randn((c,), generator=generator, device=dev),
                    torch.rand((c,), generator=generator, device=dev))

        g_slot, g_pix, u_sub, z, u_acc = dist.draw(draws, theta.shape[0], mesh)
        lls = log_likelihood(theta, mask, spec, image)
        theta_new, _, _, info = relocate_step(
            theta, mask, lls, prior, spec, image, g_slot, g_pix, u_sub, z,
            u_acc, resid_floor, flux_sigma, pos_sigma)
        return theta_new, info.accepted

    return sweep


def make_fused_leapfrog_impl(spec, image: torch.Tensor, prior, kmax: int):
    """Trajectory impl for _chees_iteration on the fused CUDA kernel with a
    runtime step count (B2's contract, on B1's kernel or, on crowded fields,
    on B5's: dispatch.make_leapfrog_dyn): the adapted n_steps stays a device
    int32 that the kernel reads, so one build serves every length."""
    fused = make_leapfrog_dyn(spec, image, prior, kmax)

    def impl(theta, p, u, grad, eps, n_steps, inv_mass, mask):
        return fused(theta, p, eps, inv_mass, mask, n_steps, grad)

    return impl


class ChEESWarmupResult(NamedTuple):
    states: ChainState
    step_size: torch.Tensor    # () adapted eps (dual-averaging eps_bar)
    inv_mass: torch.Tensor     # param-shaped diagonal inverse mass
    n_divergent: torch.Tensor  # () warmup divergences
    traj_drift: torch.Tensor   # () |mean log T (2nd half) - (1st half)|
    log_T: torch.Tensor        # () adapted log trajectory length
    adam: AdamState
    phase_accept: torch.Tensor  # (3,) mean acceptance of each phase
    phase_eps: torch.Tensor     # (3,) dual-averaging eps at each phase's end


def _chees_warmup(states: ChainState, grad_fn: Callable, mask, n_warmup: int,
                  config: ChEESConfig, generator: torch.Generator,
                  leapfrog_impl=None, mesh=None) -> ChEESWarmupResult:
    """Three-phase warmup: eps by pooled dual averaging, diagonal mass by
    pooled Welford, T by Adam ascent on the ChEES criterion.  Phase 3 runs
    as two halves, whose mean log T give the drift."""
    if config.adam_lr is None:
        config = config._replace(adam_lr=resolve_adam_lr(
            dist.n_global(states.theta.shape[0], mesh)))
    dev = states.theta.device
    n1 = max(n_warmup * 15 // 100, 1)
    n3 = max(n_warmup * 25 // 100, 1)
    n2 = max(n_warmup - n1 - n3, 1)

    def phase(carry, accumulate: bool, n: int, offset: int):
        """n iterations from Halton index offset; returns (carry, mean log
        T, mean acceptance)."""
        st, da, wf, inv_mass, log_T, adam, ndiv = carry
        lt = torch.zeros((), device=dev)
        acc = torch.zeros((), device=dev)
        for i in range(offset, offset + n):
            p0, u_acc = _draw(generator, st.theta, mesh)
            st, info, g_logT = _chees_iteration(
                st, grad_fn, torch.exp(da.log_eps), inv_mass, mask,
                _halton2(i), torch.exp(log_T), config.max_leapfrog,
                config.divergence_threshold, p0, u_acc, leapfrog_impl, mesh)
            aprob, div = dist.gather((info.accept_prob, info.diverged), mesh)
            a = aprob.mean()
            acc = acc + a
            da = da_update(da, a, target=config.target_accept)
            adam, delta = adam_update(adam, g_logT, config.adam_lr)
            log_T = torch.clamp(log_T + delta, _LOG_T_MIN, _LOG_T_MAX)
            if accumulate:
                wf = welford_update_batch(wf, dist.gather(st.theta, mesh))
            lt = lt + log_T
            ndiv = ndiv + div.sum()
        return (st, da, wf, inv_mass, log_T, adam, ndiv), lt / n, acc / n

    z = torch.zeros((), device=dev)
    log_T = torch.clamp(z + math.log(config.traj_length), _LOG_T_MIN, _LOG_T_MAX)
    carry = (states, da_init(config.step_size, dev),
             welford_init(states.theta.shape[1:], dev),
             torch.ones(states.theta.shape[1:], dtype=torch.float32, device=dev),
             log_T, AdamState(z, z, z), torch.zeros((), dtype=torch.int64, device=dev))

    carry, _, a1 = phase(carry, False, n1, 0)
    e1 = torch.exp(carry[1].log_eps)
    carry, _, a2 = phase(carry, True, n2, n1)
    st, da, wf, _, log_T, adam, ndiv = carry
    e2 = torch.exp(da.log_eps)
    carry = (st, da_restart(da), wf, welford_variance(wf), log_T, adam, ndiv)
    n3a = max(n3 // 2, 1)
    n3b = max(n3 - n3a, 1)
    carry, lt_a, a3a = phase(carry, False, n3a, n1 + n2)
    carry, lt_b, a3b = phase(carry, False, n3b, n1 + n2 + n3a)
    st, da, _, inv_mass, log_T, adam, ndiv = carry
    a3 = (a3a * n3a + a3b * n3b) / (n3a + n3b)
    return ChEESWarmupResult(st, torch.exp(da.log_eps_bar), inv_mass, ndiv,
                             torch.abs(lt_b - lt_a), log_T, adam,
                             torch.stack([a1, a2, a3]),
                             torch.stack([e1, e2, torch.exp(da.log_eps)]))


def _chees_extend(states: ChainState, grad_fn: Callable, mask, n_steps: int,
                  config: ChEESConfig, eps, inv_mass, log_T, adam: AdamState,
                  generator: torch.Generator, leapfrog_impl=None, mesh=None):
    """Extra T-adaptation block at fixed (eps, inv_mass), run as two halves
    so the new drift falls out.  Halton indices restart from 0.
    Returns (states, log_T, adam, traj_drift, n_divergent)."""
    if config.adam_lr is None:
        config = config._replace(adam_lr=resolve_adam_lr(
            dist.n_global(states.theta.shape[0], mesh)))
    ndiv = torch.zeros((), dtype=torch.int64, device=states.theta.device)

    def half(st, log_T, adam, ndiv, n, offset):
        lt = torch.zeros_like(log_T)
        for i in range(offset, offset + n):
            p0, u_acc = _draw(generator, st.theta, mesh)
            st, info, g_logT = _chees_iteration(
                st, grad_fn, eps, inv_mass, mask, _halton2(i),
                torch.exp(log_T), config.max_leapfrog,
                config.divergence_threshold, p0, u_acc, leapfrog_impl, mesh)
            adam, delta = adam_update(adam, g_logT, config.adam_lr)
            log_T = torch.clamp(log_T + delta, _LOG_T_MIN, _LOG_T_MAX)
            lt = lt + log_T
            ndiv = ndiv + dist.gather(info.diverged, mesh).sum()
        return st, log_T, adam, lt / n, ndiv

    na = max(n_steps // 2, 1)
    nb = max(n_steps - na, 1)
    st, log_T, adam, lt_a, ndiv = half(states, log_T, adam, ndiv, na, 0)
    st, log_T, adam, lt_b, ndiv = half(st, log_T, adam, ndiv, nb, na)
    return st, log_T, adam, torch.abs(lt_b - lt_a), ndiv


def _eq_disagreement(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Chain-disagreement statistic of two consecutive equal-length block
    means m1, m2 (each (C,)): Var_chains((m1+m2)/2) over mean((m2-m1)^2)/2,
    minus its stationary value 1/2.  It estimates the variance of per-chain
    offsets in units of block-mean noise, with no autocorrelation estimate.
    Like the reference it takes var(ddof=1), so it is NaN at one chain."""
    num = torch.var(0.5 * (m1 + m2), correction=1)
    den = 0.5 * torch.mean((m2 - m1) ** 2)
    return torch.clamp(num / torch.clamp(den, min=1e-12) - 0.5, min=0.0)


def _maybe_relocate(st: ChainState, i: int, grad_fn: Callable, mask,
                    config: ChEESConfig, relocate_fn) -> ChainState:
    """One relocate sweep when iteration i hits the cadence; (u, grad) are
    recomputed so the next trajectory starts from the moved configuration."""
    if relocate_fn is None or config.relocate_every <= 0 or i % config.relocate_every:
        return st
    with metrics.span("chees.relocate"):
        theta_new, accepted = relocate_fn(st.theta, mask)
        metrics.count("chees.relocations", st.theta.shape[0])
        metrics.count("chees.relocations_accepted", accepted)
        u, g = grad_fn(theta_new)
    return ChainState(theta_new, u, g)


def _chees_equilibrate(states: ChainState, grad_fn: Callable, mask,
                       n_steps: int, config: ChEESConfig, eps, inv_mass, traj,
                       generator: torch.Generator, leapfrog_impl=None,
                       relocate_fn=None, mesh=None):
    """One discarded equilibration block at fixed (eps, inv_mass, traj).
    Returns (states, per-chain mean U (C,), per-chain mean total log flux
    (C,), n_divergent); Halton indices restart from 0.  Under a ``mesh``
    the states are this rank's and the means every rank's chains'."""
    st = states
    dev = st.theta.device
    ndiv = torch.zeros((), dtype=torch.int64, device=dev)
    u_sum = torch.zeros_like(st.u)
    f_sum = torch.zeros_like(st.u)
    for i in range(n_steps):
        p0, u_acc = _draw(generator, st.theta, mesh)
        st, info, _ = _chees_iteration(
            st, grad_fn, eps, inv_mass, mask, _halton2(i), traj,
            config.max_leapfrog, config.divergence_threshold, p0, u_acc,
            leapfrog_impl, mesh)
        st = _maybe_relocate(st, i, grad_fn, mask, config, relocate_fn)
        ndiv = ndiv + dist.gather(info.diverged, mesh).sum()
        u_sum = u_sum + st.u
        f_sum = f_sum + torch.sum(st.theta[:, :, 2] * mask, dim=1)
    return st, *dist.gather((u_sum / n_steps, f_sum / n_steps), mesh), ndiv


def chees_sample(states: ChainState, grad_fn: Callable, mask, n_samples: int,
                 eps, inv_mass, traj, config: ChEESConfig,
                 generator: torch.Generator, leapfrog_impl=None,
                 start: int = 0, relocate_fn=None, mesh=None) -> SampleResult:
    """Sampling leg at fixed adapted (eps, inv_mass, T); the i-th iteration
    overall uses Halton index start + i (run_chees passes n_warmup).
    The relocate cadence keys off the same global index."""
    st = states
    c = st.theta.shape[0]
    dev = st.theta.device
    thetas = torch.empty((c, n_samples) + tuple(st.theta.shape[1:]),
                         dtype=st.theta.dtype, device=dev)
    aprob = torch.empty((c, n_samples), dtype=torch.float32, device=dev)
    div = torch.empty((c, n_samples), dtype=torch.bool, device=dev)
    for n in range(n_samples):
        i = start + n
        with metrics.span("chees.iteration"):
            p0, u_acc = _draw(generator, st.theta, mesh)
            st, info, _ = _chees_iteration(
                st, grad_fn, eps, inv_mass, mask, _halton2(i), traj,
                config.max_leapfrog, config.divergence_threshold, p0, u_acc,
                leapfrog_impl, mesh)
            st = _maybe_relocate(st, i, grad_fn, mask, config, relocate_fn)
            thetas[:, n] = st.theta
            aprob[:, n] = info.accept_prob
            div[:, n] = info.diverged
    return SampleResult(thetas, aprob, div, st)


class ChEESBlockCheckpoint(NamedTuple):
    """Written after warmup and its gates (done = 0) and after every
    sampling block: the chains, the draws done, the fixed adapted eps, mass
    and trajectory length, the warmup's divergences (so a resumed run
    reports the same count) and the run generator's state.  The Halton
    index of the next iteration is n_warmup + done."""

    states: ChainState
    done: int
    step_size: torch.Tensor  # ()
    inv_mass: torch.Tensor   # param-shaped
    traj: torch.Tensor       # () adapted trajectory length T
    warmup_ndiv: int
    generator: torch.Generator


def chees_checkpoint_like(states: ChainState,
                          generator: torch.Generator) -> ChEESBlockCheckpoint:
    """Structure donor for restore_state on a ChEESBlockCheckpoint."""
    dev = states.theta.device
    z = torch.zeros((), device=dev)
    return ChEESBlockCheckpoint(states, 0, z, torch.ones(states.theta.shape[1:], device=dev),
                                z, 0, generator)


def chees_sample_blocked(states: ChainState, grad_fn: Callable, mask, n_samples: int,
                         eps, inv_mass, traj, config: ChEESConfig,
                         generator: torch.Generator, leapfrog_impl=None,
                         n_warmup: int = 0, block_size: int = 250,
                         checkpoint_path: str | None = None, start_done: int = 0,
                         logger=None, warmup_ndiv: int = 0,
                         relocate_fn=None, mesh=None) -> SampleResult:
    """chees_sample in blocks, the same bits as one call (block b starts at
    Halton index n_warmup + done): after each block one sync reads its
    summary, ``logger`` gets a ``sampling_block`` record and then, with
    ``checkpoint_path``, a ChEESBlockCheckpoint is written.  start_done:
    draws completed by an earlier process."""
    parts = []
    done = start_done
    for n in block_sizes(n_samples, block_size, start_done):
        res = chees_sample(states, grad_fn, mask, n, eps, inv_mass, traj, config,
                           generator, leapfrog_impl, start=n_warmup + done,
                           relocate_fn=relocate_fn, mesh=mesh)
        states = res.final_states
        parts.append((res.thetas, res.accept_prob, res.diverged))
        done += n
        if logger is not None:
            aprob, div = dist.gather((res.accept_prob, res.diverged), mesh)
            acc, ndiv, t = torch.stack([aprob.mean(), div.sum().float(),
                                        torch.as_tensor(traj, dtype=torch.float32)]).tolist()
            logger.log("sampling_block", done=done, n_total=n_samples, accept=acc,
                       divergences=int(ndiv), traj_length=t)
        if checkpoint_path is not None:
            save_state(checkpoint_path, ChEESBlockCheckpoint(
                dist.gather(states, mesh), done, eps, inv_mass, traj, warmup_ndiv,
                generator), mesh)
    c, dev = states.theta.shape[0], states.theta.device
    empty = (torch.zeros((c, 0) + tuple(states.theta.shape[1:]), device=dev),
             torch.zeros((c, 0), device=dev), torch.zeros((c, 0), dtype=torch.bool, device=dev))
    thetas, aprob, div = concat_blocks(parts, empty)
    return SampleResult(thetas, aprob, div, states)


def run_chees(generator: torch.Generator, grad_fn: Callable,
              theta0: torch.Tensor, mask, n_samples: int, n_warmup: int,
              config: ChEESConfig = ChEESConfig(), leapfrog_impl=None,
              relocate_fn=None, block_size: int | None = None,
              checkpoint_path: str | None = None, resume: bool = False,
              logger=None, mesh=None):
    """init -> warmup (eps, mass, T) -> T-drift gate -> equilibration gate
    -> jittered sampling.  Returns (SampleResult, adaptation dict).

    block_size, checkpoint_path, resume and logger give ChEES the durability
    of the other MCMC heads (driver.run_mcmc): blocked sampling with a
    checkpoint after warmup and after every block, per-window records, and
    a resume from the last completed block with the same bits as an
    uninterrupted run.  A resumed run's dict holds only the restored eps,
    mass, T and warmup divergences.

    mesh: theta0 holds this rank's chains (dist.shard of the full start);
    the returned SampleResult holds every chain's draws, on every rank."""
    if config.adam_lr is None:
        config = config._replace(adam_lr=resolve_adam_lr(dist.n_global(theta0.shape[0], mesh)))
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        full = dist.gather(theta0, mesh)
        like = chees_checkpoint_like(ChainState(
            full, full.new_zeros(full.shape[0]), torch.zeros_like(full)), generator)
        ck = restore_state(checkpoint_path, like, theta0.device)
        res = chees_sample_blocked(
            dist.shard(ck.states, mesh), grad_fn, mask, n_samples, ck.step_size,
            ck.inv_mass, ck.traj, config, generator, leapfrog_impl, n_warmup=n_warmup,
            block_size=block_size or 250, checkpoint_path=checkpoint_path,
            start_done=ck.done, logger=logger, warmup_ndiv=ck.warmup_ndiv,
            relocate_fn=relocate_fn, mesh=mesh)
        return dist.gather(res, mesh), {"step_size": ck.step_size, "inv_mass": ck.inv_mass,
                     "traj_length": ck.traj, "warmup_divergences": ck.warmup_ndiv}
    states = init_chain_states(theta0, grad_fn)
    wu = _chees_warmup(states, grad_fn, mask, n_warmup, config, generator,
                       leapfrog_impl, mesh)
    st, eps, inv_mass = wu.states, wu.step_size, wu.inv_mass
    ndiv, log_T, adam, drift = wu.n_divergent, wu.log_T, wu.adam, wu.traj_drift

    # T-convergence gate: extend the ascent while log T is still moving
    n_ext = 0
    ext_steps = max(n_warmup // 4, 8)
    while float(drift) > config.t_drift_tol and n_ext < config.max_warmup_extensions:
        st, log_T, adam, drift, ndiv_ext = _chees_extend(
            st, grad_fn, mask, ext_steps, config, eps, inv_mass, log_T, adam,
            generator, leapfrog_impl, mesh)
        ndiv = ndiv + ndiv_ext
        n_ext += 1
        if logger is not None:
            t, d = torch.stack([torch.exp(log_T), drift]).tolist()
            logger.log("warmup_t_extension", extension=n_ext, traj_length=t, traj_drift=d)
    traj = torch.exp(log_T)
    converged = bool(float(drift) <= config.t_drift_tol)

    # equilibration gate: discarded block pairs until the chains agree
    eq_stages = 0
    eq_disagreement = None
    if config.max_eq_stages > 0 and config.eq_tol > 0:
        eq_steps = max(n_warmup // 6, 16)
        eq_factor = 1.0
        while eq_stages < config.max_eq_stages:
            st, u1, f1, nd1 = _chees_equilibrate(
                st, grad_fn, mask, eq_steps, config, eps, inv_mass,
                traj * eq_factor, generator, leapfrog_impl, relocate_fn, mesh)
            st, u2, f2, nd2 = _chees_equilibrate(
                st, grad_fn, mask, eq_steps, config, eps, inv_mass,
                traj * eq_factor, generator, leapfrog_impl, relocate_fn, mesh)
            ndiv = ndiv + nd1 + nd2
            eq_stages += 1
            eq_disagreement = float(torch.maximum(_eq_disagreement(u1, u2),
                                                  _eq_disagreement(f1, f2)))
            if logger is not None:
                logger.log("warmup_eq_stage", stage=eq_stages,
                           disagreement=eq_disagreement, traj_factor=eq_factor)
            if eq_disagreement <= config.eq_tol:
                break
            eq_factor = min(eq_factor * 2.0, 4.0)
        if logger is not None and eq_disagreement > config.eq_tol:
            logger.log("warning", kind="equilibration_unconverged",
                       eq_disagreement=eq_disagreement, tol=config.eq_tol,
                       msg="chains still disagree on pooled summaries after the "
                           "equilibration budget; raise max_eq_stages or n_warmup")

    n_div = int(ndiv)
    if logger is not None:
        log_warmup_phases(logger, wu.phase_accept, wu.phase_eps)
        e, t, d = torch.stack([eps, traj, drift]).tolist()
        logger.log("warmup_complete", step_size=e, traj_length=t, divergences=n_div,
                   traj_drift=d, traj_converged=converged, warmup_extensions=n_ext)
        if not converged:
            logger.log("warning", kind="traj_adaptation_unconverged", traj_drift=d,
                       tol=config.t_drift_tol,
                       msg="ChEES trajectory-length ascent still moving after warmup "
                           "+ extensions; raise n_warmup or max_warmup_extensions")
    if checkpoint_path is not None:  # warmup is the expensive leg: save it
        save_state(checkpoint_path, ChEESBlockCheckpoint(
            dist.gather(st, mesh), 0, eps, inv_mass, traj, n_div, generator), mesh)
    if block_size is not None:
        res = chees_sample_blocked(
            st, grad_fn, mask, n_samples, eps, inv_mass, traj, config, generator,
            leapfrog_impl, n_warmup=n_warmup, block_size=block_size,
            checkpoint_path=checkpoint_path, logger=logger, warmup_ndiv=n_div,
            relocate_fn=relocate_fn, mesh=mesh)
    else:
        res = chees_sample(st, grad_fn, mask, n_samples, eps, inv_mass, traj,
                           config, generator, leapfrog_impl, start=n_warmup,
                           relocate_fn=relocate_fn, mesh=mesh)
    return dist.gather(res, mesh), {"step_size": eps, "inv_mass": inv_mass, "traj_length": traj,
                 "warmup_divergences": n_div, "traj_drift": float(drift),
                 "traj_converged": converged, "warmup_extensions": n_ext,
                 "eq_stages": eq_stages, "eq_disagreement": eq_disagreement}
