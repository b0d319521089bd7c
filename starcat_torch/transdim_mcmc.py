"""Trans-dimensional MCMC head (port of starcat/transdim_mcmc.py).

Each transition composes two kernels that target the same joint
distribution over (mask, theta), the slot-symmetrised measure of
transdim.py:

  1. ``n_transdim_sweeps`` birth/death + split/merge sweeps, which change
     each chain's alive mask (transdim.poisson_sweep at beta: with ``fused``
     on the card the sweep kernel);
  2. one within-model move at each chain's current mask, dead slots frozen:
     ``hmc`` (kernel B1's or B5's trajectory), ``rhmc`` (kernel B6's or B6c's
     full-Fisher trajectory) or ``rhmc_diag`` (kernel B3's or B4's
     diagonal-Fisher trajectory), all at per-chain masks.

The mask is chain state here, so this head carries its own warmup (dual
averaging on the step size only, with the divergence penalty) and sampling
loops.  The log-likelihood cache of the trans-d ratios is refreshed for
free after the within-model move, loglik = -U - log prior.  ``beta``
tempers the likelihood (target prior * L^beta; the cache then holds the
tempered log-likelihood); beta = 0 makes the whole head sample the prior.

Random numbers come from the run's one generator, in a fixed order per
transition (:func:`draw_transition`): each sweep's draws
(transdim.draw_sweep), then the within-model move's; the transition is a
pure function of them.  So blocked sampling (``run_transdim(block_size=...)``)
gives the same bits as one loop, and a TDBlockCheckpoint (the chains, the
draws done, eps and the generator's state) written after every block lets a
replacement process resume with the same bits as an uninterrupted run.  The
warmup keeps its per-transition records on the device and ``logger`` gets
four ``warmup_window`` records, ``warmup_complete`` and one
``sampling_block`` a block.

Under a device mesh (``mesh``, dist.py) each rank runs its chains: the
start and every transition's draws are drawn at full width and sharded,
the warmup's statistics and the records are of the gathered chains, a
checkpoint holds the gathered state, and the result every chain's draws.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from . import dist
from .adapt import da_init, da_update
from .checkpoint import restore_state, save_state
from .driver import ChainState, block_sizes, concat_blocks
from .dispatch import make_leapfrog
from .hmc import hmc_transition
from .integrators import plain_trajectory
from .potential import (
    PriorSpec,
    log_likelihood,
    log_prior,
    make_potential_and_grad,
    make_tempered_potential_and_grad,
    sample_prior,
)
from .rhmc import RHMCConfig, make_trajectory, rhmc_transition
from .scene import SceneSpec
from .transdim import TransDimConfig, draw_sweep, poisson_sweep


TD_MUTATIONS = ("hmc", "rhmc", "rhmc_diag")


class TransDimMCMCConfig(NamedTuple):
    step_size: float = 0.1
    # within-model move: "hmc" (B1/B5) | "rhmc" (the full metric, B6/B6c) |
    # "rhmc_diag" (B3/B4)
    mutation: str = "hmc"
    n_leapfrog: int = 10
    fixed_point_iters: int = 4
    n_transdim_sweeps: int = 2
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0
    solver_tol: float = 0.05
    divergence_penalty: float = 5.0
    transdim: TransDimConfig = TransDimConfig()


class TDState(NamedTuple):
    """Per-chain state; the mask is state here, where the fixed-K heads
    close over one."""

    theta: torch.Tensor   # (C, K, 3)
    mask: torch.Tensor    # (C, K) in {0., 1.}
    loglik: torch.Tensor  # (C,) (tempered) log-likelihood cache


class TDInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) within-model acceptance probability
    diverged: torch.Tensor     # (C,)
    td_accept: torch.Tensor    # (C,) mean trans-d acceptance over the sweeps
    n_alive: torch.Tensor      # (C,) star count after the transition
    solver_fail: torch.Tensor  # (C,) Riemannian solver force-rejections


def draw_counts(generator: torch.Generator, lam_count: float, kmax: int, n: int,
                device) -> torch.Tensor:
    """n star counts from the Poisson(lam_count) truncated to [0, kmax]."""
    ks = torch.arange(kmax + 1, dtype=torch.float64, device=device)
    logpmf = ks * math.log(lam_count) - torch.lgamma(ks + 1.0)
    return torch.multinomial(torch.softmax(logpmf, dim=0).to(torch.float32),
                             n, replacement=True, generator=generator)


def init_td_states(generator: torch.Generator, spec: SceneSpec,
                   image: torch.Tensor, prior: PriorSpec, kmax: int,
                   n_chains: int, lam_count: float, beta=1.0, mesh=None) -> TDState:
    """Prior-initialised chains: parameters from the prior, n from the
    Poisson(lam_count) truncated to [0, kmax], the first n slots alive.
    Under a ``mesh``, this rank's of the n_chains."""
    dev = image.device
    thetas = sample_prior(generator, n_chains * kmax, prior, dev).reshape(n_chains, kmax, 3)
    n_draw = draw_counts(generator, lam_count, kmax, n_chains, dev)
    thetas, n_draw = dist.shard((thetas, n_draw), mesh)
    masks = (torch.arange(kmax, device=dev)[None, :] < n_draw[:, None]).to(torch.float32)
    loglik = beta * log_likelihood(thetas, masks, spec, image)
    return TDState(thetas, masks, loglik)


class TDDraws(NamedTuple):
    """The random inputs of one transition."""

    sweeps: tuple  # one transdim.SweepDraws per trans-d sweep
    move: tuple    # the within-model move's (noise (C, K, 3), u_jit (C,), u_acc (C,))


def draw_transition(generator: torch.Generator, c: int, kmax: int, spec: SceneSpec,
                    prior: PriorSpec, cfg: TransDimMCMCConfig, device) -> TDDraws:
    """One transition's random inputs in a fixed order: each sweep's, then
    the within-model move's (momentum or its noise, jitter, acceptance)."""
    sweeps = tuple(draw_sweep(generator, c, kmax, spec, prior, cfg.transdim, device)
                   for _ in range(cfg.n_transdim_sweeps))
    move = (torch.randn((c, kmax, 3), generator=generator, device=device),
            torch.rand((c,), generator=generator, device=device),
            torch.rand((c,), generator=generator, device=device))
    return TDDraws(sweeps, move)


def make_transdim_kernel(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                         kmax: int, cfg: TransDimMCMCConfig,
                         generator: torch.Generator, beta=1.0,
                         fused: bool = False, mesh=None):
    """Batched transition: kernel(TDState, eps, draws=None) -> (TDState,
    TDInfo), a pure function of its draws (drawn from ``generator`` by
    :func:`draw_transition` when not given; under a ``mesh`` at full width,
    keeping this rank's rows).

    fused=True runs the sweeps on the sweep kernel and the within-model
    trajectory in the CUDA kernel (B1 or, on crowded fields, B5 for
    ``hmc``; B6 or B6c for ``rhmc``; B3 or B4 for ``rhmc_diag``); off it,
    the plain torch sweeps and trajectory."""
    if cfg.mutation not in TD_MUTATIONS:
        raise ValueError(f"unknown mutation {cfg.mutation!r}; ported: {', '.join(TD_MUTATIONS)}")
    if beta == 1.0:
        pg = make_potential_and_grad(spec, image, prior)
    else:
        tpg = make_tempered_potential_and_grad(spec, image, prior)
        pg = lambda th, m: tpg(th, m, beta)  # noqa: E731

    if cfg.mutation == "hmc":
        if fused and beta != 1.0:
            # the fused HMC trajectory evaluates the beta = 1 posterior; the
            # Riemannian kernel takes beta itself
            raise ValueError("tempered trans-d MCMC on the CUDA kernel: use "
                             "mutation=rhmc or rhmc_diag, or kernel=torch for hmc")
        fused_traj = (make_leapfrog(spec, image, prior, kmax, cfg.n_leapfrog)
                      if fused else None)

        def within_model(theta, mask, u, eps, p0, u_jit, u_acc):
            _, g = pg(theta, mask)
            if fused_traj is None:
                trajectory = plain_trajectory(lambda th: pg(th, mask))
            else:
                trajectory = lambda th, p, e, im, m, n, gr: fused_traj(  # noqa: E731
                    th, p, e, im, m, grad=gr)
            sts, info = hmc_transition(
                ChainState(theta, u, g), eps, torch.ones((kmax, 3), device=theta.device),
                mask, p0, u_jit, u_acc, trajectory, cfg.n_leapfrog,
                cfg.divergence_threshold)
            return sts, info, torch.zeros_like(info.diverged)
    else:
        rcfg = RHMCConfig(n_leapfrog=cfg.n_leapfrog,
                          fixed_point_iters=cfg.fixed_point_iters,
                          metric="full" if cfg.mutation == "rhmc" else "diag")
        rhmc_traj = make_trajectory(spec, image, prior, kmax, rcfg, fused)

        def within_model(theta, mask, u, eps, xi, u_jit, u_acc):
            sts, info = rhmc_transition(
                ChainState(theta, u, torch.zeros_like(theta)), xi, u_jit, u_acc,
                rhmc_traj, eps, mask, beta, cfg.divergence_threshold, cfg.solver_tol)
            return sts, info, info.solver_fail

    def kernel(state: TDState, eps, draws: TDDraws | None = None):
        theta, mask, ll = state
        c = theta.shape[0]
        if draws is None:
            draws = dist.draw(lambda n: draw_transition(generator, n, kmax, spec, prior, cfg,
                                                        theta.device), c, mesh)
        td_acc = torch.zeros((c,), dtype=torch.float32, device=theta.device)
        for sd in draws.sweeps:
            theta, mask, ll, info = poisson_sweep(theta, mask, ll, beta, prior, spec, image,
                                                  cfg.transdim, sd, fused)
            td_acc = td_acc + info.accepted.to(torch.float32)
        td_accept = td_acc / max(cfg.n_transdim_sweeps, 1)

        u = -(ll + log_prior(theta, mask, prior))
        sts, info, sf = within_model(theta, mask, u, eps, *draws.move)
        ll2 = -sts.u - log_prior(sts.theta, mask, prior)
        return TDState(sts.theta, mask, ll2), TDInfo(
            info.accept_prob, info.diverged, td_accept, mask.sum(-1), sf)

    return kernel


class TDSampleResult(NamedTuple):
    thetas: torch.Tensor       # (C, N, K, 3)
    masks: torch.Tensor        # (C, N, K) bool
    accept_prob: torch.Tensor  # (C, N)
    diverged: torch.Tensor     # (C, N)
    td_accept: torch.Tensor    # (C, N)
    solver_fail: torch.Tensor  # (C, N)
    final_state: TDState


def warmup(states: TDState, kernel, n_warmup: int, step_size: float,
           target_accept: float, divergence_penalty: float = 0.0, mesh=None):
    """Dual-averaging step-size warmup (no mass adaptation: the mask varies
    per chain).  The statistic is mean(accept_prob) - divergence_penalty *
    frac(diverged | solver_fail).  Returns (states, eps_bar, records): the
    records (n_warmup, 4) on the device hold each transition's mean
    acceptance, mean trans-d acceptance, mean alive count and eps (under a
    ``mesh``, of every rank's chains)."""
    dev = states.theta.device
    da = da_init(step_size, dev)
    recs = torch.empty((n_warmup, 4), dtype=torch.float32, device=dev)
    st = states
    for i in range(n_warmup):
        st, info = kernel(st, torch.exp(da.log_eps))
        aprob, bad, td_acc, mask = dist.gather(
            (info.accept_prob, info.diverged | info.solver_fail, info.td_accept, st.mask), mesh)
        acc = aprob.mean()
        bad = bad.to(torch.float32).mean()
        da = da_update(da, acc - divergence_penalty * bad, target=target_accept)
        recs[i] = torch.stack([acc, td_acc.mean(), mask.sum(-1).mean(),
                               torch.exp(da.log_eps)])
    return st, torch.exp(da.log_eps_bar), recs


def sample(states: TDState, kernel, n_samples: int, eps) -> TDSampleResult:
    """Sampling at a fixed eps, draws and per-draw masks kept on the device."""
    c, k = states.mask.shape
    dev = states.theta.device
    thetas = torch.empty((c, n_samples, k, 3), dtype=states.theta.dtype, device=dev)
    masks = torch.empty((c, n_samples, k), dtype=torch.bool, device=dev)
    aprob = torch.empty((c, n_samples), dtype=torch.float32, device=dev)
    div = torch.empty((c, n_samples), dtype=torch.bool, device=dev)
    td = torch.empty((c, n_samples), dtype=torch.float32, device=dev)
    sf = torch.empty((c, n_samples), dtype=torch.bool, device=dev)
    st = states
    for i in range(n_samples):
        st, info = kernel(st, eps)
        thetas[:, i] = st.theta
        masks[:, i] = st.mask > 0.5
        aprob[:, i] = info.accept_prob
        div[:, i] = info.diverged
        td[:, i] = info.td_accept
        sf[:, i] = info.solver_fail
    return TDSampleResult(thetas, masks, aprob, div, td, sf, st)


class TDBlockCheckpoint(NamedTuple):
    """Written after every sampling block: the chains, the draws done, the
    adapted eps and the run generator's state."""

    state: TDState
    done: int
    step_size: torch.Tensor  # ()
    generator: torch.Generator


def _log_warmup(logger, recs: torch.Tensor, eps, n_warmup: int) -> None:
    """Four ``warmup_window`` records and ``warmup_complete``, from the
    warmup's records read back in one sync."""
    rows = recs.cpu()
    n_win = min(4, n_warmup)
    for i in range(n_win):
        lo, hi = i * n_warmup // n_win, (i + 1) * n_warmup // n_win
        acc, tda, mean_n, _ = rows[lo:hi].mean(0).tolist()
        logger.log("warmup_window", head="transdim", window=i, accept=acc,
                   td_accept=tda, mean_n=mean_n, step_size=float(rows[hi - 1, 3]))
    logger.log("warmup_complete", head="transdim", step_size=float(eps),
               n_warmup=n_warmup)


def run_transdim(generator: torch.Generator, spec: SceneSpec, image: torch.Tensor,
                 prior: PriorSpec, kmax: int, n_chains: int, n_samples: int,
                 n_warmup: int, cfg: TransDimMCMCConfig = TransDimMCMCConfig(),
                 fused: bool = False, beta=1.0, block_size: int | None = None,
                 checkpoint_path: str | None = None, resume: bool = False,
                 logger=None, mesh=None):
    """init -> warmup -> (blocked) sampling; returns (TDSampleResult,
    step_size).  With block_size and checkpoint_path every block writes a
    TDBlockCheckpoint; resume=True continues from the last completed one
    and returns only the remaining draws.  Under a ``mesh`` each rank runs
    its chains and the result holds every chain's draws, on every rank."""
    kernel = make_transdim_kernel(spec, image, prior, kmax, cfg, generator, beta, fused,
                                  mesh)
    states = init_td_states(generator, spec, image, prior, kmax, n_chains,
                            cfg.transdim.lam_count, beta, mesh)
    start_done = 0
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        like = TDBlockCheckpoint(dist.gather(states, mesh), 0,
                                 torch.zeros((), device=image.device), generator)
        ck = restore_state(checkpoint_path, like, image.device)
        states, eps, start_done = dist.shard(ck.state, mesh), ck.step_size, ck.done
    else:
        states, eps, recs = warmup(states, kernel, n_warmup, cfg.step_size,
                                   cfg.target_accept, cfg.divergence_penalty, mesh)
        if logger is not None:
            _log_warmup(logger, recs, eps, n_warmup)
    if block_size is None:
        return dist.gather(sample(states, kernel, n_samples, eps), mesh), eps

    parts = []
    done = start_done
    for n in block_sizes(n_samples, block_size, start_done):
        res = sample(states, kernel, n, eps)
        states = res.final_state
        parts.append(res[:-1])
        done += n
        if logger is not None:
            aprob, td_acc, masks = dist.gather((res.accept_prob, res.td_accept, res.masks),
                                               mesh)
            acc, tda, mean_n = torch.stack([
                aprob.mean(), td_acc.mean(),
                masks.sum(-1, dtype=torch.float32).mean()]).tolist()
            logger.log("sampling_block", head="transdim", done=done, accept=acc,
                       td_accept=tda, mean_n=mean_n)
        if checkpoint_path is not None:
            save_state(checkpoint_path,
                       TDBlockCheckpoint(dist.gather(states, mesh), done, eps, generator), mesh)
    c, k, dev = states.theta.shape[0], kmax, image.device
    empty = (torch.zeros((c, 0, k, 3), device=dev),
             torch.zeros((c, 0, k), dtype=torch.bool, device=dev),
             torch.zeros((c, 0), device=dev), torch.zeros((c, 0), dtype=torch.bool, device=dev),
             torch.zeros((c, 0), device=dev), torch.zeros((c, 0), dtype=torch.bool, device=dev))
    return dist.gather(TDSampleResult(*concat_blocks(parts, empty), states), mesh), eps
