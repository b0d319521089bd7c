"""Likelihood-tempered SMC head (port of starcat/smc.py): adaptive
tempering, systematic resampling, RHMC or HMC mutation, optional
trans-dimensional sweeps.

Per temperature step:
  1. the next Delta-beta: the full step to beta = 1 when the incremental
     ESS stays at ``ess_target_frac * P``, else 26 bisection halvings;
  2. reweight: logw = Delta-beta * loglik; logZ += logmeanexp(logw);
  3. systematic resampling, over the whole population or within each of
     ``n_islands`` contiguous islands (independent ancestries);
  4. ``n_transdim_sweeps`` birth/death + split/merge sweeps at the tempered
     log-likelihood beta * loglik, then ``n_mutation_steps`` within-model
     moves on the tempered target: ``rhmc`` (the dense Fisher metric,
     kernel B6), ``rhmc_diag`` (its diagonal, kernel B3 or B4) or ``hmc`` (the
     plain leapfrog at unit mass; it has no kernel, here or in the
     reference); the step size follows a Robbins-Monro controller on the
     mean acceptance, and the untempered log-likelihood is refreshed.

The reference's ``rhmc_pallas`` and ``rhmc_diag_pallas`` name the same two
kernels here.  Every reduction over the population (the weights, logZ, the
bisection, the controller) stays on the device in float32, as in the
reference; the host loop syncs once per temperature step, to test beta.

Random numbers come from the run's one generator, drawn per step by
:func:`draw_step` in a fixed order: the resampling uniforms, each sweep's
draws, then each mutation step's (momentum noise, step jitter, acceptance
uniform).  The step itself is a pure function of them, so tests feed it the
reference keys' own draws.

``run_smc`` logs one ``smc_temperature_step`` record a step and then, with
``checkpoint_path``, saves the whole SMCState and the generator's state
(SMCCheckpoint); ``resume=True`` continues from the last completed step
with the same bits as an uninterrupted pass, running only the posterior
rounds not yet done (``final_done``).  Not ported: the relocate sweeps
(measured negative in the reference), its legacy checkpoint layout and
program-size routing.

Under a device mesh (``mesh``, dist.py) each rank holds P / W particles:
the step's draws are drawn at full width and sharded, the sweeps and
mutations run on this rank's particles, and the weights, log Z, the
bisection, the resampling plan and the controller are computed on the
gathered population, so every rank holds the one-process schedule.  The
resampled population is gathered and re-sliced, so islands may straddle
the shards.  A checkpoint holds the gathered state and ``run_smc`` returns
the gathered population on every rank.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from . import diagnostics, dist
from .checkpoint import restore_state, save_state
from .driver import ChainState
from .hmc import hmc_transition
from .integrators import plain_trajectory
from .potential import (
    PriorSpec,
    log_likelihood,
    make_tempered_potential_and_grad,
    sample_prior,
)
from .rhmc import RHMCConfig, make_trajectory, rhmc_transition
from .scene import SceneSpec
from .transdim import TransDimConfig, draw_sweep, transdim_sweep
from .transdim_mcmc import draw_counts

# mutation name -> Riemannian metric; "hmc" has none.  The reference's
# *_pallas names choose its Pallas kernels; here the kernel is chosen by
# RunConfig.kernel, so they name the same mutations.
MUTATIONS = {"rhmc": "full", "rhmc_pallas": "full", "rhmc_diag": "diag",
             "rhmc_diag_pallas": "diag", "hmc": None}


class SMCConfig(NamedTuple):
    n_particles: int = 1024
    ess_target_frac: float = 0.5
    max_steps: int = 60
    mutation: str = "rhmc"   # "rhmc" (B6) | "rhmc_diag" (B3/B4) | "hmc"
    n_mutation_steps: int = 2
    n_leapfrog: int = 8
    fixed_point_iters: int = 4
    n_transdim_sweeps: int = 0         # > 0 enables trans-dimensional moves
    # extra mutation + trans-d rounds after beta reaches 1 (pure posterior
    # rounds: the reweight is then a no-op)
    n_final_rounds: int = 0
    # plateau-stopped posterior rounds: with plateau_window W > 0, run
    # rounds at beta = 1 until the mean star count of the last W rounds is
    # within plateau_tol of the W before (first tested after 2 W rounds),
    # at most max_final_rounds; n_final_rounds is then ignored
    plateau_window: int = 0
    plateau_tol: float = 0.25
    max_final_rounds: int = 2000
    final_n_leapfrog: int = 0          # n_leapfrog of the posterior rounds (0: same)
    step_size0: float = 0.1
    target_accept: float = 0.65
    divergence_threshold: float = 1000.0
    transdim: TransDimConfig = TransDimConfig()
    # particles per plain-trajectory call: bounds the plain version's memory
    # (its autograd graph holds (chunk, 3K, H W) Jacobians); the kernel
    # takes the whole population in one launch and ignores it
    mutation_chunk: int = 1024
    # > 1: resampling islands, each an independent ancestry sharing the
    # global (beta, eps) schedule
    n_islands: int = 1


class SMCState(NamedTuple):
    """The population and its schedule, every field on the device."""

    theta: torch.Tensor        # (P, K, 3)
    mask: torch.Tensor         # (P, K)
    loglik: torch.Tensor       # (P,) untempered log-likelihood
    beta: torch.Tensor         # () float32
    log_z: torch.Tensor        # () float32
    eps: torch.Tensor          # () float32
    n_steps: torch.Tensor      # () int32, temperature steps taken
    mean_accept: torch.Tensor  # () float32, of the last step's mutations
    final_done: torch.Tensor   # () int32, steps taken already at beta = 1
    divergences: torch.Tensor  # () int32, mutation transitions over the run
    solver_rejections: torch.Tensor  # () int32


class SMCResult(NamedTuple):
    theta: torch.Tensor
    mask: torch.Tensor
    loglik: torch.Tensor
    log_z: torch.Tensor
    n_steps: torch.Tensor
    eps: torch.Tensor
    mean_accept: torch.Tensor
    beta: torch.Tensor         # final temperature; < 1 means max_steps capped the pass
    final_done: torch.Tensor
    divergences: torch.Tensor
    solver_rejections: torch.Tensor
    # between-island convergence stats when n_islands > 1 (_attach_island_diag)
    island_diag: dict | None = None


class StepDraws(NamedTuple):
    """The random inputs of one temperature step."""

    u_res: torch.Tensor   # () resampling uniform, or (n_islands,)
    sweeps: tuple         # one transdim.SweepDraws per trans-d sweep
    mutation: tuple       # per mutation step: (noise (P, K, 3), u_jit (P,), u_acc (P,))


def check_mutation(mutation: str) -> None:
    if mutation not in MUTATIONS:
        raise ValueError(f"unknown SMC mutation {mutation!r}; ported: "
                         "rhmc (B6), rhmc_diag (B3/B4), hmc")


def ess_from_logw(logw: torch.Tensor) -> torch.Tensor:
    """Kish effective sample size of unnormalised log weights (last axis)."""
    return torch.exp(2.0 * torch.logsumexp(logw, -1) - torch.logsumexp(2.0 * logw, -1))


def systematic_resample(logw: torch.Tensor, u0: torch.Tensor,
                        n_islands: int = 1) -> torch.Tensor:
    """Systematic resampling plan, (P,) parent indices, from the uniforms
    u0: one () for the whole population, or (n_islands,), one per island
    of P / n_islands contiguous particles that resample only among
    themselves (parents stay inside each island)."""
    n = logw.shape[0]
    if n % n_islands != 0:
        raise ValueError(f"{n} particles do not split into {n_islands} islands")
    m = n // n_islands
    w = torch.softmax(logw.reshape(n_islands, m), dim=-1)
    cum = torch.cumsum(w, dim=-1)
    pos = u0.reshape(n_islands, 1) / m + torch.arange(m, dtype=w.dtype, device=w.device) / m
    idx = torch.clamp(torch.searchsorted(cum, pos), 0, m - 1)
    offs = torch.arange(n_islands, device=w.device)[:, None] * m
    return (idx + offs).reshape(n)


def _attach_island_diag(res: SMCResult, cfg: SMCConfig) -> SMCResult:
    """Between-island R-hat of the total flux and the star count, and the
    summed per-island flux ESS, on the final population (host side):
    islands are independent ancestries, the SMC analogue of chains."""
    if cfg.n_islands <= 1:
        return res
    theta = res.theta.cpu().numpy()
    mask = res.mask.cpu().numpy()
    g = cfg.n_islands
    fx = (np.exp(theta[..., 2]) * mask).sum(-1).reshape(g, -1)
    ct = mask.sum(-1).reshape(g, -1)
    return res._replace(island_diag={
        "island_rhat_flux": diagnostics.rhat_groups(fx),
        "island_ess_flux": float(sum(diagnostics.ess(row[None, :]) for row in fx)),
        "island_rhat_count": diagnostics.rhat_groups(ct),
        "n_islands": g,
    })


def _next_dbeta(beta: torch.Tensor, loglik: torch.Tensor, target_ess: float,
                n_bisect: int = 26) -> torch.Tensor:
    """Largest Delta-beta <= 1 - beta with ESS(Delta-beta * loglik) >=
    target: the full step if it passes, else the bisection's lower end.
    Runs on the device without a sync (both branches are computed)."""
    full = 1.0 - beta
    lo, hi = torch.zeros_like(full), full
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_from_logw(mid * loglik) >= target_ess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_from_logw(full * loglik) >= target_ess, full, lo)


def smc_state_from(spec: SceneSpec, image: torch.Tensor, theta: torch.Tensor,
                   mask: torch.Tensor, cfg: SMCConfig) -> SMCState:
    """The state at beta = 0 for a drawn population."""
    dev = theta.device

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return SMCState(theta, mask, log_likelihood(theta, mask, spec, image),
                    scalar(0.0), scalar(0.0), scalar(cfg.step_size0),
                    scalar(0, torch.int32), scalar(0.0), scalar(0, torch.int32),
                    scalar(0, torch.int32), scalar(0, torch.int32))


def init_smc(generator: torch.Generator, spec: SceneSpec, image: torch.Tensor,
             prior: PriorSpec, kmax: int, cfg: SMCConfig, mesh=None) -> SMCState:
    """P particles from the prior at beta = 0; with trans-d sweeps the star
    count is Poisson(lam_count) truncated to [0, kmax], the first n slots
    alive (slots are exchangeable under the target).  Under a ``mesh``,
    this rank's of the P."""
    p, dev = cfg.n_particles, image.device
    theta = sample_prior(generator, p * kmax, prior, dev).reshape(p, kmax, 3)
    if cfg.n_transdim_sweeps > 0:
        n = draw_counts(generator, cfg.transdim.lam_count, kmax, p, dev)
        mask = (torch.arange(kmax, device=dev)[None, :] < n[:, None]).to(torch.float32)
    else:
        mask = torch.ones((p, kmax), dtype=torch.float32, device=dev)
    return smc_state_from(spec, image, *dist.shard((theta, mask), mesh), cfg)


def draw_step(generator: torch.Generator, p: int, kmax: int, spec: SceneSpec,
              prior: PriorSpec, cfg: SMCConfig, device) -> StepDraws:
    """One temperature step's random inputs, in a fixed order."""
    shape = () if cfg.n_islands <= 1 else (cfg.n_islands,)
    u_res = torch.rand(shape, generator=generator, device=device)
    sweeps = tuple(draw_sweep(generator, p, kmax, spec, prior, cfg.transdim, device)
                   for _ in range(cfg.n_transdim_sweeps))
    mutation = tuple(
        (torch.randn((p, kmax, 3), generator=generator, device=device),
         torch.rand((p,), generator=generator, device=device),
         torch.rand((p,), generator=generator, device=device))
        for _ in range(cfg.n_mutation_steps))
    return StepDraws(u_res, sweeps, mutation)


def _chunked(trajectory, chunk: int):
    """A B3/B6-contract trajectory run over at most ``chunk`` chains per
    call (per-chain eps and mask are cut with the chains)."""

    def run(theta, xi, eps, mask, beta):
        c = theta.shape[0]
        if c <= chunk:
            return trajectory(theta, xi, eps, mask, beta)
        parts = [trajectory(theta[i:i + chunk], xi[i:i + chunk], eps[i:i + chunk],
                            mask[i:i + chunk] if mask.ndim == 2 else mask, beta)
                 for i in range(0, c, chunk)]
        return tuple(torch.cat(outs) for outs in zip(*parts))

    return run


def make_smc_step(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                  kmax: int, cfg: SMCConfig, fused: bool = False, mesh=None):
    """One temperature step, step(state, draws) -> state: reweight,
    resample, sweep, mutate.  fused=True runs the Riemannian mutations on
    their CUDA kernels (B6 for rhmc, B3 or B4 for rhmc_diag); the hmc mutation
    always runs the plain tempered leapfrog.  Under a ``mesh`` the state's
    particles and the draws' (all but u_res) are this rank's."""
    check_mutation(cfg.mutation)
    metric = MUTATIONS[cfg.mutation]
    tpg = make_tempered_potential_and_grad(spec, image, prior)
    p = cfg.n_particles
    if metric is not None:
        rcfg = RHMCConfig(n_leapfrog=cfg.n_leapfrog,
                          fixed_point_iters=cfg.fixed_point_iters, metric=metric)
        trajectory = make_trajectory(spec, image, prior, kmax, rcfg, fused)
        if not fused:
            trajectory = _chunked(trajectory, cfg.mutation_chunk)

    def mutate(theta, mask, beta, eps, noise, u_jit, u_acc):
        if metric is not None:
            zero = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
            sts, info = rhmc_transition(
                ChainState(theta, zero, torch.zeros_like(theta)), noise, u_jit, u_acc,
                trajectory, eps, mask, beta, cfg.divergence_threshold)
            return sts.theta, info.accept_prob, info.diverged, info.solver_fail
        u0, g0 = tpg(theta, mask, beta)
        traj = plain_trajectory(lambda th: tpg(th, mask, beta))
        sts, info = hmc_transition(
            ChainState(theta, u0, g0), eps, torch.ones((kmax, 3), device=theta.device),
            mask, noise, u_jit, u_acc, traj, cfg.n_leapfrog, cfg.divergence_threshold)
        return sts.theta, info.accept_prob, info.diverged, torch.zeros_like(info.diverged)

    def step(s: SMCState, draws: StepDraws) -> SMCState:
        # 1-2. adaptive tempering and reweighting (weights are equal
        # after the previous resampling), on the whole population
        theta, mask, loglik = dist.gather((s.theta, s.mask, s.loglik), mesh)
        db = _next_dbeta(s.beta, loglik, cfg.ess_target_frac * p)
        beta = s.beta + db
        logw = db * loglik
        log_z = s.log_z + torch.logsumexp(logw, 0) - math.log(float(p))

        # 3. systematic resampling; this rank keeps its rows of the
        # resampled population
        idx = dist.shard(systematic_resample(logw, draws.u_res, cfg.n_islands), mesh)
        theta, mask = theta[idx], mask[idx]

        # 4a. trans-dimensional sweeps at the tempered likelihood
        if draws.sweeps:
            tllf = lambda th, m: beta * log_likelihood(th, m, spec, image)  # noqa: E731
            tll = beta * loglik[idx]
            for sd in draws.sweeps:
                theta, mask, tll, _ = transdim_sweep(theta, mask, tll, tllf, prior,
                                                     spec, cfg.transdim, sd, image)

        # 4b. within-model mutation at temperature beta
        aprobs, div, fail = [], 0, 0
        for noise, u_jit, u_acc in draws.mutation:
            theta, ap, dv, sf = mutate(theta, mask, beta, s.eps, noise, u_jit, u_acc)
            ap, dv, sf = dist.gather((ap, dv, sf), mesh)
            aprobs.append(ap)
            div = div + dv.sum(dtype=torch.int32)
            fail = fail + sf.sum(dtype=torch.int32)
        mean_accept = torch.stack(aprobs).mean() if aprobs else torch.zeros_like(s.eps)

        # Robbins-Monro step-size controller toward the target acceptance
        eps = torch.clamp(s.eps * torch.exp(0.3 * (mean_accept - cfg.target_accept)),
                          1e-5, 10.0)
        return SMCState(
            theta, mask, log_likelihood(theta, mask, spec, image), beta, log_z,
            eps, s.n_steps + 1, mean_accept,
            s.final_done + (s.beta >= 1.0).to(torch.int32),
            s.divergences + div, s.solver_rejections + fail)

    return step


class SMCCheckpoint(NamedTuple):
    """Written after every temperature step: the population and its
    schedule, and the run generator's state."""

    state: SMCState
    generator: torch.Generator


def _host(s: SMCState) -> tuple[float, int, int]:
    """(beta, n_steps, final_done) read back in one sync."""
    beta, n, done = torch.stack([s.beta.double(), s.n_steps.double(),
                                 s.final_done.double()]).tolist()
    return beta, int(n), int(done)


def _result(s: SMCState) -> SMCResult:
    return SMCResult(s.theta, s.mask, s.loglik, s.log_z, s.n_steps, s.eps,
                     s.mean_accept, s.beta, s.final_done, s.divergences,
                     s.solver_rejections)


def run_smc(generator: torch.Generator, spec: SceneSpec, image: torch.Tensor,
            prior: PriorSpec, kmax: int, cfg: SMCConfig,
            fused: bool = False, on_step=None, checkpoint_path: str | None = None,
            resume: bool = False, logger=None, mesh=None) -> SMCResult:
    """A full pass: temperature steps until beta = 1 (or max_steps), then
    the posterior rounds (n_final_rounds, or plateau-stopped), with
    final_n_leapfrog when set.  ``on_step(state)``, when given, sees the
    state after every step (scripts/smc_trace.py records it).

    After every step ``logger`` gets an ``smc_temperature_step`` record and
    then, with ``checkpoint_path``, an SMCCheckpoint is written.
    resume=True with a checkpoint there continues from its step: only the
    posterior rounds not yet done run, and the plateau window restarts (at
    least 2 W more rounds).  With islands, ``logger`` gets
    ``smc_island_diag`` at the end.

    Under a ``mesh`` each rank holds P / W particles (``on_step`` sees this
    rank's) and the result is the gathered population, on every rank."""
    check_mutation(cfg.mutation)
    p, dev = cfg.n_particles, image.device
    if mesh is not None:
        mesh.local(p)   # raises unless the particles split over the ranks
    s = init_smc(generator, spec, image, prior, kmax, cfg, mesh)
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        like = SMCCheckpoint(dist.gather(s, mesh), generator)
        s = dist.shard(restore_state(checkpoint_path, like, dev).state, mesh)
    step = make_smc_step(spec, image, prior, kmax, cfg, fused, mesh)

    def advance(st, fn):
        draws = draw_step(generator, p, kmax, spec, prior, cfg, dev)
        st = fn(st, draws._replace(sweeps=dist.shard(draws.sweeps, mesh),
                                   mutation=dist.shard(draws.mutation, mesh)))
        if on_step is not None:
            on_step(st)
        rec = torch.stack([st.beta.double(), st.n_steps.double(), st.final_done.double(),
                           st.log_z.double(), st.mean_accept.double(), st.eps.double(),
                           dist.gather(st.mask, mesh).sum(-1).mean().double()]).tolist()
        if logger is not None:
            logger.log("smc_temperature_step", step=int(rec[1]), beta=rec[0], log_z=rec[3],
                       accept=rec[4], step_size=rec[5], mean_n=rec[6])
        if checkpoint_path is not None:
            save_state(checkpoint_path, SMCCheckpoint(dist.gather(st, mesh), generator), mesh)
        return st, rec[0], int(rec[1]), int(rec[2]), rec[6]

    beta, n_steps, done = _host(s)
    while beta < 1.0 and n_steps < cfg.max_steps:
        s, beta, n_steps, done, _ = advance(s, step)

    fstep = step
    if cfg.final_n_leapfrog not in (0, cfg.n_leapfrog):
        fstep = make_smc_step(spec, image, prior, kmax,
                              cfg._replace(n_leapfrog=cfg.final_n_leapfrog), fused, mesh)
    if cfg.plateau_window > 0:
        # only posterior rounds are plateau-stopped: a max_steps-capped
        # pass (beta < 1) returns as it is
        w, hist = cfg.plateau_window, []
        while beta >= 1.0 and done < cfg.max_final_rounds:
            s, beta, n_steps, done, mean_n = advance(s, fstep)
            hist.append(mean_n)
            if len(hist) >= 2 * w and abs(sum(hist[-w:]) - sum(hist[-2 * w:-w])) / w < cfg.plateau_tol:
                break
    else:
        for _ in range(max(cfg.n_final_rounds - done, 0)):
            s, beta, n_steps, done, _ = advance(s, fstep)
    res = _attach_island_diag(_result(dist.gather(s, mesh)), cfg)
    if logger is not None and res.island_diag is not None:
        logger.log("smc_island_diag", **res.island_diag)
    return res
