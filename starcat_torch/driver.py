"""Shared warmup/sampling driver for the MCMC heads (port of
starcat/driver.py).

A *kernel* is a batched callable ``kernel(states, eps, inv_mass) ->
(states, info)`` over all chains at once, where ``info`` exposes
``accept_prob`` and ``diverged`` (C,).  The random numbers come from the
run's one ``torch.Generator``, which the kernel closes over; nothing here
draws any.  Chain-pooled adaptation statistics are plain means over the
chain axis, kept on the device: no step of warmup or sampling waits for the
host.  Blocked sampling (:func:`sample_blocked`) reads a block's summary back
once, logs it and writes a checkpoint of the chains, the adapted step size
and mass and the generator's state; :func:`run_mcmc` resumes from it with
the same bits as an uninterrupted run, since every draw of a transition
comes from the one generator in a fixed order.

Under a device mesh (``mesh``, dist.py) the states hold this rank's chains,
the kernel draws at full width and keeps its rows, the pooled statistics
reduce the gathered full tensors, checkpoints hold the gathered state and
:func:`run_mcmc` returns the gathered draws: the one-process run's bits.
"""
from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import torch

from . import dist
from .adapt import (
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from .checkpoint import restore_state, save_state


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
    # per phase, on the device: the mean acceptance and the dual-averaging
    # eps at the phase's end (None on a resume, which skips warmup)
    phase_accept: torch.Tensor | None = None  # (3,)
    phase_eps: torch.Tensor | None = None     # (3,)


def warmup(states: ChainState, kernel: Callable, n_warmup: int,
           step_size: float = 0.1, target_accept: float = 0.8,
           adapt_mass: bool = True,
           divergence_penalty: float = 0.0, mesh=None) -> WarmupResult:
    """Three-phase pooled warmup (15% eps / 60% eps + mass / 25% eps).

    adapt_mass=False keeps the unit mass (the Riemannian heads, whose
    metric is the mass).  divergence_penalty > 0 makes dual averaging see
    mean(accept_prob) - penalty * frac(diverged | solver_fail), so eps
    settles where failures are rare (at equilibrium the fraction is at most
    (1 - target_accept) / penalty).  With a ``mesh`` the pooled statistics
    reduce the gathered chains."""
    n1 = max(n_warmup * 15 // 100, 1)
    n3 = max(n_warmup * 25 // 100, 1)
    n2 = max(n_warmup - n1 - n3, 1)
    device = states.theta.device
    param_shape = states.theta.shape[1:]

    def run_phase(st, da, wf, inv_mass, n, accumulate):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            st, info = kernel(st, torch.exp(da.log_eps), inv_mass)
            a = dist.gather(info.accept_prob, mesh).mean()
            acc = acc + a
            stat = a - divergence_penalty * _bad_frac(info, mesh) if divergence_penalty else a
            da = da_update(da, stat, target=target_accept)
            if accumulate:
                wf = welford_update_batch(wf, dist.gather(st.theta, mesh))
        return st, da, wf, acc / n

    da = da_init(step_size, device)
    wf = welford_init(param_shape, device)
    inv_mass = torch.ones(param_shape, dtype=torch.float32, device=device)

    st, da, wf, a1 = run_phase(states, da, wf, inv_mass, n1, False)
    e1 = torch.exp(da.log_eps)
    st, da, wf, a2 = run_phase(st, da, wf, inv_mass, n2, adapt_mass)
    e2 = torch.exp(da.log_eps)
    if adapt_mass:
        inv_mass = welford_variance(wf)
        da = da_restart(da)
    st, da, wf, a3 = run_phase(st, da, wf, inv_mass, n3, False)
    e3 = torch.exp(da.log_eps)
    return WarmupResult(st, torch.exp(da.log_eps_bar), inv_mass,
                        torch.stack([a1, a2, a3]), torch.stack([e1, e2, e3]))


def log_warmup_phases(logger, phase_accept: torch.Tensor, phase_eps: torch.Tensor) -> None:
    """Three ``warmup_phase`` records, read back in one sync."""
    pa, pe = torch.stack([phase_accept, phase_eps]).tolist()
    for i in range(3):
        logger.log("warmup_phase", phase=i + 1, accept=pa[i], step_size=pe[i])


def _bad_frac(info, mesh=None) -> torch.Tensor:
    """Pooled fraction of divergent or solver-failed transitions."""
    bad = info.diverged
    sf = getattr(info, "solver_fail", None)
    if sf is not None:
        bad = bad | sf
    return dist.gather(bad, mesh).to(torch.float32).mean()


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


class BlockCheckpoint(NamedTuple):
    """Written after every sampling block: the chains, the draws done, the
    fixed post-warmup step size and mass, and the run generator's state —
    everything a replacement process needs to continue without warmup."""

    states: ChainState
    done: int
    step_size: torch.Tensor  # ()
    inv_mass: torch.Tensor   # param-shaped
    generator: torch.Generator


def checkpoint_like(states: ChainState, generator: torch.Generator) -> BlockCheckpoint:
    """Structure donor for restore_state on a BlockCheckpoint."""
    th = states.theta
    return BlockCheckpoint(states, 0, torch.zeros((), device=th.device),
                           torch.ones(th.shape[1:], device=th.device), generator)


def block_sizes(n_samples: int, block_size: int, start_done: int = 0) -> list[int]:
    """The blocks still to run: uniform sizes ceil(n / ceil(n / block)),
    the last one cut to what remains."""
    n_blocks = max(1, math.ceil(n_samples / block_size))
    size = math.ceil(n_samples / n_blocks)
    return [min(size, n_samples - d) for d in range(start_done, n_samples, size)]


def concat_blocks(parts: list, empty):
    """Concatenate each field of the blocks' results along the draw axis;
    ``empty`` when a resume found the run complete."""
    if not parts:
        return empty
    return [None if p[0] is None else torch.cat(p, dim=1) for p in zip(*parts)]


def sample_blocked(states: ChainState, kernel: Callable, n_samples: int,
                   step_size: torch.Tensor, inv_mass: torch.Tensor,
                   block_size: int = 250, checkpoint_path: str | None = None,
                   start_done: int = 0, logger=None, thin: int = 1,
                   generator: torch.Generator | None = None, mesh=None) -> SampleResult:
    """sample() in blocks, the same bits as one call: after each block one
    sync reads its summary, ``logger`` gets a ``sampling_block`` record and
    then, with ``checkpoint_path``, a BlockCheckpoint is written (which
    needs the run's ``generator``).  The draws stay on the device.

    start_done: draws completed by an earlier process; this call produces
    only the remaining n_samples - start_done (see run_mcmc(resume=True)).
    With a ``mesh`` the summary and the checkpoint are of the gathered
    chains; the draws stay this rank's."""
    if checkpoint_path is not None and generator is None:
        raise ValueError("a checkpoint needs the run's generator")
    parts = []
    done = start_done
    for n in block_sizes(n_samples, block_size, start_done):
        res = sample(states, kernel, n, step_size, inv_mass, thin=thin)
        states = res.final_states
        parts.append((res.thetas, res.accept_prob, res.diverged, res.solver_fail))
        done += n
        if logger is not None:
            aprob, div, sf = dist.gather((res.accept_prob, res.diverged, res.solver_fail), mesh)
            summ = [aprob.mean(), div.sum().float()]
            if sf is not None:
                summ.append(sf.sum().float())
            summ = torch.stack(summ).tolist()
            extra = {"solver_rejections": int(summ[2])} if len(summ) > 2 else {}
            logger.log("sampling_block", done=done, n_total=n_samples, accept=summ[0],
                       divergences=int(summ[1]), **extra)
        if checkpoint_path is not None:
            save_state(checkpoint_path, BlockCheckpoint(
                dist.gather(states, mesh), done, step_size, inv_mass, generator), mesh)
    c, dev = states.theta.shape[0], states.theta.device
    empty = (torch.zeros((c, 0) + tuple(states.theta.shape[1:]), device=dev),
             torch.zeros((c, 0), device=dev), torch.zeros((c, 0), dtype=torch.bool, device=dev),
             None)
    thetas, aprob, div, sf = concat_blocks(parts, empty)
    return SampleResult(thetas, aprob, div, states, sf)


def run_mcmc(kernel: Callable, grad_fn: Callable, theta0: torch.Tensor,
             n_samples: int, n_warmup: int, step_size: float = 0.1,
             target_accept: float = 0.8, thin: int = 1,
             adapt_mass: bool = True, divergence_penalty: float = 0.0,
             block_size: int | None = None, checkpoint_path: str | None = None,
             resume: bool = False, logger=None,
             generator: torch.Generator | None = None, mesh=None):
    """init -> warmup -> sample; returns (SampleResult, WarmupResult).

    block_size: sample in blocks of about this many draws (sample_blocked),
    with a checkpoint after each when ``checkpoint_path`` is set (that needs
    the run's ``generator``, which the kernel draws from).  resume=True with
    a checkpoint at ``checkpoint_path`` skips warmup, restores the chains,
    step size, mass and generator, and produces only the remaining draws:
    the same bits as the uninterrupted run's last ones.  ``logger`` gets
    three ``warmup_phase`` records and a ``sampling_block`` a block.

    mesh: theta0 holds this rank's chains (dist.shard of the full start);
    the returned SampleResult holds every chain's draws, on every rank."""
    if checkpoint_path is not None and generator is None:
        raise ValueError("a checkpoint needs the run's generator")
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        full = dist.gather(theta0, mesh)
        like = checkpoint_like(ChainState(full, full.new_zeros(full.shape[0]),
                                          torch.zeros_like(full)), generator)
        ck = restore_state(checkpoint_path, like, theta0.device)
        states = dist.shard(ck.states, mesh)
        wr = WarmupResult(states, ck.step_size, ck.inv_mass)
        res = sample_blocked(states, kernel, n_samples, ck.step_size, ck.inv_mass,
                             block_size=block_size or 250, checkpoint_path=checkpoint_path,
                             start_done=ck.done, logger=logger, thin=thin,
                             generator=generator, mesh=mesh)
        return dist.gather(res, mesh), wr
    states = init_chain_states(theta0, grad_fn)
    wr = warmup(states, kernel, n_warmup, step_size=step_size,
                target_accept=target_accept, adapt_mass=adapt_mass,
                divergence_penalty=divergence_penalty, mesh=mesh)
    if logger is not None:
        log_warmup_phases(logger, wr.phase_accept, wr.phase_eps)
    if block_size is not None:
        res = sample_blocked(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass,
                             block_size=block_size, checkpoint_path=checkpoint_path,
                             logger=logger, thin=thin, generator=generator, mesh=mesh)
    else:
        res = sample(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass,
                     thin=thin)
    return dist.gather(res, mesh), wr
