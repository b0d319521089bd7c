"""Carry scenes and sampler state over from the JAX package.

Each function takes what the reference hands out as NumPy arrays or plain
tuples (its ``SceneSpec``/``PriorSpec`` are NamedTuples) and never imports
JAX, so the same state can start both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .driver import ChainState
from .potential import PriorSpec
from .rhmc import RHMCConfig
from .scene import SceneSpec
from .smc import SMCConfig, SMCState
from .transdim import TransDimConfig
from .transdim_mcmc import TDState, TransDimMCMCConfig


def spec_from_jax(spec) -> SceneSpec:
    """(height, width, psf_sigma, background) -> SceneSpec."""
    height, width, psf_sigma, background = spec
    return SceneSpec(int(height), int(width), float(psf_sigma), float(background))


def prior_from_jax(prior) -> PriorSpec:
    """(logf_mean, logf_sigma) -> PriorSpec."""
    logf_mean, logf_sigma = prior
    return PriorSpec(float(logf_mean), float(logf_sigma))


def _f32(a, device) -> torch.Tensor:
    # a copy: the arrays JAX hands out are read-only, a tensor may be written
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def chain_state_from_numpy(theta, u, grad, device) -> ChainState:
    """A reference ChainState as NumPy — theta (C, K, 3), u (C,), grad
    (C, K, 3); its per-chain PRNG keys have no counterpart — as the port's
    state on ``device``."""
    return ChainState(_f32(theta, device), _f32(u, device), _f32(grad, device))


def chees_adaptation_from_numpy(step_size, inv_mass, traj, device):
    """The reference's adapted ChEES parameters as (eps (), inv_mass (K, 3),
    T ()) tensors on ``device``."""
    return _f32(step_size, device), _f32(inv_mass, device), _f32(traj, device)


def rhmc_config_from_jax(cfg) -> RHMCConfig:
    """The reference's RHMCConfig (a NamedTuple of the same fields)."""
    return RHMCConfig(**cfg._asdict())


def transdim_config_from_jax(cfg) -> TransDimConfig:
    """The reference's TransDimConfig (a NamedTuple of the same fields)."""
    return TransDimConfig(**cfg._asdict())


def transdim_mcmc_config_from_jax(cfg) -> TransDimMCMCConfig:
    """The reference's TransDimMCMCConfig, its nested TransDimConfig
    included.  The reference's ``*_pallas`` mutation names choose the
    trajectory, which the port chooses by RunConfig.kernel instead."""
    fields = cfg._asdict()
    fields["mutation"] = fields["mutation"].removesuffix("_pallas")
    fields["transdim"] = transdim_config_from_jax(cfg.transdim)
    return TransDimMCMCConfig(**fields)


def td_state_from_numpy(theta, mask, loglik, device) -> TDState:
    """A reference TDState as NumPy (theta (C, K, 3), mask (C, K), loglik
    (C,); its per-chain keys have no counterpart) on ``device``."""
    return TDState(_f32(theta, device), _f32(mask, device), _f32(loglik, device))


def smc_config_from_jax(cfg) -> SMCConfig:
    """The reference's SMCConfig, its nested TransDimConfig included.  The
    ``*_pallas`` mutation names become the port's (the kernel is chosen by
    RunConfig.kernel); the relocate sweeps are not ported, so a config that
    turns them on raises."""
    fields = cfg._asdict()
    if fields.pop("n_relocate_sweeps", 0) > 0:
        raise ValueError("SMC relocate sweeps are not ported")
    fields.pop("relocate_flux_sigma", None)
    fields.pop("relocate_pos_sigma", None)
    fields["mutation"] = fields["mutation"].removesuffix("_pallas")
    fields["transdim"] = transdim_config_from_jax(cfg.transdim)
    return SMCConfig(**fields)


def smc_state_from_numpy(theta, mask, loglik, beta, log_z, eps, n_steps,
                         mean_accept, final_done, device) -> SMCState:
    """A reference SMCState as NumPy (its key has no counterpart) on
    ``device``; the port's run counters start at 0."""
    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    return SMCState(_f32(theta, device), _f32(mask, device), _f32(loglik, device),
                    _f32(beta, device), _f32(log_z, device), _f32(eps, device),
                    i32(n_steps), _f32(mean_accept, device), i32(final_done),
                    i32(0), i32(0))
