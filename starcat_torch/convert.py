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
from .scene import SceneSpec


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
