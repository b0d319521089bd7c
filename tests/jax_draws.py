"""Random draws made from the JAX package's keys and handed to starcat_torch
as its injected draws, so both packages take the same step: a crowded-field
SMC temperature step's (shared by tests/test_torch_crowded.py and
scripts/cfg4_step_vs_jax.py) and a NUTS transition's
(tests/test_torch_nuts.py)."""
import jax
import numpy as np
import torch

from starcat_torch import smc
from starcat_torch.nuts import NUTSDraws
from starcat_torch.transdim import SweepDraws


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _vmap_draw(fn, keys):
    return _t(jax.vmap(fn)(keys))


def jax_sweep_draws(keys, k, hw):
    """transdim_sweep's draws with residual births from its per-particle
    keys (starcat/transdim.py:539 the sweep, :170 the residual birth/death,
    :420 split/merge) as the port's SweepDraws, for k catalog slots and hw
    pixels."""
    sub = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    bd = jax.vmap(lambda kk: jax.random.split(kk, 6))(sub[:, 1])
    sm = jax.vmap(lambda kk: jax.random.split(kk, 6))(sub[:, 2])
    return SweepDraws(
        _vmap_draw(jax.random.uniform, sub[:, 0]),
        (_vmap_draw(jax.random.uniform, bd[:, 0]),
         _vmap_draw(lambda kk: jax.random.gumbel(kk, (k,)), bd[:, 1]),
         _vmap_draw(lambda kk: jax.random.gumbel(kk, (hw,)), bd[:, 2]),
         _vmap_draw(lambda kk: jax.random.uniform(kk, (2,)), bd[:, 3]),
         _vmap_draw(jax.random.normal, bd[:, 4]),
         _vmap_draw(jax.random.uniform, bd[:, 5])),
        (_vmap_draw(jax.random.uniform, sm[:, 0]),
         _vmap_draw(lambda kk: jax.random.gumbel(kk, (k,)), sm[:, 1]),
         _vmap_draw(lambda kk: jax.random.gumbel(kk, (k,)), sm[:, 2]),
         _vmap_draw(jax.random.uniform, sm[:, 3]),
         _vmap_draw(lambda kk: jax.random.normal(kk, (2,)), sm[:, 4]),
         _vmap_draw(jax.random.uniform, sm[:, 5])))


def jax_step_draws(key, cfg_j, k, hw):
    """A temperature step's draws from the state key (starcat/smc.py:339-491;
    the Pallas RHMC kernel's per-particle key, k_mom, k_acc, k_jit at
    starcat/rhmc.py:304), for cfg_j.n_particles particles, k catalog slots
    and hw pixels."""
    p = cfg_j.n_particles
    _, k_res, k_mut, k_td, _ = jax.random.split(key, 5)
    sweeps = tuple(jax_sweep_draws(jax.random.split(kk, p), k, hw)
                   for kk in jax.random.split(k_td, cfg_j.n_transdim_sweeps))
    keys, moves = jax.random.split(k_mut, p), []
    for _ in range(cfg_j.n_mutation_steps):
        sub = jax.vmap(lambda kk: jax.random.split(kk, 4))(keys)
        moves.append((_vmap_draw(lambda kk: jax.random.normal(kk, (k, 3)), sub[:, 1]),
                      _vmap_draw(jax.random.uniform, sub[:, 3]),
                      _vmap_draw(jax.random.uniform, sub[:, 2])))
        keys = sub[:, 0]
    return smc.StepDraws(_t(jax.random.uniform(k_res)), sweeps, tuple(moves))


def jax_nuts_draws(keys, shape, max_depth):
    """nuts_step's draws from its per-chain state keys (starcat/nuts.py:151:
    k_mom gives p0; each doubling splits its key into kd, ks, km, draws the
    direction bernoulli(kd) and the merge uniform from km, and each leaf
    takes key, ku = split(key) from ks) as the port's NUTSDraws for theta
    of ``shape`` (K, 3) per chain.  Every doubling gets 2^(max_depth - 1)
    leaf uniforms; the first 2^d are the ones doubling d uses."""
    n_leaf = 1 << (max_depth - 1)

    def one(key):
        key, k_mom = jax.random.split(key)
        p0 = jax.random.normal(k_mom, shape)

        def doubling(key, _):
            key, kd, ks, km = jax.random.split(key, 4)

            def leaf(k, _):
                k, ku = jax.random.split(k)
                return k, jax.random.uniform(ku)

            _, u_leaf = jax.lax.scan(leaf, ks, None, length=n_leaf)
            return key, (jax.random.bernoulli(kd), u_leaf, jax.random.uniform(km))

        _, (right, u_leaf, u_merge) = jax.lax.scan(doubling, key, None, length=max_depth)
        return p0, right, u_leaf, u_merge

    p0, right, u_leaf, u_merge = jax.vmap(one)(keys)
    return NUTSDraws(_t(p0), torch.from_numpy(np.array(right)), _t(u_leaf), _t(u_merge))
