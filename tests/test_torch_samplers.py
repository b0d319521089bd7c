"""starcat_torch sampler pieces against the JAX package with the same
inputs: the HMC and ChEES transitions fed the JAX keys' own draws, the
adaptation arithmetic, the relocate move for a fixed proposal, and the
NumPy diagnostics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import adapt as jadapt
from starcat import chees as jchees
from starcat import diagnostics as jdiag
from starcat import transdim as jtd
from starcat.configs import CONFIGS
from starcat.driver import init_chain_states as j_init_chain_states
from starcat.hmc import hmc_step
from starcat_torch import adapt as tadapt
from starcat_torch import chees as tchees
from starcat_torch import diagnostics as tdiag
from starcat_torch import transdim as ttd
from starcat_torch.convert import (
    chain_state_from_numpy,
    chees_adaptation_from_numpy,
    prior_from_jax,
    spec_from_jax,
)
from starcat_torch.fused_leapfrog import make_fused_leapfrog
from starcat_torch.hmc import hmc_transition
from starcat_torch.integrators import plain_trajectory
from starcat_torch.potential import log_likelihood, make_potential_and_grad

torch.set_num_threads(1)

C = 8
TOL = dict(theta=3e-4, u=0.3)


@pytest.fixture(scope="module")
def flagship():
    cfg = CONFIGS["cfg6_chees"]
    truth, img = cfg.make_data()
    rng = np.random.default_rng(1)
    theta = (np.asarray(truth)[None]
             + 0.05 * rng.standard_normal((C,) + truth.shape)).astype(np.float32)
    mask = jnp.ones(cfg.kmax)
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    states = j_init_chain_states(jax.random.key(5), jnp.asarray(theta), grad_fn)
    spec, prior = spec_from_jax(cfg.scene), prior_from_jax(cfg.prior)
    img_t = torch.from_numpy(np.array(img))
    pg_t = make_potential_and_grad(spec, img_t, prior)
    mask_t = torch.ones(cfg.kmax)
    return dict(cfg=cfg, img=np.asarray(img), mask=mask, grad_fn=grad_fn,
                states=states, spec=spec, prior=prior, img_t=img_t,
                mask_t=mask_t, grad_fn_t=lambda th: pg_t(th, mask_t))


def _port_states(states):
    return chain_state_from_numpy(np.asarray(states.theta), np.asarray(states.u),
                                  np.asarray(states.grad), "cpu")


def _close_states(st_t, st_j):
    np.testing.assert_allclose(st_t.theta.numpy(), np.asarray(st_j.theta), atol=TOL["theta"])
    np.testing.assert_allclose(st_t.u.numpy(), np.asarray(st_j.u), atol=TOL["u"])


@pytest.mark.parametrize("trajectory", ["plain", "fused"])
def test_hmc_transition_matches_jax_hmc_step(flagship, trajectory):
    f = flagship
    cfg, states = f["cfg"], f["states"]
    eps, n_leapfrog = 0.02, 8
    inv_mass = np.full((cfg.kmax, 3), 0.02, np.float32)
    inv_mass[:, 2] = 0.002
    # the JAX step's own draws (hmc.py:55-61), derived from the same keys
    keys = jax.vmap(lambda k: jax.random.split(k, 4))(states.key)
    u_jit = jax.vmap(jax.random.uniform)(keys[:, 3])
    p0 = jax.vmap(lambda k: jax.random.normal(k, (cfg.kmax, 3)))(keys[:, 1])
    u_acc = jax.vmap(jax.random.uniform)(keys[:, 2])
    new_j, info_j = jax.vmap(lambda s: hmc_step(
        s, f["grad_fn"], jnp.asarray(eps), jnp.asarray(inv_mass), n_leapfrog,
        f["mask"]))(states)

    if trajectory == "plain":
        traj = plain_trajectory(f["grad_fn_t"])
    else:
        fused = make_fused_leapfrog(f["spec"], f["img_t"], f["prior"], cfg.kmax, n_leapfrog)
        traj = lambda th, p, e, im, m, n, g: fused(th, p, e, im, m, grad=g)  # noqa: E731
    new_t, info_t = hmc_transition(
        _port_states(states), torch.tensor(eps), torch.from_numpy(inv_mass), f["mask_t"],
        torch.from_numpy(np.asarray(p0)), torch.from_numpy(np.asarray(u_jit)),
        torch.from_numpy(np.asarray(u_acc)), traj, n_leapfrog)
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    assert 0 < int(info_t.accepted.sum()) < C or np.allclose(info_t.accept_prob.numpy(), 1.0)
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               atol=0.05)
    _close_states(new_t, new_j)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_chees_iteration_matches_jax(flagship, impl):
    f = flagship
    cfg, states = f["cfg"], f["states"]
    eps, traj, i = 0.01, 0.1, 3
    inv_mass = np.full((cfg.kmax, 3), 0.02, np.float32)
    inv_mass[:, 2] = 0.002
    keys = jax.vmap(lambda k: jax.random.split(k, 3))(states.key)  # chees.py:191
    p0 = jax.vmap(lambda k: jax.random.normal(k, (cfg.kmax, 3)))(keys[:, 1])
    u_acc = jax.vmap(jax.random.uniform)(keys[:, 2])
    new_j, info_j, g_j, _ = jchees._chees_iteration(
        states, f["grad_fn"], jnp.asarray(eps), jnp.asarray(inv_mass), f["mask"],
        jchees._halton2(jnp.asarray(i)), jnp.asarray(traj), 1024, 1000.0)

    eps_t, inv_mass_t, traj_t = chees_adaptation_from_numpy(eps, inv_mass, traj, "cpu")
    leapfrog_impl = (None if impl == "plain" else tchees.make_fused_leapfrog_impl(
        f["spec"], f["img_t"], f["prior"], cfg.kmax))
    new_t, info_t, g_t = tchees._chees_iteration(
        _port_states(states), f["grad_fn_t"], eps_t, inv_mass_t, f["mask_t"],
        tchees._halton2(i), traj_t, 1024, 1000.0,
        torch.from_numpy(np.asarray(p0)), torch.from_numpy(np.asarray(u_acc)),
        leapfrog_impl)
    assert int(info_t.n_leapfrog) == int(info_j.n_leapfrog)
    np.testing.assert_array_equal(info_t.diverged.numpy(), np.asarray(info_j.diverged))
    np.testing.assert_array_equal((info_t.accept_prob.numpy() > np.asarray(u_acc)),
                                  (np.asarray(info_j.accept_prob) > np.asarray(u_acc)))
    _close_states(new_t, new_j)
    np.testing.assert_allclose(float(g_t), float(g_j), rtol=1e-3)


def test_chees_pooled_estimator_survives_nan_chain():
    """One chain with a non-finite trajectory must not NaN the pooled
    ChEES gradient, and must itself be rejected."""
    n_chains, k = 8, 1

    def gf(theta):
        bad = (theta.abs() > 50.0).flatten(1).any(dim=1)
        u = torch.where(bad, torch.nan, 0.5 * (theta * theta).sum(dim=(1, 2)))
        g = torch.where(bad[:, None, None], torch.nan, theta)
        return u, g

    gen = torch.Generator().manual_seed(0)
    theta = 0.3 * torch.randn((n_chains, k, 3), generator=gen)
    theta[0] = 100.0  # chain 0 lives in the NaN region
    u, grad = gf(theta)
    assert not torch.isfinite(u[0])
    states = tchees.ChainState(theta, u, grad)
    p0 = torch.randn((n_chains, k, 3), generator=gen)
    u_acc = torch.rand((n_chains,), generator=gen)
    new_states, info, g_logT = tchees._chees_iteration(
        states, gf, torch.tensor(0.2), torch.ones((k, 3)), torch.ones(k),
        tchees._halton2(3), torch.tensor(1.0), 64, 1000.0, p0, u_acc)
    assert torch.isfinite(g_logT), "pooled ChEES gradient NaN-poisoned"
    assert float(info.accept_prob[0]) == 0.0
    assert bool(info.diverged[0])
    assert torch.isfinite(new_states.theta[1:]).all()
    assert bool((info.accept_prob[1:] > 0.0).all())


def test_dual_averaging_matches_jax():
    acc = [0.3, 0.95, 0.7, 0.0, 0.85, 0.6, 0.99, 0.81]
    s_j, s_t = jadapt.da_init(0.05), tadapt.da_init(0.05, "cpu")
    for i, a in enumerate(acc):
        s_j = jadapt.da_update(s_j, jnp.float32(a), target=0.75)
        s_t = tadapt.da_update(s_t, torch.tensor(a), target=0.75)
        if i == 4:
            s_j, s_t = jadapt.da_restart(s_j), tadapt.da_restart(s_t)
        for x, y in zip(s_t, s_j):
            np.testing.assert_allclose(float(x), float(y), rtol=1e-6, atol=1e-7)


def test_welford_matches_jax():
    rng = np.random.default_rng(2)
    w_j, w_t = jadapt.welford_init((4, 3)), tadapt.welford_init((4, 3), "cpu")
    for _ in range(5):
        x = rng.standard_normal((16, 4, 3)).astype(np.float32) * 3.0 + 1.0
        w_j = jadapt.welford_update_batch(w_j, jnp.asarray(x))
        w_t = tadapt.welford_update_batch(w_t, torch.from_numpy(x))
    for x, y in zip(w_t, w_j):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tadapt.welford_variance(w_t).numpy(),
                               np.asarray(jadapt.welford_variance(w_j)), rtol=1e-6)


def test_halton_adam_and_lr_match_jax():
    for i in list(range(70)) + [499, 500, 1536, 65535]:
        assert tchees._halton2(i) == pytest.approx(float(jchees._halton2(jnp.asarray(i))),
                                                   rel=1e-6)
    z = jnp.zeros(())
    a_j = jchees._AdamState(z, z, z)
    zt = torch.zeros(())
    a_t = tadapt.AdamState(zt, zt, zt)
    for g in [0.5, -2.0, 10.0, 0.0, -0.01]:
        a_j, d_j = jchees._adam_update(a_j, jnp.float32(g), 0.05)
        a_t, d_t = tadapt.adam_update(a_t, torch.tensor(g), 0.05)
        np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-6)
    for n in [1, 64, 256, 300, 1024, 4096, 100000]:
        assert tchees.resolve_adam_lr(n) == pytest.approx(jchees.resolve_adam_lr(n), rel=1e-6)


def test_eq_disagreement_matches_jax():
    rng = np.random.default_rng(3)
    m1 = rng.standard_normal(64).astype(np.float32)
    for offset in (0.0, 1.5):
        m2 = (m1 * offset + rng.standard_normal(64)).astype(np.float32)
        want = float(jchees._eq_disagreement(jnp.asarray(m1), jnp.asarray(m2)))
        got = float(tchees._eq_disagreement(torch.from_numpy(m1), torch.from_numpy(m2)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _relocate_setup(flagship):
    f = flagship
    cfg = f["cfg"]
    theta = np.asarray(f["states"].theta)
    mask = np.ones(cfg.kmax, np.float32)
    mask_d = np.ones((C, cfg.kmax), np.float32)
    mask_d[np.arange(C), np.arange(C) % cfg.kmax] = 0.0  # one slot removed per chain
    return f, cfg, theta, mask, mask_d


def test_residual_log_q_and_matched_filter_match_jax(flagship):
    f, cfg, theta, _, mask_d = _relocate_setup(flagship)
    img = jnp.asarray(f["img"])
    lq_j = jax.vmap(lambda t, m: jtd._residual_log_q(t, m, cfg.scene, img, 1e-2))(
        theta, mask_d)
    mf_j = jax.vmap(lambda t, m: jtd._matched_filter_maps(t, m, cfg.scene, img))(
        theta, mask_d)
    th_t, m_t = torch.from_numpy(theta), torch.from_numpy(mask_d)
    lq_t = ttd._residual_log_q(th_t, m_t, f["spec"], f["img_t"], 1e-2)
    np.testing.assert_allclose(lq_t.numpy(), np.asarray(lq_j), rtol=1e-4, atol=1e-4)
    mf_t = ttd._matched_filter_maps(th_t, m_t, f["spec"], f["img_t"])
    for a, b in zip(mf_t, mf_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_truncated_normal_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.uniform(-1.0, 33.0, 50).astype(np.float32)
    x = rng.uniform(0.0, 32.0, 50).astype(np.float32)
    lp_j = jtd._tn_logpdf(jnp.asarray(x), jnp.asarray(mu), 0.12, 0.0, 32.0)
    lp_t = ttd._tn_logpdf(torch.from_numpy(x), torch.from_numpy(mu), 0.12, 0.0, 32.0)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4, atol=1e-4)
    # JAX's _tn_sample draws its own uniform; replay it with the key's draw
    keys = jax.random.split(jax.random.key(9), 50)
    s_j = jax.vmap(lambda k, m: jtd._tn_sample(k, m, 0.12, 0.0, 32.0))(keys, jnp.asarray(mu))
    u_j = jax.vmap(jax.random.uniform)(keys)
    s_t = ttd._tn_sample(torch.from_numpy(np.asarray(u_j)), torch.from_numpy(mu), 0.12, 0.0, 32.0)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("flux_sigma", [None, 0.1])
def test_relocate_step_matches_jax_for_fixed_proposals(flagship, flux_sigma):
    f, cfg, theta, mask, _ = _relocate_setup(flagship)
    img = jnp.asarray(f["img"])
    h, w = cfg.scene.height, cfg.scene.width
    ll_fn = lambda t, m: starcat.log_likelihood(t, m, cfg.scene, img)  # noqa: E731
    lls = jax.vmap(ll_fn, in_axes=(0, None))(theta, mask)
    keys = jax.random.split(jax.random.key(21), C)
    out_j = jax.vmap(lambda k, t, l: jtd.relocate_step(
        k, t, jnp.asarray(mask), l, ll_fn, cfg.prior, cfg.scene, img,
        1e-2, flux_sigma, 0.12))(keys, theta, lls)

    # the move's own draws (transdim.py:344-401), from the same keys
    sub = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    g_slot = jax.vmap(lambda k: jax.random.gumbel(k, (cfg.kmax,)))(sub[:, 0])
    g_pix = jax.vmap(lambda k: jax.random.gumbel(k, (h * w,)))(sub[:, 1])
    if flux_sigma is None:
        u_sub = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(sub[:, 2])
    else:
        kxy = jax.vmap(jax.random.split)(sub[:, 2])
        u_sub = jnp.stack([jax.vmap(jax.random.uniform)(kxy[:, 0]),
                           jax.vmap(jax.random.uniform)(kxy[:, 1])], axis=1)
    z = jax.vmap(jax.random.normal)(sub[:, 3])
    u_acc = jax.vmap(jax.random.uniform)(sub[:, 4])

    th_t = torch.from_numpy(theta)
    ll_t = log_likelihood(th_t, torch.from_numpy(mask), f["spec"], f["img_t"])
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(lls), rtol=1e-5)
    tn = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    theta_n, _, ll_n, info = ttd.relocate_step(
        th_t, torch.from_numpy(mask), ll_t, f["prior"], f["spec"], f["img_t"],
        tn(g_slot), tn(g_pix), tn(u_sub), tn(z), tn(u_acc), 1e-2, flux_sigma, 0.12)
    # log α holds a difference of two float32 log-likelihoods, each a sum of
    # 1024 terms of magnitude ~|ll| ~ 1e4 that rounds at ~1e-2 in either
    # package's summation order: hence the absolute term beside rtol 1e-4
    np.testing.assert_allclose(info.log_alpha.numpy(), np.asarray(out_j[3].log_alpha),
                               rtol=1e-4, atol=2e-2)
    np.testing.assert_array_equal(info.accepted.numpy(), np.asarray(out_j[3].accepted))
    np.testing.assert_allclose(theta_n.numpy(), np.asarray(out_j[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ll_n.numpy(), np.asarray(out_j[2]), rtol=1e-5)


def test_diagnostics_match_jax():
    rng = np.random.default_rng(5)
    a = np.cumsum(rng.standard_normal((4, 300)), axis=1) * 0.1 + rng.standard_normal((4, 300))
    b = rng.standard_normal((4, 300)) + 0.05
    assert tdiag.ess(a) == jdiag.ess(a)
    assert tdiag.split_rhat(a) == jdiag.split_rhat(a)
    assert tdiag.rhat_groups(a) == jdiag.rhat_groups(a)
    assert tdiag.summarize(a) == jdiag.summarize(a)
    assert tdiag.compare_moments(a, b, "x") == jdiag.compare_moments(a, b, "x")
    assert tdiag.moments_match(a, b) == jdiag.moments_match(a, b)
