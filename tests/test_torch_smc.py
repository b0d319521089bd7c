"""The SMC head of starcat_torch against the JAX package: the ESS, the
adaptive-beta bisection and systematic resampling on the same inputs and
uniforms; the initial population and one full temperature step (trans-d
sweeps, then hmc or full-metric rhmc mutations) fed the JAX keys' own
draws; and the statistical gates of tests/test_smc.py and
tests/test_smc_logz.py: logZ against quadrature, posterior and star-count
recovery, plateau stopping and islands."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import smc as jsmc
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.potential import sample_prior as j_sample_prior
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import api, smc
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.convert import (
    prior_from_jax,
    smc_config_from_jax,
    smc_state_from_numpy,
    spec_from_jax,
)
from starcat_torch.hmc import HMCConfig, run_hmc
from starcat_torch.potential import (
    PriorSpec,
    log_likelihood,
    log_prior,
    make_potential_and_grad,
    unconstrain,
)
from starcat_torch.scene import SceneSpec
from starcat_torch.transdim import SweepDraws, TransDimConfig

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_ess_from_logw_matches_jax():
    rng = np.random.default_rng(0)
    for logw in (rng.standard_normal(257) * 3.0, np.zeros(100),
                 np.array([0.0, -np.inf, -np.inf])):
        logw = logw.astype(np.float32)
        want = float(jsmc.ess_from_logw(jnp.asarray(logw)))
        got = float(smc.ess_from_logw(_t(logw)))
        assert got == pytest.approx(want, rel=1e-5)
    assert float(smc.ess_from_logw(torch.zeros(100))) == pytest.approx(100.0, rel=1e-5)


@pytest.mark.parametrize("beta,spread", [(0.0, 40.0), (0.3, 40.0), (0.97, 1.0)])
def test_next_dbeta_matches_jax(beta, spread):
    """Both branches: the bisection (a wide log-likelihood spread) and the
    full step (beta near 1, a narrow spread)."""
    rng = np.random.default_rng(1)
    loglik = (1.9e4 + spread * rng.standard_normal(512)).astype(np.float32)
    target = 0.5 * 512
    want = float(jsmc._next_dbeta(jnp.asarray(beta, jnp.float32), jnp.asarray(loglik), target))
    got = smc._next_dbeta(torch.tensor(beta, dtype=torch.float32), _t(loglik), target)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-9)
    full = float(1.0 - torch.tensor(beta, dtype=torch.float32))
    ess = float(smc.ess_from_logw(got * _t(loglik)))
    if float(got) < full:  # bisection: the ESS sits at the target from above
        assert target <= ess <= 1.01 * target
    if beta == 0.97:
        assert float(got) == full


@pytest.mark.parametrize("n_islands", [1, 4])
def test_systematic_resample_matches_jax(n_islands):
    logw = jax.random.normal(jax.random.key(1), (64,)) * 2.0
    key = jax.random.key(5)
    want = np.asarray(jsmc.systematic_resample(key, logw, n_islands=n_islands))
    if n_islands == 1:  # smc.py:222
        u0 = jax.random.uniform(key)
    else:               # smc.py:214-216: one uniform per island key
        u0 = jax.vmap(jax.random.uniform)(jax.random.split(key, n_islands))
    got = smc.systematic_resample(_t(logw), _t(u0), n_islands)
    np.testing.assert_array_equal(got.numpy(), want)


def test_systematic_resample_unbiased():
    """A port of tests/test_smc.py:23-38: E[count_i] = P w_i, and each
    trial's count is within 1 of P w_i."""
    logw = torch.log(torch.tensor([0.1, 0.4, 0.2, 0.05, 0.25]))
    n, trials = 5, 3000
    gen = torch.Generator().manual_seed(0)
    idx = torch.stack([smc.systematic_resample(logw, torch.rand((), generator=gen))
                       for _ in range(trials)]).numpy()
    w = np.exp(logw.numpy())
    counts = np.array([(idx == i).mean() * n for i in range(n)])
    np.testing.assert_allclose(counts, n * w, atol=0.05)
    per_trial = np.stack([(idx == i).sum(1) for i in range(n)], 1)
    assert np.abs(per_trial - n * w).max() <= 1.0 + 1e-6


def test_island_resampling_stays_in_island_and_unbiased():
    """A port of tests/test_smc.py:228-250."""
    logw = _t(jax.random.normal(jax.random.key(1), (32,)))
    ni, m = 4, 8
    gen = torch.Generator().manual_seed(2)
    idx = smc.systematic_resample(logw, torch.rand((ni,), generator=gen), ni).numpy()
    for i in range(ni):
        blk = idx[i * m:(i + 1) * m]
        assert blk.min() >= i * m and blk.max() < (i + 1) * m
    idxs = np.stack([smc.systematic_resample(logw, torch.rand((ni,), generator=gen), ni).numpy()
                     for _ in range(2000)])
    w0 = torch.softmax(logw[:m], 0).numpy()
    counts = np.array([(idxs[:, :m] == j).mean() * m for j in range(m)])
    np.testing.assert_allclose(counts, m * w0, atol=0.06)
    with pytest.raises(ValueError, match="islands"):
        smc.systematic_resample(logw, torch.rand((3,)), 3)


# -- one temperature step on the JAX keys' own draws -------------------------

P, K = 16, 3
SPEC_J = starcat.SceneSpec(8, 8, 1.5, 4.0)
PRIOR_J = starcat.PriorSpec(4.0, 0.7)


@pytest.fixture(scope="module")
def small():
    truth = starcat.sample_prior(jax.random.key(0), 2, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, SPEC_J)
    return dict(img=img, timg=_t(img), tspec=spec_from_jax(SPEC_J),
                tprior=prior_from_jax(PRIOR_J))


def _jax_cfg(mutation, n_sweeps=2):
    return jsmc.SMCConfig(n_particles=P, mutation=mutation, n_mutation_steps=2,
                          n_leapfrog=3, fixed_point_iters=3, n_transdim_sweeps=n_sweeps,
                          step_size0=0.05, transdim=JTransDimConfig(lam_count=2.0))


def test_init_smc_matches_jax_on_its_draws(small):
    s = small
    cfg_j = _jax_cfg("hmc")
    st_j = jsmc.init_smc(jax.random.key(3), SPEC_J, s["img"], PRIOR_J, K, cfg_j)
    k_theta, k_n, _ = jax.random.split(jax.random.key(3), 3)  # smc.py:293-307
    theta = jax.vmap(lambda k: j_sample_prior(k, K, PRIOR_J))(jax.random.split(k_theta, P))
    np.testing.assert_array_equal(np.asarray(theta), np.asarray(st_j.theta))
    st_t = smc.smc_state_from(s["tspec"], s["timg"], _t(theta), _t(st_j.mask),
                              smc_config_from_jax(cfg_j))
    np.testing.assert_allclose(st_t.loglik.numpy(), np.asarray(st_j.loglik), rtol=1e-6)
    for name in ("beta", "log_z", "eps", "mean_accept"):
        assert float(getattr(st_t, name)) == float(getattr(st_j, name))
    assert int(st_t.n_steps) == 0 and int(st_t.final_done) == 0


def test_init_smc_draws_a_truncated_poisson(small):
    s = small
    from scipy import stats

    cfg = smc.SMCConfig(n_particles=4000, n_transdim_sweeps=1,
                        transdim=TransDimConfig(lam_count=2.0))
    st = smc.init_smc(torch.Generator().manual_seed(1), s["tspec"], s["timg"], s["tprior"],
                      K, cfg)
    n = st.mask.sum(-1).long().numpy()
    pmf = stats.poisson.pmf(np.arange(K + 1), 2.0)
    emp = np.bincount(n, minlength=K + 1) / n.size
    assert np.abs(emp - pmf / pmf.sum()).max() < 0.03
    assert bool((st.mask[:, :-1] >= st.mask[:, 1:]).all())  # first n slots alive
    fixed = smc.init_smc(torch.Generator().manual_seed(1), s["tspec"], s["timg"],
                         s["tprior"], K, cfg._replace(n_transdim_sweeps=0, n_particles=8))
    assert bool((fixed.mask == 1).all())


def _jax_sweep_draws(keys):
    """transdim_sweep's draws from its per-particle keys (transdim.py:539,
    :103, :420) as the port's SweepDraws."""
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    bd = jax.vmap(lambda k: jax.random.split(k, 4))(sub[:, 1])
    sm = jax.vmap(lambda k: jax.random.split(k, 6))(sub[:, 2])
    return SweepDraws(
        _t(jax.vmap(jax.random.uniform)(sub[:, 0])),
        (_t(jax.vmap(jax.random.uniform)(bd[:, 0])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(bd[:, 1])),
         _t(jax.vmap(lambda k: j_sample_prior(k, 1, PRIOR_J)[0])(bd[:, 2])),
         _t(jax.vmap(jax.random.uniform)(bd[:, 3]))),
        (_t(jax.vmap(jax.random.uniform)(sm[:, 0])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sm[:, 1])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sm[:, 2])),
         _t(jax.vmap(jax.random.uniform)(sm[:, 3])),
         _t(jax.vmap(lambda k: jax.random.normal(k, (2,)))(sm[:, 4])),
         _t(jax.vmap(jax.random.uniform)(sm[:, 5]))))


def _jax_step_draws(key, cfg_j):
    """A temperature step's draws from the state key (smc.py:339-491)."""
    _, k_res, k_mut, k_td, _ = jax.random.split(key, 5)
    sweeps = tuple(_jax_sweep_draws(jax.random.split(k, P))
                   for k in jax.random.split(k_td, cfg_j.n_transdim_sweeps))
    keys, moves = jax.random.split(k_mut, P), []
    for _ in range(cfg_j.n_mutation_steps):
        # hmc_step (hmc.py:55) and the Pallas RHMC kernel (rhmc.py:304):
        # key, k_mom, k_acc, k_jit; the next step runs on the new key
        sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
        moves.append((_t(jax.vmap(lambda k: jax.random.normal(k, (K, 3)))(sub[:, 1])),
                      _t(jax.vmap(jax.random.uniform)(sub[:, 3])),
                      _t(jax.vmap(jax.random.uniform)(sub[:, 2]))))
        keys = sub[:, 0]
    return smc.StepDraws(_t(jax.random.uniform(k_res)), sweeps, tuple(moves))


@pytest.mark.parametrize("mutation", ["hmc", "rhmc_pallas"])
def test_temperature_step_matches_jax_on_its_draws(small, mutation):
    """One full step from the prior population: beta by bisection, logZ,
    resampling, two trans-d sweeps at the tempered likelihood and two
    mutations (the plain tempered leapfrog, or B6's plain trajectory
    against Pallas B6 in interpret mode), the eps controller and the
    untempered log-likelihood refresh.  Bounds: beta and logZ rtol 1e-5
    (float32 sums over the population), theta 1e-4 (tests/test_pallas_rhmc.py),
    log-likelihoods rtol 1e-5 with atol 2e-3."""
    s = small
    cfg_j = _jax_cfg(mutation)
    st0 = jsmc.init_smc(jax.random.key(4), SPEC_J, s["img"], PRIOR_J, K, cfg_j)
    st1 = jsmc.make_smc_step(SPEC_J, s["img"], PRIOR_J, cfg_j)(st0)
    cfg = smc_config_from_jax(cfg_j)
    assert cfg.mutation == mutation.removesuffix("_pallas")
    tst0 = smc_state_from_numpy(st0.theta, st0.mask, st0.loglik, st0.beta, st0.log_z,
                                st0.eps, st0.n_steps, st0.mean_accept, st0.final_done, "cpu")
    step = smc.make_smc_step(s["tspec"], s["timg"], s["tprior"], K, cfg)
    tst1 = step(tst0, _jax_step_draws(st0.key, cfg_j))
    assert float(tst1.beta) == pytest.approx(float(st1.beta), rel=1e-5)
    assert 0.0 < float(tst1.beta) < 1.0
    assert float(tst1.log_z) == pytest.approx(float(st1.log_z), rel=1e-5, abs=1e-3)
    np.testing.assert_array_equal(tst1.mask.numpy(), np.asarray(st1.mask))
    np.testing.assert_allclose(tst1.theta.numpy(), np.asarray(st1.theta), atol=1e-4)
    np.testing.assert_allclose(tst1.loglik.numpy(), np.asarray(st1.loglik), rtol=1e-5, atol=2e-3)
    assert float(tst1.mean_accept) == pytest.approx(float(st1.mean_accept), abs=5e-3)
    assert float(tst1.eps) == pytest.approx(float(st1.eps), rel=1e-4)
    assert int(tst1.n_steps) == 1 and int(tst1.final_done) == 0
    assert 0.0 < float(tst1.mean_accept) <= 1.0


def test_converters_carry_the_jax_smc_config():
    jcfg = JAX_CONFIGS["cfg3_transdim_smc"].smc
    assert smc_config_from_jax(jcfg) == CONFIGS["cfg3_transdim_smc"].smc
    cfg4 = smc_config_from_jax(JAX_CONFIGS["cfg4_crowded"].smc)
    assert cfg4.mutation == "rhmc_diag" and cfg4.plateau_window == 50
    with pytest.raises(ValueError, match="relocate"):
        smc_config_from_jax(jcfg._replace(n_relocate_sweeps=2))


# -- statistical gates --------------------------------------------------------

def _single_star():
    spec = SceneSpec(16, 16, 1.5, 5.0)
    prior = PriorSpec(5.0, 1.0)
    img = _t(starcat.make_mock_image(jax.random.key(7), jnp.array([8.3]), jnp.array([7.6]),
                                     jnp.array([300.0]), spec_from_jax(spec)))
    return spec, prior, img


@pytest.mark.parametrize("mutation,n_particles", [("hmc", 1024), ("rhmc", 256)])
def test_logz_matches_quadrature(mutation, n_particles):
    """A port of tests/test_smc_logz.py: logZ against a brute-force 3-D
    quadrature of the single-star evidence, within 4 spreads of three
    seeds + 0.2; the full-metric rhmc mutation runs at 256 particles."""
    spec = SceneSpec(8, 8, 1.2, 3.0)
    prior = PriorSpec(3.0, 0.5)
    img = _t(starcat.make_mock_image(jax.random.key(0), jnp.array([4.2]), jnp.array([3.8]),
                                     jnp.array([25.0]), spec_from_jax(spec)))
    ux = np.linspace(-5, 5, 80)
    s = np.linspace(3.0 - 4 * 0.5, 3.0 + 4 * 0.5, 60)
    grid = torch.tensor(np.stack(np.meshgrid(ux, ux, s, indexing="ij"), -1).reshape(-1, 1, 3))
    one = torch.ones(1, dtype=torch.float64)
    lp = (log_likelihood(grid, one, spec, img.double()) + log_prior(grid, one, prior)).numpy()
    m = lp.max()
    log_z_quad = m + np.log(np.exp(lp - m).sum() * (ux[1] - ux[0]) ** 2 * (s[1] - s[0]))
    cfg = smc.SMCConfig(n_particles=n_particles, mutation=mutation, n_mutation_steps=3,
                        n_leapfrog=8, step_size0=0.1, ess_target_frac=0.6)
    logzs = np.array([float(smc.run_smc(torch.Generator().manual_seed(10 + seed), spec, img,
                                        prior, 1, cfg).log_z) for seed in range(3)])
    spread = max(logzs.std(), 0.05)
    assert abs(logzs.mean() - log_z_quad) < 4 * spread + 0.2, (logzs, log_z_quad)


def test_smc_matches_hmc_single_star():
    """A port of tests/test_smc.py:56-86: fixed-K SMC against the HMC head
    on the single-star scene, means within z 4.5 and sds within 25%."""
    spec, prior, img = _single_star()
    cfg = smc.SMCConfig(n_particles=512, mutation="hmc", n_mutation_steps=4,
                        n_leapfrog=10, step_size0=0.1)
    res = smc.run_smc(torch.Generator().manual_seed(1), spec, img, prior, 1, cfg)
    assert float(res.beta) == 1.0 and int(res.n_steps) < cfg.max_steps
    d = res.theta[:, 0, :].numpy()
    pg = make_potential_and_grad(spec, img, prior)
    mask = torch.ones(1)
    truth = unconstrain(torch.tensor([8.3]), torch.tensor([7.6]), torch.tensor([300.0]), spec)
    gen = torch.Generator().manual_seed(4)
    theta0 = truth[None] + 0.01 * torch.randn((16, 1, 3), generator=gen)
    res_h, _ = run_hmc(gen, lambda th: pg(th, mask), theta0, mask, 800, 500,
                       HMCConfig(step_size=0.05, n_leapfrog=15))
    dh = res_h.thetas[:, :, 0, :].numpy()
    from starcat_torch import diagnostics

    for j in range(3):
        mu_s, sd_s = d[:, j].mean(), d[:, j].std()
        s_h = diagnostics.summarize(dh[:, :, j])
        se = np.sqrt(sd_s ** 2 / (d.shape[0] / 4) + s_h["mcse"] ** 2)
        assert abs(mu_s - s_h["mean"]) / se < 4.5, (j, mu_s, s_h["mean"])
        assert abs(sd_s - s_h["sd"]) / s_h["sd"] < 0.25, (j, sd_s, s_h["sd"])


@pytest.mark.parametrize("mutation", ["rhmc", "rhmc_diag"])
def test_riemannian_mutation_recovers_truth(mutation):
    """A port of tests/test_smc.py:89-106 for both Riemannian mutations."""
    spec, prior, img = _single_star()
    cfg = smc.SMCConfig(n_particles=128, mutation=mutation, n_mutation_steps=2,
                        n_leapfrog=5, fixed_point_iters=4, step_size0=0.3)
    res = smc.run_smc(torch.Generator().manual_seed(2), spec, img, prior, 1, cfg)
    assert float(res.beta) == 1.0 and float(res.mean_accept) > 0.3
    d = res.theta[:, 0, :].numpy()
    xs = spec.width / (1.0 + np.exp(-d[:, 0]))
    fs = np.exp(d[:, 2])
    assert abs(xs.mean() - 8.3) < 4 * xs.std() + 0.05
    assert abs(fs.mean() - 300.0) < 4 * fs.std() + 5.0


def test_transdim_smc_recovers_star_count():
    """A port of tests/test_smc.py:109-133: two bright stars, trans-d SMC
    concentrates n at 2 or a little more and recovers the total flux."""
    spec = SceneSpec(16, 16, 1.5, 3.0)
    prior = PriorSpec(5.5, 0.5)
    img = _t(starcat.make_mock_image(jax.random.key(0), jnp.array([5.0, 11.0]),
                                     jnp.array([6.0, 10.0]), jnp.array([400.0, 250.0]),
                                     spec_from_jax(spec)))
    cfg = smc.SMCConfig(n_particles=512, mutation="hmc", n_mutation_steps=3, n_leapfrog=8,
                        n_transdim_sweeps=2, step_size0=0.05,
                        transdim=TransDimConfig(lam_count=2.0, split_sigma=1.0))
    res = smc.run_smc(torch.Generator().manual_seed(2), spec, img, prior, 6, cfg)
    ns = res.mask.sum(-1).numpy()
    assert (ns >= 2).mean() > 0.9, ns.mean()
    assert ns.mean() < 3.5
    tot = (torch.exp(res.theta[..., 2]) * res.mask).sum(-1).numpy()
    assert abs(np.median(tot) - 650.0) / 650.0 < 0.2


def test_plateau_stopped_final_rounds():
    """A port of tests/test_smc.py:205-225: the posterior rounds stop at
    the earliest plateau, exactly 2 W rounds on a single-star scene, with
    the final rounds' own n_leapfrog."""
    spec, prior, img = _single_star()
    cfg = smc.SMCConfig(n_particles=256, mutation="hmc", n_leapfrog=5, n_mutation_steps=2,
                        n_transdim_sweeps=1, step_size0=0.1,
                        transdim=TransDimConfig(lam_count=1.0),
                        plateau_window=4, plateau_tol=0.5, max_final_rounds=60,
                        final_n_leapfrog=10)
    res = smc.run_smc(torch.Generator().manual_seed(3), spec, img, prior, 4, cfg)
    assert float(res.beta) == 1.0
    assert int(res.final_done) == 2 * cfg.plateau_window
    assert int(res.n_steps) > int(res.final_done)


def test_fixed_final_rounds_run_after_tempering():
    spec, prior, img = _single_star()
    cfg = smc.SMCConfig(n_particles=64, mutation="hmc", n_leapfrog=3, n_mutation_steps=1,
                        n_final_rounds=3)
    res = smc.run_smc(torch.Generator().manual_seed(3), spec, img, prior, 1, cfg)
    assert float(res.beta) == 1.0 and int(res.final_done) == 3


def test_island_diag_and_island_smc_recovers_truth():
    """Ports of tests/test_smc.py:253-269 and :300-310: n_islands > 1
    attaches the between-island stats, and island SMC still recovers the
    single-star flux; n_islands = 1 attaches none."""
    spec, prior, img = _single_star()
    cfg = smc.SMCConfig(n_particles=512, mutation="hmc", n_mutation_steps=2, n_leapfrog=5,
                        n_islands=8)
    res = smc.run_smc(torch.Generator().manual_seed(5), spec, img, prior, 1, cfg)
    d = res.island_diag
    assert d is not None and d["n_islands"] == 8
    assert np.isfinite(d["island_rhat_flux"]) and d["island_rhat_flux"] > 0.8
    assert np.isfinite(d["island_rhat_count"])
    assert 0 < d["island_ess_flux"] <= cfg.n_particles
    assert float(res.beta) == 1.0
    flux = np.exp(res.theta[:, 0, 2].numpy())
    assert abs(np.median(flux) - 300.0) / 300.0 < 0.15
    res1 = smc.run_smc(torch.Generator().manual_seed(5), spec, img, prior, 1,
                       cfg._replace(n_islands=1, n_particles=64))
    assert res1.island_diag is None


def test_max_steps_caps_the_pass_and_the_api_warns():
    cfg = apply_overrides(CONFIGS["cfg3_transdim_smc"],
                          {"smc.n_particles": 16, "smc.max_steps": 2, "smc.mutation": "hmc"})
    out = api.sample(cfg, "cpu", seed=0)
    assert out.stats["n_temp_steps"] == 2 and out.stats["beta"] < 1.0
    assert "max_steps" in out.stats["warning"]


def test_short_cfg3_runs_through_the_api_on_the_plain_path():
    """The cfg3 preset at 32 particles for 2 temperature steps, with the
    plain B6 trajectory chunked over 16 particles: (P, 1, K, 3) draws,
    (P, K) masks, the stats of the reference's smc head, and the summary
    with particles on the draw axis."""
    cfg = apply_overrides(CONFIGS["cfg3_transdim_smc"],
                          {"smc.n_particles": 32, "smc.max_steps": 2,
                           "smc.mutation_chunk": 16, "smc.n_islands": 2})
    out = api.sample(cfg, "cpu", seed=0)
    k = cfg.kmax
    assert out.thetas.shape == (32, 1, k, 3) and np.isfinite(out.thetas).all()
    assert out.masks.shape == (32, k)
    st = out.stats
    assert st["kernel"] == "rhmc_torch" and st["kernel_launches"] == 0
    for key in ("log_z", "n_temp_steps", "accept", "step_size", "beta", "final_rounds",
                "island_rhat_flux", "divergences", "solver_rejections"):
        assert key in st
    assert np.isfinite(st["log_z"]) and 0.0 <= st["accept"] <= 1.0
    summ = api.summarize_output(out)
    assert summ["total_flux"]["ess"] > 1.0 and np.isfinite(summ["total_flux"]["sd"])
    assert 0 <= summ["star_count"]["mode"] <= k


def test_smc_kernel_selection():
    cfg = CONFIGS["cfg3_transdim_smc"]
    cpu = torch.device("cpu")
    assert api.resolve_kernel("auto", cpu, cfg) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        api.resolve_kernel("cuda", cpu, cfg)
    hmc_cfg = apply_overrides(cfg, {"smc.mutation": "hmc"})
    # the hmc mutation has no kernel: auto takes the plain path on any device
    assert api.resolve_kernel("auto", torch.device("cuda"), hmc_cfg) == "torch"
    with pytest.raises(ValueError, match="no CUDA kernel"):
        api.resolve_kernel("cuda", torch.device("cuda"), hmc_cfg)
    with pytest.raises(ValueError, match="unknown SMC mutation"):
        api.sample(dataclasses.replace(cfg, smc=cfg.smc._replace(mutation="nuts")), "cpu")
