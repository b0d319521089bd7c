"""starcat_torch's ADVI head against the JAX package's: both fits over 50
steps on the same injected draws, the cosine schedule against optax's,
exactness on Gaussian targets, and frozen dead slots."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import starcat
from starcat import advi as jadvi
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat_torch import advi
from starcat_torch.convert import prior_from_jax, spec_from_jax
from starcat_torch.potential import make_potential_and_grad

torch.set_num_threads(1)

N_STEPS = 50
# After 50 Adam steps on the same draws the two packages' parameters differ
# by float32 rounding of the potential's gradient, which Adam's normalised
# step passes on at most one learning rate (5e-2) times its relative size
# (~1e-5 here): mu and log sigma (or L) within 1e-4.  The ELBO is a float32
# number of magnitude 1e2-1e3 on these scenes: within 1e-5 of it.
TOL_PARAM, RTOL_ELBO = 1e-4, 1e-5


def _scene(name):
    """(spec, prior, image, mu0 (K, 3), mask (K,)): cfg0, or a 16x16 scene
    of two stars held by K = 3 slots, the third dead."""
    if name == "cfg0":
        cfg = JAX_CONFIGS["cfg0_single_star"]
        truth, img = cfg.make_data()
        mu0 = np.asarray(truth) + np.array([[0.1, -0.1, -0.3]], np.float32)
        return cfg.scene, cfg.prior, img, mu0, np.ones(1, np.float32)
    spec, prior = starcat.SceneSpec(16, 16, 1.5, 5.0), starcat.PriorSpec(5.0, 1.0)
    x, y, f = jnp.array([5.2, 10.7]), jnp.array([6.1, 9.4]), jnp.array([250.0, 180.0])
    img = starcat.make_mock_image(jax.random.key(7), x, y, f, spec)
    mu0 = np.concatenate([np.asarray(starcat.unconstrain(x, y, f, spec)) + 0.1,
                          [[0.3, -0.4, 4.0]]]).astype(np.float32)
    return spec, prior, img, mu0, np.array([1.0, 1.0, 0.0], np.float32)


@pytest.mark.parametrize("name", ["cfg0", "k3"])
@pytest.mark.parametrize("family", ["mean_field", "full_rank"])
def test_fit_matches_jax_on_the_same_draws(name, family):
    spec, prior, img, mu0, mask = _scene(name)
    cfg = jadvi.ADVIConfig(n_steps=N_STEPS)
    pg = starcat.make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, jnp.asarray(mask))  # noqa: E731
    key = jax.random.key(5)
    # the reference's draws: each step's key from split(key, n_steps)
    # (starcat/advi.py:86, :152), n_mc normals of the params' shape
    keys = jax.random.split(key, N_STEPS)
    shape = (cfg.n_mc,) + mu0.shape if family == "mean_field" else (cfg.n_mc, mu0.size)
    xi = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(keys)))

    pg_t = make_potential_and_grad(spec_from_jax(spec), torch.from_numpy(np.array(img)),
                                   prior_from_jax(prior))
    mask_t = torch.from_numpy(mask)
    grad_fn_t = lambda th: pg_t(th, mask_t)  # noqa: E731
    config = advi.ADVIConfig(n_steps=N_STEPS)
    if family == "mean_field":
        ref = jadvi.fit_advi(key, grad_fn, jnp.asarray(mu0), jnp.asarray(mask), cfg)
        got = advi.fit_advi(grad_fn_t, torch.from_numpy(mu0), mask_t, xi, config)
        pairs = [(got.mu, ref.mu), (got.log_sigma, ref.log_sigma)]
    else:
        ref = jadvi.fit_advi_fullrank(key, grad_fn, jnp.asarray(mu0), cfg)
        got = advi.fit_advi_fullrank(grad_fn_t, torch.from_numpy(mu0), xi, config)
        pairs = [(got.mu, ref.mu), (got.scale_tril, ref.scale_tril)]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_PARAM)
    np.testing.assert_allclose(got.elbo_trace.numpy(), np.asarray(ref.elbo_trace),
                               rtol=RTOL_ELBO)
    # the fit moved: the trace rose and the parameters left their start
    assert got.elbo_trace[-10:].mean() > got.elbo_trace[:10].mean()
    assert float((got.mu - torch.from_numpy(mu0)).abs().max()) > 1e-2
    if family == "mean_field":   # a dead slot stays where it started
        dead = mask == 0
        np.testing.assert_array_equal(got.mu.numpy()[dead], mu0[dead])
        np.testing.assert_array_equal(got.log_sigma.numpy()[dead], config.log_sigma0)


@pytest.mark.parametrize("n_steps", [50, 3000])
def test_cosine_schedule_equals_optax(n_steps):
    """Equal at every count, past the end too, within optax's float32
    rounding: its terms are of size one times the rate, so two float32
    spacings of the rate (the port computes in float64)."""
    lr = 5e-2
    sched = optax.cosine_decay_schedule(lr, n_steps, 1e-2)
    for count in range(n_steps + 3):
        assert advi.cosine_decay(lr, n_steps, count) == pytest.approx(
            float(sched(count)), rel=0, abs=lr * 2.4e-7), count


def test_advi_exact_on_gaussian():
    """The mean-field family holds a diagonal Gaussian target: exact fit."""
    mu_t = torch.tensor([[1.0, -2.0, 0.5]])
    sigma_t = torch.tensor([[0.5, 2.0, 1.0]])

    def grad_fn(theta):
        z = (theta - mu_t) / sigma_t
        return 0.5 * torch.sum(z * z, dim=(-2, -1)), z / sigma_t

    config = advi.ADVIConfig(n_steps=3000, n_mc=16, learning_rate=5e-2)
    xi = torch.randn((3000, 16, 1, 3), generator=torch.Generator().manual_seed(0))
    res = advi.fit_advi(grad_fn, torch.zeros((1, 3)), torch.ones(1), xi, config)
    np.testing.assert_allclose(res.mu.numpy(), mu_t.numpy(), atol=0.08)
    np.testing.assert_allclose(torch.exp(res.log_sigma).numpy(), sigma_t.numpy(), rtol=0.15)
    e = res.elbo_trace.numpy()
    assert e[-100:].mean() > e[:100].mean()


def test_fullrank_advi_recovers_correlation():
    """The full-rank family recovers an off-diagonal covariance that the
    mean-field family cannot."""
    a = np.array([[1.0, 0.8, 0.0], [0.8, 1.0, 0.3], [0.0, 0.3, 1.0]])
    cov = a @ a.T
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))

    def grad_fn(theta):   # theta (N, 1, 3)
        g = theta @ prec
        return 0.5 * torch.sum(theta * g, dim=(-2, -1)), g

    config = advi.ADVIConfig(n_steps=4000, n_mc=16, learning_rate=3e-2)
    xi = torch.randn((4000, 16, 3), generator=torch.Generator().manual_seed(0))
    res = advi.fit_advi_fullrank(grad_fn, torch.zeros((1, 3)), xi, config)
    fitted = (res.scale_tril @ res.scale_tril.T).numpy()
    np.testing.assert_allclose(fitted, cov, atol=0.4, rtol=0.25)
    corr = fitted / np.sqrt(np.outer(np.diag(fitted), np.diag(fitted)))
    corr_true = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    np.testing.assert_allclose(corr, corr_true, atol=0.1)
    draws = advi.advi_sample_fullrank(torch.Generator().manual_seed(1), res, 2000)
    assert draws.shape == (2000, 1, 3)
    np.testing.assert_allclose(np.cov(draws.reshape(2000, 3).numpy().T), cov, atol=0.5,
                               rtol=0.3)


def test_advi_dead_slots_frozen():
    spec, prior = starcat.SceneSpec(16, 16, 1.5, 5.0), starcat.PriorSpec(4.0, 1.0)
    img = starcat.make_mock_image(jax.random.key(0), jnp.array([8.0]), jnp.array([8.0]),
                                  jnp.array([100.0]), spec)
    pg = make_potential_and_grad(spec_from_jax(spec), torch.from_numpy(np.array(img)),
                                 prior_from_jax(prior))
    mask = torch.tensor([1.0, 0.0])
    mu0 = torch.tensor([[0.0, 0.0, 4.0], [1.0, -1.0, 2.0]])
    config = advi.ADVIConfig(n_steps=300)
    xi = torch.randn((300, config.n_mc, 2, 3), generator=torch.Generator().manual_seed(2))
    res = advi.fit_advi(lambda th: pg(th, mask), mu0, mask, xi, config)
    assert torch.equal(res.mu[1], mu0[1])
    assert torch.equal(res.log_sigma[1], torch.full((3,), -2.0))
    assert float((res.mu[0] - mu0[0]).abs().max()) > 0.05
    draws = advi.advi_sample(torch.Generator().manual_seed(3), res, mask, 50)
    assert torch.equal(draws[:, 1], mu0[1].expand(50, 3))
    assert float(draws[:, 0].std(0).min()) > 0


def test_kernel_grad_fn_is_the_potential_on_the_cpu():
    """dispatch.make_grad_fn (B1 at n_steps = 0 on the card) takes its
    plain version on CPU tensors: the potential and its gradient, exactly."""
    from starcat_torch import dispatch
    from starcat_torch.configs import CONFIGS

    cfg = CONFIGS["cfg7_advi"]
    truth, img = cfg.make_data()
    mask = torch.ones(cfg.kmax)
    theta = truth[None] + 0.05 * torch.randn((8, cfg.kmax, 3),
                                             generator=torch.Generator().manual_seed(4))
    u, g = dispatch.make_grad_fn(cfg.scene, img, cfg.prior, mask)(theta)
    u_ref, g_ref = make_potential_and_grad(cfg.scene, img, cfg.prior)(theta, mask)
    assert torch.equal(u, u_ref) and torch.equal(g, g_ref)
