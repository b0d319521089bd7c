"""starcat_torch scene and potential against the JAX package on the same
inputs (float32 on the CPU), plus float64 finite differences and the
masked-catalog edges."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat.configs import CONFIGS
from starcat_torch import potential as tp
from starcat_torch import scene as ts
from starcat_torch.convert import prior_from_jax, spec_from_jax

torch.set_num_threads(1)

PRESETS = ["cfg0_single_star", "cfg6_chees"]


def _setup(name, c=8, seed=0, jitter=0.05):
    cfg = CONFIGS[name]
    truth, img = cfg.make_data()
    rng = np.random.default_rng(seed)
    theta = (np.asarray(truth)[None]
             + jitter * rng.standard_normal((c,) + truth.shape)).astype(np.float32)
    return cfg, np.array(img), theta  # a writable copy of JAX's read-only array


def _masks(kmax, c, kind):
    if kind == "shared":
        return np.ones(kmax, np.float32)
    m = np.ones((c, kmax), np.float32)
    m[1::2, kmax // 2] = 0.0  # one dead slot on every odd chain
    return m


@pytest.mark.parametrize("mask_kind", ["shared", "per_chain"])
@pytest.mark.parametrize("name", PRESETS + ["cfg4_crowded"])
def test_potential_and_grad_matches_jax(name, mask_kind):
    cfg, img, theta = _setup(name)
    c, k = theta.shape[:2]  # cfg4's truth fills 50 of its 64 slots
    mask = _masks(k, c, mask_kind)
    pg = starcat.make_potential_and_grad(cfg.scene, jnp.asarray(img), cfg.prior)
    mask_j = np.broadcast_to(mask, (c, k))
    u_j, g_j = jax.vmap(pg)(jnp.asarray(theta), jnp.asarray(mask_j))

    pg_t = tp.make_potential_and_grad(spec_from_jax(cfg.scene),
                                      torch.from_numpy(img),
                                      prior_from_jax(cfg.prior))
    u_t, g_t = pg_t(torch.from_numpy(theta), torch.from_numpy(mask))
    # U atol 0.3 as in tests/test_pallas.py; at 128x128, U ~ 7e5 is a float32
    # sum of 16384 pixels whose ulp alone is 0.06, so a relative term joins
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=0.3,
                               rtol=2e-6 if name == "cfg4_crowded" else 0.0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3, atol=2e-2)
    u_only = tp.make_potential(spec_from_jax(cfg.scene), torch.from_numpy(img),
                               prior_from_jax(cfg.prior))
    np.testing.assert_allclose(
        u_only(torch.from_numpy(theta), torch.from_numpy(mask)).numpy(),
        u_t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", PRESETS)
def test_scene_prior_and_transforms_match_jax(name):
    cfg, img, theta = _setup(name, c=4)
    spec, prior = spec_from_jax(cfg.scene), prior_from_jax(cfg.prior)
    mask = np.ones(cfg.kmax, np.float32)
    th_t, m_t = torch.from_numpy(theta), torch.from_numpy(mask)
    x, y, f = tp.constrain(th_t, spec)
    xj, yj, fj = starcat.constrain(jnp.asarray(theta), cfg.scene)
    for a, b in zip((x, y, f), (xj, yj, fj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(tp.unconstrain(x, y, f, spec).numpy(), theta,
                               rtol=1e-4, atol=1e-4)
    lam_j = jax.vmap(lambda a, b, c: starcat.render_scene(a, b, c, jnp.asarray(mask),
                                                          cfg.scene))(xj, yj, fj)
    np.testing.assert_allclose(ts.render_scene(x, y, f, m_t, spec).numpy(),
                               np.asarray(lam_j), rtol=1e-5)
    lp_j = jax.vmap(lambda t: starcat.log_prior(t, jnp.asarray(mask), cfg.prior))(theta)
    np.testing.assert_allclose(tp.log_prior(th_t, m_t, prior).numpy(),
                               np.asarray(lp_j), rtol=1e-5)
    from starcat.potential import log_prior_grad as jlpg

    glp_j = jax.vmap(lambda t: jlpg(t, jnp.asarray(mask), cfg.prior))(theta)
    np.testing.assert_allclose(tp.log_prior_grad(th_t, m_t, prior).numpy(),
                               np.asarray(glp_j), rtol=1e-5, atol=1e-6)
    ll_j = jax.vmap(lambda t: starcat.log_likelihood(t, jnp.asarray(mask), cfg.scene,
                                                     jnp.asarray(img)))(theta)
    np.testing.assert_allclose(
        tp.log_likelihood(th_t, m_t, spec, torch.from_numpy(img)).numpy(),
        np.asarray(ll_j), rtol=1e-5)


def test_profiles_match_jax():
    from starcat.scene import gaussian_profile_1d, gaussian_profile_1d_grad

    centers = np.array([0.3, 7.5, 15.9], np.float32)
    coords = np.arange(16, dtype=np.float32) + 0.5
    for fj, ft in ((gaussian_profile_1d, ts.gaussian_profile_1d),
                   (gaussian_profile_1d_grad, ts.gaussian_profile_1d_grad)):
        np.testing.assert_allclose(
            ft(torch.from_numpy(centers), torch.from_numpy(coords), 1.5).numpy(),
            np.asarray(fj(jnp.asarray(centers), jnp.asarray(coords), 1.5)),
            rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ts.pixel_centers(16).numpy(), coords)


@pytest.mark.parametrize("name", PRESETS)
def test_grad_matches_finite_differences_float64(name):
    cfg, img, theta = _setup(name, c=1)
    spec, prior = spec_from_jax(cfg.scene), prior_from_jax(cfg.prior)
    th = torch.from_numpy(theta[0]).double()
    mask = torch.ones(cfg.kmax, dtype=torch.float64)
    pg = tp.make_potential_and_grad(spec, torch.from_numpy(img).double(), prior)
    _, g = pg(th[None], mask)
    d = th.numel()
    h = 1e-5
    e = torch.eye(d, dtype=torch.float64).reshape(d, *th.shape)
    u_plus, _ = pg(th[None] + h * e, mask)
    u_minus, _ = pg(th[None] - h * e, mask)
    fd = ((u_plus - u_minus) / (2 * h)).reshape(th.shape)
    np.testing.assert_allclose(g[0].numpy(), fd.numpy(), rtol=1e-5, atol=1e-4)


def test_all_dead_mask_gives_finite_u_and_zero_grad():
    cfg, img, theta = _setup("cfg6_chees", c=4)
    pg = tp.make_potential_and_grad(spec_from_jax(cfg.scene), torch.from_numpy(img),
                                    prior_from_jax(cfg.prior))
    u, g = pg(torch.from_numpy(theta), torch.zeros(cfg.kmax))
    assert torch.isfinite(u).all()
    assert bool((g == 0).all())
    # U of an empty catalog is the background-only likelihood
    lam = cfg.scene.background
    want = -float(np.sum(img * np.log(lam) - lam))
    np.testing.assert_allclose(u.numpy(), want, rtol=1e-6)


def test_extreme_unconstrained_params_stay_finite():
    cfg, img, theta = _setup("cfg6_chees", c=4)
    theta[:, :, :2] = np.where(np.arange(2) == 0, 30.0, -30.0)
    theta[1, :, :2] *= -1.0
    pg = tp.make_potential_and_grad(spec_from_jax(cfg.scene), torch.from_numpy(img),
                                    prior_from_jax(cfg.prior))
    u, g = pg(torch.from_numpy(theta), torch.ones(cfg.kmax))
    assert torch.isfinite(u).all() and torch.isfinite(g).all()


def test_zero_count_image_is_finite():
    cfg, img, theta = _setup("cfg6_chees", c=4)
    pg = tp.make_potential_and_grad(spec_from_jax(cfg.scene),
                                    torch.zeros_like(torch.from_numpy(img)),
                                    prior_from_jax(cfg.prior))
    u, g = pg(torch.from_numpy(theta), torch.ones(cfg.kmax))
    assert torch.isfinite(u).all() and torch.isfinite(g).all()


def test_mock_image_is_poisson_around_the_render():
    spec = ts.SceneSpec(16, 16, 1.5, 5.0)
    x, y, f = torch.tensor([8.3]), torch.tensor([7.6]), torch.tensor([300.0])
    gen = torch.Generator().manual_seed(7)
    imgs = torch.stack([ts.make_mock_image(gen, x, y, f, spec) for _ in range(200)])
    lam = ts.render_scene(x, y, f, torch.ones(1), spec)
    assert bool((imgs == imgs.round()).all()) and bool((imgs >= 0).all())
    # mean of 200 Poisson draws: sd of the mean is sqrt(lam / 200)
    z = (imgs.mean(0) - lam) / torch.sqrt(lam / 200)
    assert float(z.abs().max()) < 5.0


def test_sample_prior_moments():
    prior = tp.PriorSpec(5.0, 0.7)
    gen = torch.Generator().manual_seed(3)
    th = tp.sample_prior(gen, 4000, prior, device="cpu")
    assert th.shape == (4000, 3)
    assert abs(float(th[:, 2].mean()) - 5.0) < 0.05
    assert abs(float(th[:, 2].std()) - 0.7) < 0.05
    # positions are uniform on the image: sigmoid(u) ~ U(0, 1)
    s = torch.sigmoid(th[:, :2])
    assert abs(float(s.mean()) - 0.5) < 0.02
