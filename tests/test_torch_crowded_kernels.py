"""The plain versions of the crowded-field kernels B5 and B4 against the JAX
package on the same inputs, at non-square scenes so that a swapped axis
cannot hide: B5's (the plain leapfrog) against the reference's MXU gradient
evaluation (``_grad_eval_mxu``, chains packed (T, 3K)) and against Pallas
B5 in interpret mode; B4's (the generalised leapfrog with the autograd
dH/dtheta) against the pure-JAX MXU tile (``rhmc_diag_trajectory_mxu``)
and against Pallas B4 in interpret mode.  On the CPU the kernels' wrappers
run these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_mxu as pmx
from starcat import pallas_rhmc_diag as prd
from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch import fused_rhmc_diag_crowded as frdc
from starcat_torch.convert import prior_from_jax, spec_from_jax
from starcat_torch.fused_leapfrog import fused_leapfrog_reference
from starcat_torch.fused_rhmc_diag import fused_rhmc_diag_reference

torch.set_num_threads(1)

T = 8          # chains: one Pallas tile
JITTER = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _scene(h, w, k, seed):
    """A non-square crowded-style scene with k stars, chains near the truth,
    momenta, and a per-chain mask with a dead slot on every odd chain."""
    spec = starcat.SceneSpec(h, w, 1.5, 5.0)
    prior = starcat.PriorSpec(4.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(seed), k, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(seed + 1), x, y, f, spec),
                     np.float32)
    rng = np.random.default_rng(seed)
    theta = (np.asarray(truth)[None] + 0.05 * rng.standard_normal((T, k, 3))).astype(np.float32)
    p = rng.standard_normal((T, k, 3)).astype(np.float32)
    mask_c = np.ones((T, k), np.float32)
    mask_c[1::2, -1] = 0.0
    return dict(spec=spec, prior=prior, img=img, theta=theta, p=p, mask_c=mask_c, k=k,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


@pytest.fixture(scope="module")
def wide():
    return _scene(24, 20, 6, 0)


@pytest.fixture(scope="module")
def small():
    return _scene(16, 12, 4, 3)


def _masks(s, form):
    """(the (T, K) mask the JAX tile takes, the torch mask: (K,) or (T, K))."""
    if form == "shared":
        m = np.ones(s["k"], np.float32)
        return np.broadcast_to(m, (T, s["k"])).copy(), torch.from_numpy(m)
    return s["mask_c"], torch.from_numpy(s["mask_c"])


def _energy_tol(x, base):
    """base plus eight float32 spacings at the magnitude of x: U and h are
    float32 sums over every pixel, rounded in each package's own order."""
    return base + 8.0 * float(np.spacing(np.float32(np.abs(np.asarray(x)).max())))


# -- B5: the plain leapfrog ---------------------------------------------------

@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b5_reference_matches_grad_eval_mxu(wide, form):
    """U and grad U at theta (n_steps = 0) against the reference's MXU
    evaluation.  grad to 1e-4 relative to 1 + |grad| (tests/test_pallas_mxu.py
    holds Pallas B5 to the XLA path so); U as _energy_tol(2e-3)."""
    s = wide
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    u_j, g_j = pmx._grad_eval_mxu(pmx._pack_rows(jnp.asarray(s["theta"]), k),
                                  jnp.asarray(mask_j), jnp.asarray(s["img"]), s["spec"],
                                  s["prior"], k, with_u=True)
    g_j = np.asarray(pmx._unpack_rows(g_j, k))
    _, _, u_t, g_t = fused_leapfrog_reference(
        s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]), _t(s["p"]), 0.01,
        torch.ones((k, 3)), mask_t, 0)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=_energy_tol(u_j, 2e-3))
    rel = np.abs(g_t.numpy() - g_j) / (1.0 + np.abs(g_j))
    assert rel.max() < 1e-4, rel.max()
    if form == "per_chain":
        assert np.all(g_t.numpy()[s["mask_c"] == 0] == 0.0)


@pytest.mark.parametrize("grad_in", [False, True])
@pytest.mark.parametrize("n_steps", [0, 1, 3])
def test_b5_reference_matches_pallas_interpret(small, n_steps, grad_in):
    """Pallas B5 in interpret mode against the wrapper on CPU tensors, at
    shared (even L) or per-chain (odd L) masks with per-chain eps.  Bounds:
    theta 3e-4 and p 5e-3 (tests/test_pallas.py:37-39), U as
    _energy_tol(2e-3), grad 1e-4 relative to 1 + |grad|."""
    s = small
    k = s["k"]
    form = "per_chain" if n_steps % 2 else "shared"
    mask_j, mask_t = _masks(s, form)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(k)
    eps = (0.01 * (1.0 + 0.1 * np.arange(T))).astype(np.float32)
    inv_mass = np.full((k, 3), 0.8, np.float32)
    p = s["p"] * mask_j[..., None]
    grad = None
    if grad_in:
        grad = fused_leapfrog_reference(s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]),
                                        _t(p), 0.01, _t(inv_mass), mask_t, 0)[3].numpy()
    out_j = pmx.make_pallas_leapfrog_mxu(s["spec"], jnp.asarray(s["img"]), s["prior"], k,
                                         n_steps, interpret=True)(
        jnp.asarray(s["theta"]), jnp.asarray(p), jnp.asarray(eps), jnp.asarray(inv_mass),
        jmask, None if grad is None else jnp.asarray(grad))
    out_t = flc.make_fused_leapfrog(s["tspec"], _t(s["img"]), s["tprior"], k, n_steps)(
        _t(s["theta"]), _t(p), _t(eps), _t(inv_mass), mask_t,
        grad=None if grad is None else _t(grad))
    th_j, p_j, u_j, g_j = (np.asarray(o) for o in out_j)
    np.testing.assert_allclose(out_t[0].numpy(), th_j, atol=3e-4)
    np.testing.assert_allclose(out_t[1].numpy(), p_j, atol=5e-3)
    np.testing.assert_allclose(out_t[2].numpy(), u_j, rtol=0, atol=_energy_tol(u_j, 2e-3))
    rel = np.abs(out_t[3].numpy() - g_j) / (1.0 + np.abs(g_j))
    assert rel.max() < 1e-4, rel.max()
    if form == "per_chain":  # dead slots frozen bit for bit
        dead = s["mask_c"] == 0
        np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])


# -- B4: the diagonal-Fisher Riemannian trajectory ---------------------------

# tests/test_torch_rhmc.py's bounds against the Pallas formulation: theta
# 1e-5, p 1e-4, the solver residual 1e-6; h and u as _energy_tol(2e-3).
TOL = dict(theta=1e-5, p=1e-4, resid=1e-6)


def _check_trajectory(out_t, th, p, h0, h1, u1, resid):
    np.testing.assert_allclose(out_t[0].numpy(), th, atol=TOL["theta"])
    np.testing.assert_allclose(out_t[1].numpy(), p, atol=TOL["p"])
    for got, want in zip(out_t[2:5], (h0, h1, u1)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_energy_tol(want, 2e-3))
    np.testing.assert_allclose(out_t[5].numpy(), resid, atol=TOL["resid"])


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b4_reference_matches_mxu_tile(wide, beta, form):
    s = wide
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    n_steps, fpi, eps = 3, 4, 0.02
    out_j = prd.rhmc_diag_trajectory_mxu(
        pmx._pack_rows(jnp.asarray(s["theta"]), k), pmx._pack_rows(jnp.asarray(s["p"]), k),
        jnp.full((T, 1), eps), jnp.asarray(mask_j), jnp.asarray(s["img"]), s["spec"],
        s["prior"], k, n_steps, fpi, beta, JITTER)
    out_t = fused_rhmc_diag_reference(
        s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]), _t(s["p"]), eps, mask_t,
        beta, n_steps, fpi, JITTER)
    _check_trajectory(out_t, np.asarray(pmx._unpack_rows(out_j[0], k)),
                      np.asarray(pmx._unpack_rows(out_j[1], k)),
                      *(np.asarray(o) for o in out_j[2:]))
    dead = s["mask_c"] == 0.0 if form == "per_chain" else np.zeros((T, k), bool)
    np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])
    np.testing.assert_array_equal(out_t[1].numpy()[dead], 0.0)


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b4_reference_matches_pallas_interpret(small, form):
    """Pallas B4 in interpret mode against the wrapper on CPU tensors,
    beta 0.7 as a tensor, per-chain eps."""
    s = small
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    eps = (0.01 * (1.0 + 0.1 * np.arange(T))).astype(np.float32)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(k)
    out_j = prd.make_pallas_rhmc_diag_mxu(
        s["spec"], jnp.asarray(s["img"]), s["prior"], k, n_steps=2, fixed_point_iters=3,
        jitter=JITTER, interpret=True)(
        jnp.asarray(s["theta"]), jnp.asarray(s["p"]), jnp.asarray(eps), jmask, 0.7)
    out_t = frdc.make_fused_rhmc_diag(s["tspec"], _t(s["img"]), s["tprior"], k, 2, 3, JITTER)(
        _t(s["theta"]), _t(s["p"]), _t(eps), mask_t, torch.tensor(0.7))
    _check_trajectory(out_t, *(np.asarray(o) for o in out_j))
