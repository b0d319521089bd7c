"""The full-Fisher Riemannian path of starcat_torch against the JAX package
on the same inputs: the scene Jacobian and the dense metric, the
Hamiltonian and its derivatives (autograd through the Cholesky against
JAX's autodiff), the plain version of kernel B6 against the pure-JAX tile
and against Pallas B6 in interpret mode, and the RHMC transition and the
trans-d rhmc transition fed the JAX keys' own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_rhmc as prh
from starcat import transdim_mcmc as jtdm
from starcat.driver import ChainState as JChainState
from starcat.metric import make_metric_fn as j_metric_fn
from starcat.metric import scene_jacobian as j_scene_jacobian
from starcat.pallas_kernels import _pack, _unpack
from starcat.potential import make_tempered_potential_and_grad as j_tempered
from starcat.potential import sample_prior as j_sample_prior
from starcat.rhmc import RHMCConfig as JRHMCConfig
from starcat.rhmc import make_pallas_rhmc_kernel
from starcat.rhmc import make_rhmc_functions as j_rhmc_functions
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import fused_rhmc as fr
from starcat_torch import rhmc as trhmc
from starcat_torch.convert import (
    chain_state_from_numpy,
    prior_from_jax,
    rhmc_config_from_jax,
    spec_from_jax,
    td_state_from_numpy,
    transdim_mcmc_config_from_jax,
)
from starcat_torch.metric import make_metric_fn, scene_jacobian
from starcat_torch.potential import make_tempered_potential_and_grad
from starcat_torch.transdim import SweepDraws
from starcat_torch.transdim_mcmc import TDDraws, make_transdim_kernel

torch.set_num_threads(1)

# the shape of tests/test_pallas_rhmc.py:22, per-chain masks with a dead slot
K, H, W, C = 4, 12, 12, 8
JITTER = 1e-3
# tests/test_pallas_rhmc.py:134-141: the trajectory against the XLA
# integrator within theta 1e-4, p 1e-3, h 2e-3; the solver residual is a
# ratio of float32 deltas, held at 1e-6
TOL = dict(theta=1e-4, p=1e-3, h=2e-3, resid=1e-6)


@pytest.fixture(scope="module")
def scene():
    spec = starcat.SceneSpec(H, W, 1.5, 5.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(0), K, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(1), x, y, f, spec), np.float32)
    rng = np.random.default_rng(2)
    theta = (np.asarray(truth)[None] + 0.05 * rng.standard_normal((C, K, 3))).astype(np.float32)
    mask_c = np.ones((C, K), np.float32)
    mask_c[1::2, -1] = 0.0  # dead slots on every odd chain
    xi = rng.standard_normal((C, K, 3)).astype(np.float32)
    return dict(spec=spec, prior=prior, img=img, theta=theta, mask_c=mask_c, xi=xi,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


def _masks(s, form):
    """(JAX mask per chain, torch mask): shared (K,) or per chain (C, K)."""
    if form == "shared":
        m = np.ones(K, np.float32)
        return np.broadcast_to(m, (C, K)).copy(), torch.from_numpy(m)
    return s["mask_c"], torch.from_numpy(s["mask_c"])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_scene_jacobian_and_metric_match_jax(scene, beta, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    lam_j, j_j = jax.vmap(lambda t, m: j_scene_jacobian(t, m, s["spec"]))(s["theta"], mask_j)
    lam_t, j_t = scene_jacobian(_t(s["theta"]), mask_t, s["tspec"])
    assert j_t.shape == (C, K, 3, H, W)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), rtol=1e-5, atol=1e-5)
    jm = j_metric_fn(s["spec"], s["prior"], JITTER)
    g_j = jax.vmap(lambda t, m: jm(t, m, beta))(s["theta"], mask_j)
    g_t = make_metric_fn(s["tspec"], s["tprior"], JITTER)(_t(s["theta"]), mask_t, beta)
    assert g_t.shape == (C, 3 * K, 3 * K)
    # tests/test_pallas_rhmc.py:71 holds the tile's metric to atol 2e-5
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=2e-5)
    if form == "per_chain":  # dead slots: exact identity rows, plus the jitter
        d = 3 * (K - 1)
        np.testing.assert_array_equal(g_t[1::2, d:, :].numpy(),
                                      np.broadcast_to(np.eye(3 * K)[d:] * (1.0 + JITTER),
                                                      (C // 2, 3, 3 * K)).astype(np.float32))


def _functions(s, beta):
    tpg_j = j_tempered(s["spec"], jnp.asarray(s["img"]), s["prior"])
    jm = j_metric_fn(s["spec"], s["prior"], JITTER)
    fj = j_rhmc_functions(lambda th, m: tpg_j(th, m, beta)[0], lambda th, m: jm(th, m, beta))
    tpg_t = make_tempered_potential_and_grad(s["tspec"], _t(s["img"]), s["tprior"])
    tm = make_metric_fn(s["tspec"], s["tprior"], JITTER)
    ft = trhmc.make_rhmc_functions(lambda th, m: tpg_t(th, m, beta)[0],
                                   lambda th, m: tm(th, m, beta))
    return fj, ft


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_hamiltonian_and_derivatives_match_jax_autodiff(scene, beta):
    s = scene
    (ham_j, dhdt_j, dhdp_j), (ham_t, dhdt_t, dhdp_t) = _functions(s, beta)
    p = (3.0 * s["xi"] * s["mask_c"][..., None]).astype(np.float32)
    args_j = (jnp.asarray(s["theta"]).reshape(C, -1), jnp.asarray(p).reshape(C, -1),
              jnp.asarray(s["mask_c"]))
    args_t = (_t(s["theta"]), _t(p), _t(s["mask_c"]))
    np.testing.assert_allclose(ham_t(*args_t).numpy(), np.asarray(jax.vmap(ham_j)(*args_j)),
                               rtol=1e-6, atol=2e-3)
    # tests/test_pallas_rhmc.py:106-108: atol 2e-3, rtol 1e-4
    np.testing.assert_allclose(dhdt_t(*args_t).numpy().reshape(C, -1),
                               np.asarray(jax.vmap(dhdt_j)(*args_j)), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(dhdp_t(*args_t).numpy().reshape(C, -1),
                               np.asarray(jax.vmap(dhdp_j)(*args_j)), rtol=1e-4, atol=1e-4)


def test_cholesky_or_nan_marks_an_indefinite_metric():
    g = torch.eye(3).repeat(2, 1, 1)
    g[1, 2, 2] = -1.0
    chol = trhmc.cholesky_or_nan(g)
    torch.testing.assert_close(chol[0], torch.eye(3))
    assert bool(torch.isnan(chol[1]).all())


def _check(out_t, want, tol):
    th, p, h0, h1, u1, resid = want
    np.testing.assert_allclose(out_t[0].numpy(), th, atol=tol["theta"])
    np.testing.assert_allclose(out_t[1].numpy(), p, atol=tol["p"])
    for got, ref in zip(out_t[2:5], (h0, h1, u1)):
        np.testing.assert_allclose(got.numpy(), ref, atol=tol["h"])
    np.testing.assert_allclose(out_t[5].numpy(), resid, atol=tol["resid"])


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_reference_matches_jax_tile(scene, beta, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    n_steps, fpi, eps = 3, 5, 0.02
    out_j = prh.rhmc_trajectory_tile(
        _pack(jnp.asarray(s["theta"]), K), _pack(jnp.asarray(s["xi"]), K),
        jnp.full((1, C), eps), jnp.asarray(mask_j).T, jnp.asarray(s["img"]),
        s["spec"], s["prior"], K, n_steps, fpi, beta, JITTER)
    out_t = fr.fused_rhmc_reference(s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]),
                                    _t(s["xi"]), eps, mask_t, beta, n_steps, fpi, JITTER)
    want = (np.asarray(_unpack(out_j[0], K)), np.asarray(_unpack(out_j[1], K)),
            *(np.asarray(o) for o in out_j[2:]))
    _check(out_t, want, TOL)
    assert float(out_t[5].max()) > 0.0
    # dead slots frozen bit for bit, their momentum exactly zero
    dead = mask_j == 0.0
    np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])
    assert not out_t[1].numpy()[dead].any()


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_reference_matches_pallas_interpret(scene, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    beta = 0.7
    eps = (0.01 * (1.0 + 0.1 * np.arange(C))).astype(np.float32)
    fused_j = prh.make_pallas_rhmc_leapfrog(s["spec"], jnp.asarray(s["img"]), s["prior"], K,
                                            n_steps=2, fixed_point_iters=3, jitter=JITTER,
                                            interpret=True)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(K)
    out_j = fused_j(jnp.asarray(s["theta"]), jnp.asarray(s["xi"]), jnp.asarray(eps), jmask, beta)
    # the wrapper on CPU tensors runs the plain version
    out_t = fr.make_fused_rhmc(s["tspec"], _t(s["img"]), s["tprior"], K, 2, 3, JITTER)(
        _t(s["theta"]), _t(s["xi"]), _t(eps), mask_t, torch.tensor(beta))
    _check(out_t, [np.asarray(o) for o in out_j], TOL)


def test_make_trajectory_gives_b6_for_the_full_metric(scene):
    """make_trajectory gives B6's wrapper (on CPU tensors, its plain
    version) and the plain version itself; the kernel's domain refuses
    crowded fields and names B6."""
    s = scene
    cfg = trhmc.RHMCConfig(n_leapfrog=2, fixed_point_iters=2)
    out = [trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], K, cfg, fused)(
        _t(s["theta"]), _t(s["xi"]), 0.01, torch.ones(K)) for fused in (True, False)]
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for spec, k in ((s["tspec"]._replace(height=128, width=128), 16), (s["tspec"], 17)):
        with pytest.raises(ValueError, match="B6"):
            fr.check_domain(spec, k)


def test_kernel_domain_and_shared_memory(scene):
    from starcat_torch import build

    # mirrors smem_floats in csrc/fused_rhmc.cu: the pair contractions and
    # G^-1's padded 3x3 star blocks (30 K^2), the six profile sets at the odd
    # star stride 33, G / L (D + 1 rows), L^-1 and G^-1 at the odd row stride
    # 49 for D = 48
    assert fr.smem_bytes(16, 32, 32) == 4 * (30 * 256 + 58 * 16 + 3 * 1024 + 3 * 16 * 66 + 8
                                             + 145 * 49)
    assert fr.smem_bytes(16, 48, 48) <= build.MAX_SMEM_BYTES
    spec48 = scene["tspec"]._replace(height=48, width=48)
    fr.check_domain(spec48, 16)
    with pytest.raises(ValueError, match="B6"):
        fr.check_domain(spec48, 0)


@pytest.mark.parametrize("solver_tol", [0.05, 0.0])
def test_rhmc_transition_matches_jax_pallas_kernel(scene, solver_tol):
    """The port's transition on the plain B6 trajectory against the JAX
    head's batched Pallas kernel (interpret mode) on that kernel's own
    draws (rhmc.py:304-321); solver_tol 0 forces every solver failure."""
    s = scene
    img = jnp.asarray(s["img"])
    beta = 0.7
    cfg_j = JRHMCConfig(step_size=0.02, n_leapfrog=3, fixed_point_iters=4,
                        solver_tol=solver_tol)
    tpg = j_tempered(s["spec"], img, s["prior"])
    mask = jnp.asarray(s["mask_c"])
    u0 = jax.vmap(lambda t, m: tpg(t, m, beta)[0])(s["theta"], mask)
    keys = jax.random.split(jax.random.key(8), C)
    kern = make_pallas_rhmc_kernel(s["spec"], img, s["prior"], mask, cfg_j, beta=beta,
                                   interpret=True, n_chains=C)
    eps = 0.02
    new_j, info_j = kern(JChainState(jnp.asarray(s["theta"]), u0, jnp.zeros((C, K, 3)), keys),
                         jnp.asarray(eps), None)
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)  # key, k_mom, k_acc, k_jit
    xi = jax.vmap(lambda k: jax.random.normal(k, (K, 3)))(sub[:, 1])
    u_acc = jax.vmap(jax.random.uniform)(sub[:, 2])
    u_jit = jax.vmap(jax.random.uniform)(sub[:, 3])

    cfg = rhmc_config_from_jax(cfg_j)
    assert cfg.metric == "full"
    traj = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], K, cfg, fused=False)
    st_t = chain_state_from_numpy(s["theta"], np.asarray(u0), np.zeros((C, K, 3)), "cpu")
    new_t, info_t = trhmc.rhmc_transition(
        st_t, _t(xi), _t(u_jit), _t(u_acc), traj, torch.tensor(eps), _t(s["mask_c"]),
        beta, cfg.divergence_threshold, cfg.solver_tol)
    np.testing.assert_array_equal(info_t.solver_fail.numpy(), np.asarray(info_j.solver_fail))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_array_equal(info_t.diverged.numpy(), np.asarray(info_j.diverged))
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               atol=5e-3)
    np.testing.assert_allclose(new_t.theta.numpy(), np.asarray(new_j.theta), atol=TOL["theta"])
    np.testing.assert_allclose(new_t.u.numpy(), np.asarray(new_j.u), atol=TOL["h"])
    if solver_tol == 0.0:
        assert bool(info_t.solver_fail.all()) and not bool(info_t.accepted.any())
    else:
        assert bool(info_t.accepted.any())


def _jax_sweep_draws(keys, prior):
    """transdim_sweep's draws from its per-chain keys (transdim.py:539,
    :103, :420), as the port's SweepDraws."""
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    bd = jax.vmap(lambda k: jax.random.split(k, 4))(sub[:, 1])
    sm = jax.vmap(lambda k: jax.random.split(k, 6))(sub[:, 2])
    return SweepDraws(
        _t(jax.vmap(jax.random.uniform)(sub[:, 0])),
        (_t(jax.vmap(jax.random.uniform)(bd[:, 0])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(bd[:, 1])),
         _t(jax.vmap(lambda k: j_sample_prior(k, 1, prior)[0])(bd[:, 2])),
         _t(jax.vmap(jax.random.uniform)(bd[:, 3]))),
        (_t(jax.vmap(jax.random.uniform)(sm[:, 0])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sm[:, 1])),
         _t(jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sm[:, 2])),
         _t(jax.vmap(jax.random.uniform)(sm[:, 3])),
         _t(jax.vmap(lambda k: jax.random.normal(k, (2,)))(sm[:, 4])),
         _t(jax.vmap(jax.random.uniform)(sm[:, 5]))))


def test_transdim_rhmc_transition_matches_jax(scene):
    """One trans-d transition with the full-metric rhmc move (two sweeps,
    then B6's trajectory at each chain's mask, beta 0.7) against the JAX
    head's rhmc_pallas transition (interpret mode) on its keys' own draws
    (transdim_mcmc.py:167-264)."""
    s = scene
    beta = 0.7
    cfg_j = jtdm.TransDimMCMCConfig(
        mutation="rhmc_pallas", n_leapfrog=3, fixed_point_iters=4, n_transdim_sweeps=2,
        transdim=JTransDimConfig(lam_count=3.0, split_sigma=1.0))
    img = jnp.asarray(s["img"])
    ll0 = beta * jax.vmap(lambda t, m: starcat.log_likelihood(t, m, s["spec"], img))(
        s["theta"], s["mask_c"])
    keys = jax.random.split(jax.random.key(9), C)
    kern_j = jtdm.make_transdim_kernel(s["spec"], img, s["prior"], cfg_j, interpret=True,
                                       beta=beta)
    eps = 0.02
    new_j, info_j = kern_j(jtdm.TDState(jnp.asarray(s["theta"]), jnp.asarray(s["mask_c"]),
                                        ll0, keys), jnp.asarray(eps))
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)  # key, k_td, k_wm
    sweeps = tuple(_jax_sweep_draws(jax.vmap(lambda k: jax.random.fold_in(k, i))(sub[:, 1]),
                                    s["prior"]) for i in range(2))
    wm = jax.vmap(lambda k: jax.random.split(k, 4))(sub[:, 2])  # key, k_mom, k_acc, k_jit
    move = (_t(jax.vmap(lambda k: jax.random.normal(k, (K, 3)))(wm[:, 1])),
            _t(jax.vmap(jax.random.uniform)(wm[:, 3])),
            _t(jax.vmap(jax.random.uniform)(wm[:, 2])))

    cfg = transdim_mcmc_config_from_jax(cfg_j)
    assert cfg.mutation == "rhmc"
    kern_t = make_transdim_kernel(s["tspec"], _t(s["img"]), s["tprior"], K, cfg,
                                  torch.Generator(), beta=beta)
    st = td_state_from_numpy(s["theta"], s["mask_c"], np.asarray(ll0), "cpu")
    new_t, info_t = kern_t(st, torch.tensor(eps), TDDraws(sweeps, move))
    np.testing.assert_array_equal(new_t.mask.numpy(), np.asarray(new_j.mask))
    np.testing.assert_allclose(info_t.td_accept.numpy(), np.asarray(info_j.td_accept))
    np.testing.assert_array_equal(info_t.solver_fail.numpy(), np.asarray(info_j.solver_fail))
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               atol=5e-3)
    np.testing.assert_allclose(new_t.theta.numpy(), np.asarray(new_j.theta), atol=TOL["theta"])
    # the tempered log-likelihood cache, refreshed from U after the move
    np.testing.assert_allclose(new_t.loglik.numpy(), np.asarray(new_j.loglik),
                               rtol=1e-5, atol=TOL["h"])
    assert float(info_t.accept_prob.mean()) > 0.3
