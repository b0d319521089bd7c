"""The diagonal-Fisher Riemannian path of starcat_torch against the JAX
package on the same inputs: the metric, the generalised leapfrog with the
autograd dH/dtheta, the plain version of kernel B3 against the pure-JAX
tile and against Pallas B3 in interpret mode, and the batched RHMC
transition fed the JAX keys' own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_rhmc_diag as prd
from starcat.driver import ChainState as JChainState
from starcat.integrators import riemannian_leapfrog as j_riemannian_leapfrog
from starcat.metric import make_diag_metric_fn as j_diag_metric_fn
from starcat.metric import prior_information as j_prior_information
from starcat.pallas_kernels import _pack, _unpack
from starcat.potential import make_tempered_potential_and_grad as j_tempered
from starcat.rhmc import make_rhmc_diag_functions as j_rhmc_diag_functions
from starcat.rhmc import rhmc_step
from starcat_torch import rhmc as trhmc
from starcat_torch.convert import (
    chain_state_from_numpy,
    prior_from_jax,
    rhmc_config_from_jax,
    spec_from_jax,
)
from starcat_torch.fused_rhmc_diag import fused_rhmc_diag_reference, make_fused_rhmc_diag
from starcat_torch.integrators import fp_delta, riemannian_leapfrog
from starcat_torch.metric import make_diag_metric_fn, prior_information
from starcat_torch.potential import make_tempered_potential_and_grad

torch.set_num_threads(1)

K, H, W, C = 4, 12, 12, 8
JITTER = 1e-3
# tests/test_pallas_rhmc_diag.py:65 (metric), :119-126 (trajectory against
# the XLA integrator: theta 1e-4, p 1e-3, h 2e-3).  Against the Pallas
# kernel, theta and p are held tighter (1e-5, 1e-4); h and u keep 2e-3,
# since the JAX tile's own u1 is 1.5e-4 from float64 at this shape.
TOL = dict(theta=1e-5, p=1e-4, h=2e-3, resid=1e-6)


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
    """(JAX mask as passed to vmap, torch mask): shared (K,) or per chain."""
    if form == "shared":
        m = np.ones(K, np.float32)
        return np.broadcast_to(m, (C, K)).copy(), torch.from_numpy(m)
    return s["mask_c"], torch.from_numpy(s["mask_c"])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("beta", [1.0, 0.3])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_diag_metric_and_prior_information_match_jax(scene, beta, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    jm = j_diag_metric_fn(s["spec"], s["prior"], JITTER)
    g_j = jax.vmap(lambda t, m: jm(t, m, beta))(s["theta"], mask_j)      # (C, 3K)
    g_t = make_diag_metric_fn(s["tspec"], s["tprior"], JITTER)(_t(s["theta"]), mask_t, beta)
    assert g_t.shape == (C, K, 3)
    np.testing.assert_allclose(g_t.numpy().reshape(C, -1), np.asarray(g_j),
                               rtol=1e-5, atol=2e-6)
    info_j = jax.vmap(lambda t, m: j_prior_information(t, m, s["prior"]))(s["theta"], mask_j)
    info_t = prior_information(_t(s["theta"]), mask_t, s["tprior"])
    np.testing.assert_allclose(info_t.numpy(), np.asarray(info_j), rtol=1e-6, atol=1e-7)


def _jax_functions(s, beta):
    tpg = j_tempered(s["spec"], jnp.asarray(s["img"]), s["prior"])
    dm = j_diag_metric_fn(s["spec"], s["prior"], JITTER)
    return j_rhmc_diag_functions(lambda th, m: tpg(th, m, beta)[0],
                                 lambda th, m: dm(th, m, beta))


def _torch_functions(s, beta):
    tpg = make_tempered_potential_and_grad(s["tspec"], _t(s["img"]), s["tprior"])
    dm = make_diag_metric_fn(s["tspec"], s["tprior"], JITTER)
    return trhmc.make_rhmc_diag_functions(lambda th, m: tpg(th, m, beta)[0],
                                          lambda th, m: dm(th, m, beta))


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_riemannian_leapfrog_matches_jax(scene, beta):
    s = scene
    eps = np.full(C, 0.02, np.float32) * (1.0 + 0.1 * np.arange(C, dtype=np.float32))
    p0 = s["xi"] * 3.0 * np.repeat(s["mask_c"][..., None], 3, -1)
    n_steps, fpi = 3, 4
    _, dhdt, dhdp = _jax_functions(s, beta)

    def one(th, p, e, m):
        res = j_riemannian_leapfrog(lambda t_, p_: dhdt(t_, p_, m),
                                    lambda t_, p_: dhdp(t_, p_, m),
                                    th.reshape(-1), p.reshape(-1), e, n_steps, fpi)
        return res.theta.reshape(K, 3), res.p.reshape(K, 3), res.solver_resid

    th_j, p_j, r_j = jax.vmap(one)(s["theta"], p0, eps, s["mask_c"])
    _, dhdt_t, dhdp_t = _torch_functions(s, beta)
    m_t = _t(s["mask_c"])
    res = riemannian_leapfrog(lambda t_, p_: dhdt_t(t_, p_, m_t),
                              lambda t_, p_: dhdp_t(t_, p_, m_t),
                              _t(s["theta"]), _t(p0), _t(eps), n_steps, fpi)
    assert res.solver_resid.shape == (C,)
    np.testing.assert_allclose(res.theta.numpy(), np.asarray(th_j), atol=1e-4)
    np.testing.assert_allclose(res.p.numpy(), np.asarray(p_j), atol=1e-3)
    np.testing.assert_allclose(res.solver_resid.numpy(), np.asarray(r_j), atol=TOL["resid"])
    assert float(res.solver_resid.max()) > 0.0


def test_fp_delta_is_per_chain_and_keeps_nan():
    a = torch.zeros((3, 2, 3))
    b = a.clone()
    b[1, 0, 2] = 0.5
    b[2, 1, 1] = float("nan")
    d = fp_delta(b, a)
    assert d.shape == (3,)
    assert float(d[0]) == 0.0 and float(d[1]) == pytest.approx(0.5 / 1.5)
    assert bool(torch.isnan(d[2]))


def _check_trajectory(out_t, th, p, h0, h1, u1, resid, tol):
    np.testing.assert_allclose(out_t[0].numpy(), th, atol=tol["theta"])
    np.testing.assert_allclose(out_t[1].numpy(), p, atol=tol["p"])
    for got, want in zip(out_t[2:5], (h0, h1, u1)):
        np.testing.assert_allclose(got.numpy(), want, atol=tol["h"])
    np.testing.assert_allclose(out_t[5].numpy(), resid, atol=tol["resid"])


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_reference_matches_jax_tile(scene, beta, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    n_steps, fpi, eps = 3, 5, 0.02
    out_j = prd.rhmc_diag_trajectory_tile(
        _pack(jnp.asarray(s["theta"]), K), _pack(jnp.asarray(s["xi"]), K),
        jnp.full((1, C), eps), jnp.asarray(mask_j).T, jnp.asarray(s["img"]),
        s["spec"], s["prior"], K, n_steps, fpi, beta, JITTER)
    out_t = fused_rhmc_diag_reference(
        s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]), _t(s["xi"]), eps,
        mask_t, beta, n_steps, fpi, JITTER)
    _check_trajectory(out_t, np.asarray(_unpack(out_j[0], K)),
                      np.asarray(_unpack(out_j[1], K)), *(np.asarray(o) for o in out_j[2:]),
                      tol=TOL)
    # dead slots frozen bit for bit
    dead = s["mask_c"] == 0.0 if form == "per_chain" else np.zeros((C, K), bool)
    np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_reference_matches_pallas_interpret(scene, form):
    s = scene
    mask_j, mask_t = _masks(s, form)
    beta = 0.7
    eps = (0.01 * (1.0 + 0.1 * np.arange(C))).astype(np.float32)
    fused_j = prd.make_pallas_rhmc_diag_leapfrog(
        s["spec"], jnp.asarray(s["img"]), s["prior"], K, n_steps=2,
        fixed_point_iters=3, jitter=JITTER, interpret=True)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(K)
    out_j = fused_j(jnp.asarray(s["theta"]), jnp.asarray(s["xi"]), jnp.asarray(eps), jmask, beta)
    out_t = make_fused_rhmc_diag(s["tspec"], _t(s["img"]), s["tprior"], K, 2, 3, JITTER)(
        _t(s["theta"]), _t(s["xi"]), _t(eps), mask_t, beta)
    _check_trajectory(out_t, *(np.asarray(o) for o in out_j), tol=TOL)


def test_full_metric_raises_naming_b6(scene):
    """The full metric is ported on kernel B6: make_trajectory gives its
    wrapper, and B6's domain refuses crowded fields naming B6."""
    from starcat_torch import fused_rhmc as fr

    s = scene
    traj = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], K,
                                 trhmc.RHMCConfig(n_leapfrog=1, fixed_point_iters=1), fused=True)
    out = traj(_t(s["theta"]), _t(s["xi"]), 0.01, torch.ones(K))
    assert out[0].shape == (C, K, 3) and bool(torch.isfinite(out[5]).all())
    with pytest.raises(ValueError, match="B6"):
        fr.check_domain(s["tspec"]._replace(height=128, width=128), K)


@pytest.mark.parametrize("solver_tol", [0.05, 0.0])
def test_rhmc_transition_matches_jax_rhmc_step(scene, solver_tol):
    """The port's transition on the plain B3 trajectory against the JAX
    step, on the step's own draws; solver_tol 0 forces every solver
    failure (all rejected, none diverged)."""
    s = scene
    img = jnp.asarray(s["img"])
    cfg_j = starcat.rhmc.RHMCConfig(step_size=0.02, n_leapfrog=3, fixed_point_iters=4,
                                    metric="diag", solver_tol=solver_tol)
    pfn = starcat.make_potential(s["spec"], img, s["prior"])
    pg = starcat.make_potential_and_grad(s["spec"], img, s["prior"])
    dm = j_diag_metric_fn(s["spec"], s["prior"])
    ham, dhdt, dhdp = j_rhmc_diag_functions(pfn, dm)
    mask = jnp.ones(K)
    u0, g0 = jax.vmap(lambda t: pg(t, mask))(s["theta"])
    keys = jax.random.split(jax.random.key(8), C)
    states = JChainState(jnp.asarray(s["theta"]), u0, g0, keys)
    eps = 0.05
    new_j, info_j = jax.vmap(lambda st: rhmc_step(
        st, pfn, dm, ham, dhdt, dhdp, jnp.asarray(eps), cfg_j.n_leapfrog,
        cfg_j.fixed_point_iters, mask, cfg_j.divergence_threshold,
        diag_metric=True, solver_tol=solver_tol))(states)
    # rhmc.py:155-186: key, k_mom, k_acc, k_jit
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    xi = jax.vmap(lambda k: jax.random.normal(k, (3 * K,)))(sub[:, 1]).reshape(C, K, 3)
    u_acc = jax.vmap(jax.random.uniform)(sub[:, 2])
    u_jit = jax.vmap(jax.random.uniform)(sub[:, 3])

    cfg = rhmc_config_from_jax(cfg_j)
    traj = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], K, cfg, fused=False)
    st_t = chain_state_from_numpy(s["theta"], np.asarray(u0), np.asarray(g0), "cpu")
    new_t, info_t = trhmc.rhmc_transition(
        st_t, _t(xi), _t(u_jit), _t(u_acc), traj, torch.tensor(eps), torch.ones(K),
        1.0, cfg.divergence_threshold, cfg.solver_tol)
    np.testing.assert_array_equal(info_t.solver_fail.numpy(), np.asarray(info_j.solver_fail))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_array_equal(info_t.diverged.numpy(), np.asarray(info_j.diverged))
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               atol=5e-3)
    np.testing.assert_allclose(new_t.theta.numpy(), np.asarray(new_j.theta), atol=1e-4)
    np.testing.assert_allclose(new_t.u.numpy(), np.asarray(new_j.u), atol=2e-3)
    if solver_tol == 0.0:
        assert bool(info_t.solver_fail.all()) and not bool(info_t.accepted.any())
    else:
        assert bool(info_t.accepted.any())


def test_nan_chain_is_a_solver_failure(scene):
    """A chain whose trajectory overflows reports a NaN residual, fails the
    solver check and is rejected; the other chains are untouched by it."""
    s = scene
    cfg = trhmc.RHMCConfig(n_leapfrog=2, fixed_point_iters=3, metric="diag")
    traj = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], K, cfg, fused=False)
    theta = _t(s["theta"])
    theta[0, 1, 2] = 95.0  # exp(95) overflows float32: lam = inf
    mask = torch.ones(K)
    u = -(torch.zeros(C))
    states = trhmc.ChainState(theta, u, torch.zeros_like(theta))
    xi, u_jit, u_acc = _t(s["xi"]), torch.full((C,), 0.5), torch.full((C,), 0.3)
    out = traj(theta, xi, torch.full((C,), 0.02), mask)
    assert bool(torch.isnan(out[5][0])) and bool(torch.isfinite(out[5][1:]).all())
    new, info = trhmc.rhmc_transition(states, xi, u_jit, u_acc, traj, torch.tensor(0.02),
                                      mask, 1.0, 1000.0, 0.05)
    assert bool(info.solver_fail[0]) and not bool(info.accepted[0])
    assert float(info.accept_prob[0]) == 0.0
    assert torch.equal(new.theta[0], theta[0])
    ref = traj(theta[1:], xi[1:], torch.full((C - 1,), 0.02), mask)
    torch.testing.assert_close(out[0][1:], ref[0], rtol=0, atol=1e-6)


def test_kernel_domain_and_shared_memory(scene):
    from starcat_torch import build
    from starcat_torch import fused_rhmc_diag as frd

    # the tiled layout: 1/lam and a working field in the 32-row tile,
    # three y-side and three x-side sets of K rows, the 256-thread block's
    # block sum and partial sums, 61 arrays of 16 floats and 12 of scratch
    assert frd.smem_bytes(16, 32, 32) == 4 * (2 * 1024 + 48 * (32 + 33) + 16 + 768
                                              + 61 * 16 + 12)
    assert frd.smem_bytes(16, 48, 48) <= build.MAX_SMEM_BYTES
    frd.check_domain(scene["tspec"]._replace(height=48, width=48), 16)
    for spec, k in ((scene["tspec"]._replace(height=128, width=128), 16),
                    (scene["tspec"], 17), (scene["tspec"], 0)):
        with pytest.raises(ValueError, match="B4"):
            frd.check_domain(spec, k)


def test_kernel_build_raises_without_the_toolkit(monkeypatch, tmp_path):
    from starcat_torch import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    build.build_kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_kernel("fused_rhmc_diag")
    finally:
        build.build_kernel.cache_clear()
