"""The trans-dimensional moves and head of starcat_torch against the JAX
package: birth/death (prior and residual births), split/merge and the
sweep fed the JAX keys' own draws; prior recovery of the sweeps and of the
whole head at beta = 0 under a flat likelihood; short runs of the cfg5 and
diagonal cfg1 presets through api.sample on the plain path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import starcat
from starcat import transdim as jtd
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.potential import sample_prior as j_sample_prior
from starcat_torch import api
from starcat_torch import transdim as ttd
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.convert import (
    prior_from_jax,
    spec_from_jax,
    td_state_from_numpy,
    transdim_config_from_jax,
    transdim_mcmc_config_from_jax,
)
from starcat_torch.potential import PriorSpec, constrain, log_likelihood, sample_prior
from starcat_torch.scene import SceneSpec, render_scene
from starcat_torch.transdim_mcmc import (
    TransDimMCMCConfig,
    init_td_states,
    make_transdim_kernel,
)

torch.set_num_threads(1)

K, C = 6, 32
# log alpha holds a difference of two float32 log-likelihood sums over the
# image, each rounded in its own package's order: rtol 1e-4 with atol 2e-2,
# as tests/test_torch_samplers.py holds the relocate move
TOL_ALPHA = dict(rtol=1e-4, atol=2e-2)


@pytest.fixture(scope="module")
def scene():
    spec = starcat.SceneSpec(16, 16, 1.5, 5.0)
    prior = starcat.PriorSpec(3.0, 0.8)
    truth = starcat.sample_prior(jax.random.key(0), 3, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(1), x, y, f, spec), np.float32)
    rng = np.random.default_rng(3)
    theta = np.array(jax.vmap(lambda k: starcat.sample_prior(k, K, prior))(
        jax.random.split(jax.random.key(2), C)), np.float32)
    theta[:, :3] = np.asarray(truth) + 0.05 * rng.standard_normal((C, 3, 3)).astype(np.float32)
    # alive counts 0..K over the chains, slots shuffled
    n = np.arange(C) % (K + 1)
    order = np.argsort(rng.random((C, K)), axis=1)
    mask = (order < n[:, None]).astype(np.float32)
    return dict(spec=spec, prior=prior, img=img, theta=theta, mask=mask,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


def _ll_fns(s, flat):
    img_j, img_t = jnp.asarray(s["img"]), _tn(s["img"])
    if flat:
        return (lambda t, m: jnp.asarray(0.0, jnp.float32),
                lambda t, m: torch.zeros(t.shape[0]))
    return (lambda t, m: starcat.log_likelihood(t, m, s["spec"], img_j),
            lambda t, m: log_likelihood(t, m, s["tspec"], img_t))


def _tn(a):
    return torch.from_numpy(np.array(a))


def _jax_draws_bd(keys, prior, residual, hw):
    if residual:  # transdim.py:170
        sub = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
        return (jax.vmap(jax.random.uniform)(sub[:, 0]),
                jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sub[:, 1]),
                jax.vmap(lambda k: jax.random.gumbel(k, (hw,)))(sub[:, 2]),
                jax.vmap(lambda k: jax.random.uniform(k, (2,)))(sub[:, 3]),
                jax.vmap(jax.random.normal)(sub[:, 4]),
                jax.vmap(jax.random.uniform)(sub[:, 5]))
    sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)  # transdim.py:103
    return (jax.vmap(jax.random.uniform)(sub[:, 0]),
            jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sub[:, 1]),
            jax.vmap(lambda k: j_sample_prior(k, 1, prior)[0])(sub[:, 2]),
            jax.vmap(jax.random.uniform)(sub[:, 3]))


def _jax_draws_sm(keys):
    sub = jax.vmap(lambda k: jax.random.split(k, 6))(keys)  # transdim.py:420
    return (jax.vmap(jax.random.uniform)(sub[:, 0]),
            jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sub[:, 1]),
            jax.vmap(lambda k: jax.random.gumbel(k, (K,)))(sub[:, 2]),
            jax.vmap(jax.random.uniform)(sub[:, 3]),
            jax.vmap(lambda k: jax.random.normal(k, (2,)))(sub[:, 4]),
            jax.vmap(jax.random.uniform)(sub[:, 5]))


def _assert_same_move(out_t, out_j, s):
    th_t, m_t, ll_t, info_t = out_t
    th_j, m_j, ll_j, info_j = out_j
    np.testing.assert_allclose(info_t.log_alpha.numpy(), np.asarray(info_j.log_alpha),
                               **TOL_ALPHA)
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_array_equal(info_t.move_type.numpy(), np.asarray(info_j.move_type))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5, atol=1e-3)


def _start(s, ll_t):
    th, m = _tn(s["theta"]), _tn(s["mask"])
    return th, m, ll_t(th, m)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_birth_death_matches_jax(scene, residual, flat):
    s = scene
    ll_j, ll_t = _ll_fns(s, flat)
    cfg = jtd.TransDimConfig(lam_count=3.0)
    keys = jax.random.split(jax.random.key(11 + residual), C)
    th, m, ll = _start(s, ll_t)
    img = jnp.asarray(s["img"])
    if residual:
        out_j = jax.vmap(lambda k, t, mm, l: jtd.birth_death_step_residual(
            k, t, mm, l, ll_j, s["prior"], s["spec"], img, cfg))(
            keys, s["theta"], s["mask"], jnp.asarray(ll.numpy()))
    else:
        out_j = jax.vmap(lambda k, t, mm, l: jtd.birth_death_step(
            k, t, mm, l, ll_j, s["prior"], cfg))(
            keys, s["theta"], s["mask"], jnp.asarray(ll.numpy()))
    draws = [_tn(d) for d in _jax_draws_bd(keys, s["prior"], residual, 256)]
    tcfg = transdim_config_from_jax(cfg)
    if residual:
        out_t = ttd.birth_death_step_residual(th, m, ll, ll_t, s["tprior"], s["tspec"],
                                              _tn(s["img"]), tcfg, *draws)
    else:
        out_t = ttd.birth_death_step(th, m, ll, ll_t, s["tprior"], tcfg, *draws)
    _assert_same_move(out_t, out_j, s)
    assert 0 < int(out_t[3].accepted.sum())


@pytest.mark.parametrize("flat", [False, True])
def test_split_merge_matches_jax(scene, flat):
    s = scene
    ll_j, ll_t = _ll_fns(s, flat)
    cfg = jtd.TransDimConfig(lam_count=3.0, split_sigma=1.0)
    keys = jax.random.split(jax.random.key(21), C)
    th, m, ll = _start(s, ll_t)
    out_j = jax.vmap(lambda k, t, mm, l: jtd.split_merge_step(
        k, t, mm, l, ll_j, s["prior"], s["spec"], cfg))(
        keys, s["theta"], s["mask"], jnp.asarray(ll.numpy()))
    draws = [_tn(d) for d in _jax_draws_sm(keys)]
    out_t = ttd.split_merge_step(th, m, ll, ll_t, s["tprior"], s["tspec"],
                                 transdim_config_from_jax(cfg), *draws)
    _assert_same_move(out_t, out_j, s)
    if flat:
        assert 0 < int(out_t[3].accepted.sum())


@pytest.mark.parametrize("proposal", ["prior", "residual"])
def test_transdim_sweep_matches_jax(scene, proposal):
    s = scene
    ll_j, ll_t = _ll_fns(s, True)
    cfg = jtd.TransDimConfig(lam_count=3.0, birth_proposal=proposal)
    keys = jax.random.split(jax.random.key(31), C)
    th, m, ll = _start(s, ll_t)
    img = jnp.asarray(s["img"])
    out_j = jax.vmap(lambda k, t, mm, l: jtd.transdim_sweep(
        k, t, mm, l, ll_j, s["prior"], s["spec"], cfg, image=img))(
        keys, s["theta"], s["mask"], jnp.asarray(ll.numpy()))
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)  # transdim.py:539
    draws = ttd.SweepDraws(
        _tn(jax.vmap(jax.random.uniform)(sub[:, 0])),
        tuple(_tn(d) for d in _jax_draws_bd(sub[:, 1], s["prior"], proposal == "residual", 256)),
        tuple(_tn(d) for d in _jax_draws_sm(sub[:, 2])))
    out_t = ttd.transdim_sweep(th, m, ll, ll_t, s["tprior"], s["tspec"],
                               transdim_config_from_jax(cfg), draws, _tn(s["img"]))
    _assert_same_move(out_t, out_j, s)
    types = set(out_t[3].move_type.tolist())
    assert types & {0, 1} and types & {2, 3}


def _truncated_poisson_pmf(lam, kmax):
    ks = np.arange(kmax + 1)
    pmf = stats.poisson.pmf(ks, lam)
    return pmf / pmf.sum()


SPEC_T = SceneSpec(16, 16, 1.5, 5.0)
PRIOR_T = PriorSpec(logf_mean=3.0, logf_sigma=0.8)


def test_sweeps_recover_the_prior_with_a_flat_likelihood():
    """A port of tests/test_transdim.py:73-90: with no data, birth/death +
    split/merge sweeps keep n ~ truncated Poisson(Lambda) and the alive
    fluxes ~ the prior."""
    kmax, n_chains, n_steps, lam = 8, 256, 600, 2.5
    cfg = ttd.TransDimConfig(lam_count=lam, split_sigma=1.0)
    gen = torch.Generator().manual_seed(1)
    theta = sample_prior(gen, n_chains * kmax, PRIOR_T, "cpu").reshape(n_chains, kmax, 3)
    mask = torch.zeros((n_chains, kmax))
    mask[:, 0] = 1.0
    ll = torch.zeros(n_chains)
    flat = lambda t, m: torch.zeros(t.shape[0])  # noqa: E731
    ns = []
    for _ in range(n_steps):
        draws = ttd.draw_sweep(gen, n_chains, kmax, SPEC_T, PRIOR_T, cfg, "cpu")
        theta, mask, ll, _ = ttd.transdim_sweep(theta, mask, ll, flat, PRIOR_T, SPEC_T,
                                                cfg, draws)
        ns.append(mask.sum(-1))
    counts = torch.stack(ns)[300:].reshape(-1).long().numpy()
    pmf = _truncated_poisson_pmf(lam, kmax)
    emp = np.bincount(counts, minlength=kmax + 1)[: kmax + 1] / counts.size
    assert np.abs(emp - pmf).max() < 0.03, (emp, pmf)
    s = theta[..., 2][mask > 0].numpy()
    assert s.size > 100
    ks = stats.kstest(s, "norm", args=(PRIOR_T.logf_mean, PRIOR_T.logf_sigma))
    assert ks.pvalue > 1e-4, ks


@pytest.mark.parametrize("mutation,n_steps", [("hmc", 400), ("rhmc_diag", 150)])
def test_whole_head_recovers_the_prior_at_beta_zero(mutation, n_steps):
    """beta = 0: the trans-d sweeps with the within-model move (tempered
    potential and, for rhmc_diag, the tempered metric) leave the prior
    invariant (a port of tests/test_transdim_mcmc.py:36-70)."""
    kmax, n_chains, lam = 6, 96, 2.0
    img = torch.full((16, 16), SPEC_T.background)
    cfg = TransDimMCMCConfig(step_size=0.4, mutation=mutation, n_leapfrog=5 if mutation == "hmc" else 2,
                             fixed_point_iters=2, n_transdim_sweeps=2,
                             transdim=ttd.TransDimConfig(lam_count=lam, split_sigma=1.0))
    gen = torch.Generator().manual_seed(0)
    kernel = make_transdim_kernel(SPEC_T, img, PRIOR_T, kmax, cfg, gen, beta=0.0)
    st = init_td_states(gen, SPEC_T, img, PRIOR_T, kmax, n_chains, lam, beta=0.0)
    ns, acc = [], []
    for _ in range(n_steps):
        st, info = kernel(st, torch.tensor(0.4))
        ns.append(st.mask.sum(-1))
        acc.append(info.accept_prob)
    burn = n_steps // 2
    assert float(torch.stack(acc)[burn:].mean()) > 0.5
    counts = torch.stack(ns)[burn:].reshape(-1).long().numpy()
    pmf = _truncated_poisson_pmf(lam, kmax)
    emp = np.bincount(counts, minlength=kmax + 1)[: kmax + 1] / counts.size
    assert np.abs(emp - pmf).max() < 0.04, (emp, pmf)
    s = st.theta[..., 2][st.mask > 0].numpy()
    ks = stats.kstest(s, "norm", args=(PRIOR_T.logf_mean, PRIOR_T.logf_sigma))
    assert ks.pvalue > 1e-4, ks
    assert torch.isfinite(st.loglik).all() and bool((st.loglik == 0).all())


def test_init_td_states_draws_a_truncated_poisson():
    gen = torch.Generator().manual_seed(4)
    img = torch.full((16, 16), SPEC_T.background)
    st = init_td_states(gen, SPEC_T, img, PRIOR_T, 8, 4000, 2.5)
    n = st.mask.sum(-1).long().numpy()
    emp = np.bincount(n, minlength=9)[:9] / n.size
    assert np.abs(emp - _truncated_poisson_pmf(2.5, 8)).max() < 0.03
    # the first n slots alive
    assert bool((st.mask[:, :-1] >= st.mask[:, 1:]).all())
    torch.testing.assert_close(st.loglik, log_likelihood(st.theta, st.mask, SPEC_T, img))


def test_converters_carry_the_jax_configs():
    jcfg = JAX_CONFIGS["cfg5_transdim_mcmc"].tdm
    tcfg = transdim_mcmc_config_from_jax(jcfg._replace(mutation="rhmc_diag_pallas"))
    assert tcfg == CONFIGS["cfg5_transdim_mcmc"].tdm
    st = td_state_from_numpy(np.zeros((2, 3, 3)), np.ones((2, 3)), np.zeros(2), "cpu")
    assert st.theta.dtype == torch.float32 and st.mask.shape == (2, 3)


def test_tempered_hmc_refuses_the_cuda_kernel():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="tempered"):
        make_transdim_kernel(SPEC_T, torch.zeros((16, 16)), PRIOR_T, 4,
                             TransDimMCMCConfig(mutation="hmc"), gen, beta=0.5, fused=True)


@pytest.mark.parametrize("name,over", [
    ("cfg5_transdim_mcmc", {"n_chains": 4, "n_warmup": 4, "n_samples": 3}),
    ("cfg1_rhmc", {"n_chains": 4, "n_warmup": 4, "n_samples": 3, "rhmc.metric": "diag",
                   "rhmc.n_leapfrog": 4}),
])
def test_short_preset_runs_on_the_plain_path(name, over):
    cfg = apply_overrides(CONFIGS[name], over)
    out = api.sample(cfg, "cpu", seed=0)
    c, n, k = cfg.n_chains, cfg.n_samples, cfg.kmax
    assert out.thetas.shape == (c, n, k, 3) and np.isfinite(out.thetas).all()
    assert out.stats["kernel"] == f"{cfg.tdm.mutation if name.startswith('cfg5') else 'rhmc_diag'}_torch"
    assert out.stats["kernel_launches"] == 0
    assert out.stats["solver_rejections"] >= 0 and 0.0 <= out.stats["accept"] <= 1.0
    summ = api.summarize_output(out)
    assert np.isfinite(summ["total_flux"]["mean"])
    if name.startswith("cfg5"):
        assert out.masks.shape == (c, n, k) and out.masks.dtype == bool
        sc = summ["star_count"]
        assert 0 <= sc["mode"] <= k and abs(sum(sc["pmf"].values()) - 1.0) < 1e-3
        assert 0.0 <= out.stats["td_accept"] <= 1.0
    else:
        assert out.masks.shape == (k,) and "star_count" not in summ


@pytest.mark.parametrize("head,over,match", [
    ("rhmc", {}, r"\(B6\).*\(B6c\)"),
    ("transdim", {"tdm.mutation": "rhmc"}, r"\(B6\).*\(B6c\)"),
    ("transdim", {"tdm.mutation": "nuts"}, "unknown mutation"),
])
def test_unported_metric_or_mutation_raises(head, over, match):
    """The full metric and the trans-d rhmc mutation run on kernel B6 or,
    beyond its domain, B6c now: asked for a kernel beyond both domains (K =
    0: B6c takes every K >= 1), they raise naming both; an unknown mutation
    still raises before any kernel is chosen."""
    cfg = apply_overrides(dataclasses.replace(CONFIGS["cfg1_rhmc"], head=head, n_chains=2,
                                              n_samples=2, n_warmup=2, kmax=0,
                                              kernel="cuda"), over)
    with pytest.raises(ValueError, match=match):
        api.sample(cfg, "cpu")


# -- poisson_sweep: the sweep at the tempered Poisson likelihood --------------

SPEC_P = SceneSpec(16, 16, 1.5, 10.0)
PRIOR_P = PriorSpec(logf_mean=5.0, logf_sigma=0.7)


def _poisson_inputs(proposal, shared_mask, beta, c=32, k=6, seed=5):
    """A drawn 16x16 scene, chains near its truth with 0..K live slots (one
    mask pattern for every chain, or one a chain), the tempered
    log-likelihood and a sweep's draws."""
    gen = torch.Generator().manual_seed(seed)
    truth = sample_prior(gen, 3, PRIOR_P, "cpu")
    x, y, f = constrain(truth, SPEC_P)
    img = torch.poisson(render_scene(x, y, f, torch.ones(3), SPEC_P), generator=gen)
    theta = sample_prior(gen, c * k, PRIOR_P, "cpu").reshape(c, k, 3)
    theta[:, :3] = truth + 0.05 * torch.randn((c, 3, 3), generator=gen)
    order = torch.argsort(torch.rand((c, k), generator=gen), dim=1)
    mask = (order < (torch.arange(c) % (k + 1))[:, None]).to(torch.float32)
    if shared_mask:
        mask = mask[3:4].expand(c, k).contiguous()
    cfg = ttd.TransDimConfig(lam_count=3.0, birth_proposal=proposal)
    tll = beta * log_likelihood(theta, mask, SPEC_P, img)
    draws = ttd.draw_sweep(gen, c, k, SPEC_P, PRIOR_P, cfg, "cpu")
    return theta, mask, tll, img, cfg, draws


def _assert_same_bits(a, b):
    for x, y in zip(a[:3] + tuple(a[3]), b[:3] + tuple(b[3])):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("beta", ["zero", "tensor", "one", "untempered"])
@pytest.mark.parametrize("shared_mask", [True, False])
@pytest.mark.parametrize("proposal", ["prior", "residual"])
def test_poisson_sweep_is_transdim_sweep_at_the_tempered_likelihood(proposal, shared_mask,
                                                                    beta):
    """On the CPU poisson_sweep is its plain version, which is
    transdim_sweep with loglik_fn = beta * log_likelihood, bit for bit, at
    either birth proposal, one mask for every chain or one a chain, and
    beta 0 (a flat likelihood), a 0-d tensor or 1; at beta 1 it equals the
    untempered log_likelihood too (x * 1.0 is x)."""
    b = {"zero": 0.0, "tensor": torch.tensor(0.37), "one": 1.0, "untempered": 1.0}[beta]
    theta, mask, tll, img, cfg, draws = _poisson_inputs(proposal, shared_mask, b)
    if beta == "untempered":
        llf = lambda t, m: log_likelihood(t, m, SPEC_P, img)  # noqa: E731
    else:
        llf = lambda t, m: b * log_likelihood(t, m, SPEC_P, img)  # noqa: E731
    want = ttd.transdim_sweep(theta, mask, tll, llf, PRIOR_P, SPEC_P, cfg, draws, img)
    got = ttd.poisson_sweep(theta, mask, tll, b, PRIOR_P, SPEC_P, img, cfg, draws)
    _assert_same_bits(got, want)
    _assert_same_bits(ttd.poisson_sweep_reference(theta, mask, tll, b, PRIOR_P, SPEC_P, img,
                                                  cfg, draws), want)
    assert got[3].move_type.dtype == torch.int64 and got[3].accepted.dtype == torch.bool
    types = set(got[3].move_type.tolist())
    assert types & {0, 1} and types & {2, 3}
    if beta == "zero":
        assert 0 < int(got[3].accepted.sum())


def _bad_inputs(case):
    """poisson_sweep's inputs with one thing the kernel does not take."""
    theta, mask, tll, img, cfg, draws = _poisson_inputs("residual", False, 1.0)
    beta = 1.0
    if case == "theta_dtype":
        theta = theta.double()
    elif case == "mask_shape":
        mask = mask[:, :-1].contiguous()
    elif case == "mask_flat":
        mask = mask[0].contiguous()
    elif case == "tll_noncontiguous":
        tll = torch.stack([tll, tll], 1)[:, 0]
    elif case == "image_device":
        img = img.to("meta")
    elif case == "g_pix_shape":
        draws = draws._replace(bd=draws.bd[:2] + (draws.bd[2][:, :-1],) + draws.bd[3:])
    elif case == "z_delta_dtype":
        draws = draws._replace(sm=draws.sm[:4] + (draws.sm[4].double(),) + draws.sm[5:])
    elif case == "prior_draws":
        cfg = cfg._replace(birth_proposal="prior")
    elif case == "beta_device":
        beta = torch.tensor(1.0, device="meta")
    elif case == "beta_dtype":
        beta = torch.tensor(1.0, dtype=torch.float64)
    return theta, mask, tll, beta, PRIOR_P, SPEC_P, img, cfg, draws


@pytest.mark.parametrize("case,match", [
    ("theta_dtype", "theta must be float32"),
    ("mask_shape", r"mask must have shape \(32, 6\)"),
    ("mask_flat", r"mask must have shape \(32, 6\)"),
    ("tll_noncontiguous", "tll must be contiguous"),
    ("image_device", "image is on meta"),
    ("g_pix_shape", r"bd.g_pix must have shape \(32, 256\)"),
    ("z_delta_dtype", "sm.z_delta must be float32"),
    ("prior_draws", "do not match birth_proposal='prior'"),
    ("beta_device", "beta must be one float32"),
    ("beta_dtype", "beta must be one float32"),
    ("cpu", "needs CUDA tensors"),
])
def test_fused_sweep_wrapper_rejects_what_the_kernel_does_not_take(case, match):
    from starcat_torch import fused_transdim_sweep as fts

    before = fts.LAUNCHES
    with pytest.raises(ValueError, match=match):
        fts.fused_poisson_sweep(*_bad_inputs(case))
    assert fts.LAUNCHES == before


def test_fused_sweep_scalars_and_workspace_match_the_source():
    """The wrapper's float constants are as many as the source reads, in
    its order's count; a residual-birth sweep takes C H W floats of
    workspace and a prior-birth one none."""
    import re

    from starcat_torch import build
    from starcat_torch import fused_transdim_sweep as fts

    src = (build.CSRC / "fused_transdim_sweep.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kScalars"] == fts.N_SCALARS == len(fts.scalars(SPEC_P, PRIOR_P,
                                                                  ttd.TransDimConfig()))
    assert fts.workspace_floats(4096, 128, 128, "residual") == 4096 * 128 * 128
    assert fts.workspace_floats(4096, 32, 32, "prior") == 0


def _smc_step_inputs(proposal, mutation="rhmc_diag"):
    from starcat_torch import smc

    gen = torch.Generator().manual_seed(2)
    _, _, _, img, _, _ = _poisson_inputs(proposal, False, 1.0)
    cfg = smc.SMCConfig(n_particles=16, mutation=mutation, n_mutation_steps=1, n_leapfrog=2,
                        fixed_point_iters=2, n_transdim_sweeps=3, mutation_chunk=16,
                        transdim=ttd.TransDimConfig(lam_count=3.0, birth_proposal=proposal))
    state = smc.init_smc(gen, SPEC_P, img, PRIOR_P, 6, cfg)
    draws = smc.draw_step(gen, 16, 6, SPEC_P, PRIOR_P, cfg, "cpu")
    return smc, img, cfg, state, draws


class _SweepSpy:
    """transdim.poisson_sweep, recording the beta and the kernel choice
    (``fused``) of each call."""

    def __init__(self):
        self.betas, self.fused = [], []

    def __call__(self, theta, mask, tll, beta, prior, spec, image, cfg, draws, fused=True):
        self.betas.append(beta)
        self.fused.append(fused)
        return ttd.poisson_sweep(theta, mask, tll, beta, prior, spec, image, cfg, draws, fused)


@pytest.mark.parametrize("proposal", ["prior", "residual"])
def test_smc_step_routes_its_sweeps_through_poisson_sweep(monkeypatch, proposal):
    smc, img, cfg, state, draws = _smc_step_inputs(proposal)
    step = smc.make_smc_step(SPEC_P, img, PRIOR_P, 6, cfg)
    want = step(state, draws)
    spy = _SweepSpy()
    monkeypatch.setattr(smc, "poisson_sweep", spy)
    got = step(state, draws)
    assert len(spy.betas) == cfg.n_transdim_sweeps and spy.fused == [False] * len(spy.betas)
    assert all(b is got.beta or torch.equal(b, got.beta) for b in spy.betas)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_transdim_mcmc_routes_its_sweeps_through_poisson_sweep(monkeypatch):
    import starcat_torch.transdim_mcmc as tdm

    _, _, _, img, _, _ = _poisson_inputs("prior", False, 1.0)
    cfg = TransDimMCMCConfig(mutation="rhmc_diag", n_leapfrog=2, fixed_point_iters=2,
                             n_transdim_sweeps=2, transdim=ttd.TransDimConfig(lam_count=3.0))
    spy = _SweepSpy()
    monkeypatch.setattr(tdm, "poisson_sweep", spy)
    for beta in (1.0, 0.4):
        gen = torch.Generator().manual_seed(3)
        kernel = make_transdim_kernel(SPEC_P, img, PRIOR_P, 6, cfg, gen, beta=beta)
        st = init_td_states(gen, SPEC_P, img, PRIOR_P, 6, 8, 3.0, beta=beta)
        st, info = kernel(st, torch.tensor(0.05))
        assert torch.isfinite(st.loglik).all() and bool((info.td_accept >= 0).all())
    assert spy.betas == [1.0, 1.0, 0.4, 0.4] and spy.fused == [False] * 4


@pytest.mark.parametrize("fused", [False, True])
def test_kernel_moves_count_only_the_sweeps_on_the_kernel(monkeypatch, fused):
    """The step hands its kernel choice to poisson_sweep, which counts in
    transdim.kernel_moves the chains of each sweep that ran on the kernel:
    none on CPU tensors, where it runs the plain version either way (the
    card's count: tests/test_torch_cuda.py)."""
    from starcat_torch import metrics

    # the hmc mutation has no kernel, so fused sets only the sweeps' path
    smc, img, cfg, state, draws = _smc_step_inputs("residual", "hmc")
    spy = _SweepSpy()
    monkeypatch.setattr(smc, "poisson_sweep", spy)
    step = smc.make_smc_step(SPEC_P, img, PRIOR_P, 6, cfg, fused=fused)
    metrics.reset_record()
    with metrics.tracing():
        step(state, draws)
    counters = metrics.record()["counters"]
    metrics.reset_record()
    assert spy.fused == [fused] * cfg.n_transdim_sweeps
    assert counters["transdim.moves"] == cfg.n_particles * cfg.n_transdim_sweeps
    assert counters["transdim.kernel_moves"] == 0


@pytest.mark.parametrize("head,over", [
    ("smc", {"smc.n_particles": "16", "smc.mutation": "hmc", "smc.n_leapfrog": "2",
             "smc.ess_target_frac": "1e-6", "smc.n_final_rounds": "1"}),
    ("transdim", {"n_chains": "4", "n_samples": "4", "n_warmup": "4", "tdm.n_leapfrog": "2"}),
])
def test_trans_d_heads_report_their_sweep_path(head, over):
    """api.sample's smc and transdim heads name their sweeps' path and count
    the sweep kernel's launches: the plain version and none on the CPU."""
    cfg = apply_overrides(CONFIGS["cfg0_single_star"], dict(over, head=head))
    st = api.sample(cfg, "cpu", seed=0).stats
    assert st["sweep_kernel"] == "torch" and st["sweep_launches"] == 0


@pytest.mark.parametrize("counters,want", [
    (None, None),
    ({"transdim.moves": 48}, None),
    ({"transdim.moves": 48, "transdim.kernel_moves": 0}, 0.0),
    ({"transdim.moves": 48, "transdim.kernel_moves": 48}, 100.0),
])
def test_sweep_kernel_share_reads_none_without_a_record(counters, want):
    """sweep_kernel_share.smc reads nothing where the program recorded
    nothing, or counted no kernel moves (a program without the counter)."""
    import types

    from benchmark import core
    from starcat_torch import metrics

    read = core.reader("sweep_kernel_share.smc")
    run = types.SimpleNamespace(head=types.SimpleNamespace(name="smc"))
    metrics.reset_record()
    if counters is not None:
        with metrics.tracing():
            for name, v in counters.items():
                metrics.count(name, v)
    try:
        assert read(run) == want
        run.head.name = "chees"
        assert read(run) is None
    finally:
        metrics.reset_record()
