"""starcat_torch's NUTS head against the JAX package's: the checkpoint slot
rule against the recursive tree, one transition against
``jax.vmap(starcat.nuts.nuts_step)`` on the JAX keys' own draws, exactness
on a correlated Gaussian, frozen dead slots, and the kernel's plain version
as a leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from jax_draws import jax_nuts_draws
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.driver import ChainState as JaxChainState
from starcat.nuts import _leapfrog_one, _Z, nuts_step
from starcat_torch import diagnostics
from starcat_torch.convert import chain_state_from_numpy, prior_from_jax, spec_from_jax
from starcat_torch.fused_leapfrog import fused_leapfrog_reference, make_fused_leapfrog
from starcat_torch.nuts import (
    NUTSConfig,
    checkpoint_slots,
    nuts_transition,
    plain_leaf,
    run_nuts,
)
from starcat_torch.potential import make_potential_and_grad, sample_prior

torch.set_num_threads(1)

C, DEPTH = 32, 5
# the trajectory tolerances the Pallas kernels meet against XLA
# (tests/test_pallas.py:37-40): theta 3e-4, p 5e-3, U 0.3, grad 5e-3 relative
# to 1 + |g|
TOL = dict(theta=3e-4, p=5e-3, u=0.3, grad_rel=5e-3)


# --- (a) the slot rule -------------------------------------------------------

def _recursive_check_pairs(a: int, d: int):
    """(first, last) leaf pairs whose u-turn the recursive build_tree checks
    for a subtree of depth d starting at leaf a (starcat's tests/test_nuts.py)."""
    if d == 0:
        return []
    half = 1 << (d - 1)
    pairs = _recursive_check_pairs(a, d - 1) + _recursive_check_pairs(a + half, d - 1)
    pairs.append((a, a + (1 << d) - 1))
    return pairs


@pytest.mark.parametrize("d", range(1, 9))
def test_checkpoint_slots_match_the_recursive_tree(d):
    """Every odd leaf reads, from the slots the port names, exactly the
    partners the recursive tree checks it against, nearest subtree last."""
    slots, pairs = {}, []
    for i in range(1 << d):
        store, check = checkpoint_slots(i)
        if i % 2 == 0:
            assert store == bin(i).count("1") and len(check) == 0
            slots[store] = i
            continue
        assert store is None
        t = (i ^ (i + 1)).bit_length() - 1
        partners = [slots[s] for s in check]
        assert partners == [i - (1 << k) + 1 for k in range(t, 0, -1)], (i, partners)
        pairs += [(j, i) for j in partners]
    assert sorted(pairs) == sorted(_recursive_check_pairs(0, d))


# --- (b) one transition against the JAX package on its own draws -------------

def _scene(name):
    """(spec, prior, image, theta (C, K, 3), masks (C, K)): cfg0, or a 16x16
    scene of two stars held by K = 3 slots, the third dead."""
    rng = np.random.default_rng(0)
    if name == "cfg0":
        cfg = JAX_CONFIGS["cfg0_single_star"]
        spec, prior = cfg.scene, cfg.prior
        truth, img = cfg.make_data()
        truth = np.asarray(truth)
    else:
        spec, prior = starcat.SceneSpec(16, 16, 1.5, 5.0), starcat.PriorSpec(5.0, 1.0)
        x, y, f = jnp.array([5.2, 10.7]), jnp.array([6.1, 9.4]), jnp.array([250.0, 180.0])
        img = starcat.make_mock_image(jax.random.key(7), x, y, f, spec)
        truth = np.concatenate([np.asarray(starcat.unconstrain(x, y, f, spec)),
                                [[0.3, -0.4, 4.0]]]).astype(np.float32)
    k = truth.shape[0]
    theta = (truth[None] + 0.05 * rng.standard_normal((C, k, 3))).astype(np.float32)
    masks = np.ones((C, k), np.float32)
    if k > 1:
        masks[:, -1] = 0.0
    return spec, prior, img, theta, masks


@pytest.fixture(scope="module")
def jax_nuts():
    """jit(vmap(nuts_step)) over states, per-chain eps and per-chain masks,
    one build per scene."""
    built = {}

    def get(name, spec, prior, img, inv_mass):
        if name not in built:
            pg = starcat.make_potential_and_grad(spec, img, prior)
            built[name] = (pg, jax.jit(jax.vmap(lambda s, e, m: nuts_step(
                s, lambda th: pg(th, m), e, jnp.asarray(inv_mass), m, max_depth=DEPTH))))
        return built[name]

    return get


@pytest.mark.parametrize("name,masks,leaf", [
    ("cfg0", "shared", "plain"),
    ("k3", "shared", "plain"),
    ("k3", "per_chain", "plain"),
    ("k3", "per_chain", "fused"),
])
def test_transition_matches_jax_nuts_step(jax_nuts, name, masks, leaf):
    spec, prior, img, theta, mask_np = _scene(name)
    if masks == "per_chain":   # chains 1, 5, .. lose slot 1; chains 2, 6, .. hold 1, 2
        mask_np[1::4, 1] = 0.0
        mask_np[2::4] = [0.0, 1.0, 1.0]
    k = theta.shape[1]
    eps = np.full(C, 0.02 if k > 1 else 0.01, np.float32)
    eps[::8] = 0.3      # steps too long: turns at once, or diverges
    eps[4::8] = 3.0
    inv_mass = np.ones((k, 3), np.float32)
    inv_mass[:, 2] = 0.5
    pg, step = jax_nuts(name, spec, prior, img, inv_mass)
    u, g = jax.vmap(pg)(jnp.asarray(theta), jnp.asarray(mask_np))
    keys = jax.random.split(jax.random.key(3), C)
    new_j, info_j = step(JaxChainState(jnp.asarray(theta), u, g, keys), jnp.asarray(eps),
                         jnp.asarray(mask_np))

    spec_t, prior_t = spec_from_jax(spec), prior_from_jax(prior)
    img_t = torch.from_numpy(np.array(img))
    mask_t = torch.from_numpy(mask_np if masks == "per_chain" else mask_np[0])
    if leaf == "plain":
        pg_t = make_potential_and_grad(spec_t, img_t, prior_t)
        leaf_fn = plain_leaf(lambda th: pg_t(th, mask_t))
    else:   # the kernel's wrapper at n_steps = 1, its plain version on the CPU
        leaf_fn = make_fused_leapfrog(spec_t, img_t, prior_t, k, 1)
    new_t, info_t = nuts_transition(
        chain_state_from_numpy(theta, np.asarray(u), np.asarray(g), "cpu"),
        torch.from_numpy(eps), torch.from_numpy(inv_mass), mask_t,
        jax_nuts_draws(keys, (k, 3), DEPTH), leaf_fn, DEPTH)

    for field in ("depth", "n_leaves", "diverged"):
        np.testing.assert_array_equal(getattr(info_t, field).numpy(),
                                      np.asarray(getattr(info_j, field)), err_msg=field)
    # the draws reach every outcome: early turns, full depth, divergences
    depth = info_t.depth.numpy()
    assert depth.min() <= 1 and depth.max() == DEPTH
    assert bool(info_t.diverged.any())
    # U agrees within 4e-4 here, a few float32 spacings at |U| ~ 1e3, and
    # the accept statistic exp(-max(dH, 0)) moves with dH
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               atol=1e-3)
    np.testing.assert_allclose(new_t.theta.numpy(), np.asarray(new_j.theta), atol=TOL["theta"])
    np.testing.assert_allclose(new_t.u.numpy(), np.asarray(new_j.u), atol=TOL["u"])
    g_j = np.asarray(new_j.grad)
    assert (np.abs(new_t.grad.numpy() - g_j) / (1.0 + np.abs(g_j))).max() < TOL["grad_rel"]
    moved = np.abs(new_t.theta.numpy() - theta).max(axis=(1, 2)) > 0
    assert 0 < moved.sum() < C


# --- (c) exact on a correlated Gaussian --------------------------------------

def test_nuts_exact_on_correlated_gaussian():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3))
    cov = a @ a.T + 3 * np.eye(3)
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))

    def grad_fn(theta):   # U = 0.5 th^T P th, theta (C, 1, 3)
        g = theta @ prec
        return 0.5 * torch.sum(theta * g, dim=(-2, -1)), g

    gen = torch.Generator().manual_seed(1)
    theta0 = 0.5 * torch.randn((16, 1, 3), generator=torch.Generator().manual_seed(0))
    res, _ = run_nuts(gen, grad_fn, theta0, torch.ones(1), 1500, 600,
                      NUTSConfig(step_size=0.5, max_depth=8))
    draws = res.thetas.numpy()[:, :, 0, :]
    assert res.diverged.float().mean() < 0.01
    for j in range(3):
        s = diagnostics.summarize(draws[:, :, j])
        assert abs(s["mean"]) / s["mcse"] < 4.5, (j, s)
        assert abs(s["sd"] - np.sqrt(cov[j, j])) / np.sqrt(cov[j, j]) < 0.1, (j, s)
        assert s["rhat"] < 1.02
    corr_emp = np.corrcoef(draws.reshape(-1, 3).T)
    corr_true = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    assert np.abs(corr_emp - corr_true).max() < 0.05


# --- (d) dead slots stay frozen ----------------------------------------------

def test_nuts_dead_slots_frozen():
    spec, prior = starcat.SceneSpec(16, 16, 1.5, 5.0), starcat.PriorSpec(4.0, 1.0)
    img = starcat.make_mock_image(jax.random.key(0), jnp.array([8.0]), jnp.array([8.0]),
                                  jnp.array([100.0]), spec)
    spec_t, prior_t = spec_from_jax(spec), prior_from_jax(prior)
    pg = make_potential_and_grad(spec_t, torch.from_numpy(np.array(img)), prior_t)
    mask = torch.tensor([1.0, 0.0])
    gen = torch.Generator().manual_seed(2)
    theta0 = sample_prior(torch.Generator().manual_seed(1), 2, prior_t, "cpu")[None].repeat(4, 1, 1)
    res, _ = run_nuts(gen, lambda th: pg(th, mask), theta0, mask, 40, 40,
                      NUTSConfig(step_size=0.05, max_depth=6))
    draws = res.thetas.numpy()
    np.testing.assert_array_equal(draws[:, :, 1], np.broadcast_to(
        theta0.numpy()[:, None, 1], draws[:, :, 1].shape))
    assert np.std(draws[:, :, 0, 2]) > 0


# --- (e) the kernel's plain version as a leaf --------------------------------

def test_fused_reference_at_one_step_is_the_leaf():
    """fused_leapfrog_reference at L = 1 with half the chains stepping
    backward (negative per-chain eps) is the generic leaf, bit for bit, and
    the reference's _leapfrog_one within the trajectory tolerances."""
    cfg = JAX_CONFIGS["cfg2_nuts"]
    truth, img = cfg.make_data()
    spec_t, prior_t = spec_from_jax(cfg.scene), prior_from_jax(cfg.prior)
    img_t = torch.from_numpy(np.array(img))
    rng = np.random.default_rng(4)
    c, k = 16, cfg.kmax
    theta = torch.from_numpy((np.asarray(truth)[None]
                              + 0.02 * rng.standard_normal((c, k, 3))).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((c, k, 3)).astype(np.float32))
    eps = torch.from_numpy((0.01 * (0.8 + 0.4 * rng.random(c))).astype(np.float32))
    eps[::2] *= -1.0
    inv_mass = torch.full((k, 3), 0.7)
    mask = torch.ones(k)
    pg = make_potential_and_grad(spec_t, img_t, prior_t)
    grad = pg(theta, mask)[1]
    got = fused_leapfrog_reference(spec_t, img_t, prior_t, theta, p, eps, inv_mass, mask, 1, grad)
    want = plain_leaf(lambda th: pg(th, mask))(theta, p, eps, inv_mass, mask, grad)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    pg_j = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    u_j = pg(theta, mask)[0]
    z_j = jax.vmap(lambda th, q, u, g, e: _leapfrog_one(
        lambda t: pg_j(t, jnp.ones(k)), _Z(th, q, u, g), e, jnp.asarray(inv_mass.numpy())))(
        *(jnp.asarray(x.numpy()) for x in (theta, p, u_j, grad, eps)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(z_j.theta), atol=TOL["theta"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(z_j.p), atol=TOL["p"])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(z_j.u), atol=TOL["u"])
