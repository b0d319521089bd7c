"""ChEES on scenes beyond B2's domain: the runtime step count (B2's
contract) runs on the crowded-field leapfrog B5.  The kernel choice, the
new wrapper's CPU path against B2's plain version, and a few ChEES
iterations on a 64x64 scene through the port's kernel route, fed the JAX
keys' own draws, against the JAX package's XLA ChEES iteration (the
reference runs ChEES there when its fused kernel's gate fails,
starcat/api.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import chees as jchees
from starcat.driver import init_chain_states as j_init_chain_states
from starcat_torch import chees as tchees
from starcat_torch import dispatch
from starcat_torch import fused_leapfrog as fl
from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch.convert import (
    chain_state_from_numpy,
    chees_adaptation_from_numpy,
    prior_from_jax,
    spec_from_jax,
)
from starcat_torch.potential import make_potential_and_grad
from starcat_torch.scene import SceneSpec

torch.set_num_threads(1)

FLAGSHIP = SceneSpec(32, 32, 1.5, 10.0)
CROWDED = SceneSpec(128, 128, 1.5, 20.0)


@pytest.mark.parametrize("spec,kmax,name", [
    (FLAGSHIP, 10, "B2"),
    (SceneSpec(48, 48, 1.5, 10.0), 16, "B2"),
    (FLAGSHIP, 17, "B5"),
    (SceneSpec(64, 64, 1.5, 10.0), 20, "B5"),
    (CROWDED, 50, "B5"),
])
def test_chees_runs_on_b2_inside_its_domain_and_on_b5_beyond(spec, kmax, name):
    assert dispatch.trajectory_kernel("chees", None, spec, kmax) == name
    module = fl if name == "B2" else flc
    assert dispatch.leapfrog_module(spec, kmax)[0] is module


SPEC_J = starcat.SceneSpec(64, 64, 1.5, 10.0)
PRIOR_J = starcat.PriorSpec(5.0, 0.7)
K, C = 20, 8


@pytest.fixture(scope="module")
def scene64():
    truth = starcat.sample_prior(jax.random.key(11), K, starcat.PriorSpec(6.0, 0.3))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = starcat.make_mock_image(jax.random.key(12), x, y, f, SPEC_J)
    rng = np.random.default_rng(3)
    theta = (np.asarray(truth)[None]
             + 0.02 * rng.standard_normal((C, K, 3))).astype(np.float32)
    return dict(truth=truth, img=img, theta=theta, spec=spec_from_jax(SPEC_J),
                prior=prior_from_jax(PRIOR_J), img_t=torch.from_numpy(np.array(img)))


@pytest.mark.parametrize("n_steps", [2, 5])
def test_b5_dyn_wrapper_on_the_cpu_is_b2s_plain_version(scene64, n_steps):
    """The CPU path of make_fused_leapfrog_dyn on B5 gives what B2's does
    (both are fused_leapfrog_reference), for an int and a tensor count."""
    s = scene64
    gen = torch.Generator().manual_seed(0)
    theta = torch.from_numpy(s["theta"])
    p = torch.randn(theta.shape, generator=gen)
    eps = 0.002 * (0.8 + 0.4 * torch.rand((C,), generator=gen))
    inv_mass = torch.full((K, 3), 0.9)
    mask = torch.ones(K)
    mask[3] = 0.0
    p = p * mask[:, None]
    b5 = flc.make_fused_leapfrog_dyn(s["spec"], s["img_t"], s["prior"], K)
    want = fl.fused_leapfrog_reference(s["spec"], s["img_t"], s["prior"], theta, p, eps,
                                       inv_mass, mask, n_steps, None)
    flc.reset_launch_counts()
    for n in (n_steps, torch.tensor(n_steps, dtype=torch.int32)):
        got = b5(theta, p, eps, inv_mass, mask, n, None)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert flc.LAUNCHES == 0  # the plain version launches nothing
    with pytest.raises(ValueError, match="n_steps"):
        b5(theta, p, eps, inv_mass, mask, -1, None)


def test_chees_iterations_on_b5s_route_match_jax_on_its_draws(scene64):
    """Three ChEES iterations on the 64x64 scene (K = 20, beyond B2's
    domain) through chees.make_fused_leapfrog_impl, which takes B5's
    wrapper from dispatch, against the JAX package's XLA iteration fed the
    same keys: step counts, divergences and accept decisions equal, theta
    within 3e-4 and U within 0.3 (tests/test_pallas.py's bars), the pooled
    log-T gradient within rtol 1e-3."""
    s = scene64
    mask = jnp.ones(K)
    pg = starcat.make_potential_and_grad(SPEC_J, s["img"], PRIOR_J)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    states = j_init_chain_states(jax.random.key(5), jnp.asarray(s["theta"]), grad_fn)
    eps, traj = 0.004, 0.06
    inv_mass = np.full((K, 3), 0.05, np.float32)
    inv_mass[:, 2] = 0.01
    pg_t = make_potential_and_grad(s["spec"], s["img_t"], s["prior"])
    mask_t = torch.ones(K)
    impl = tchees.make_fused_leapfrog_impl(s["spec"], s["img_t"], s["prior"], K)
    st_t = chain_state_from_numpy(np.asarray(states.theta), np.asarray(states.u),
                                  np.asarray(states.grad), "cpu")
    eps_t, inv_mass_t, traj_t = chees_adaptation_from_numpy(eps, inv_mass, traj, "cpu")
    n_acc = 0
    for i in range(1, 4):
        keys = jax.vmap(lambda k: jax.random.split(k, 3))(states.key)
        p0 = jax.vmap(lambda k: jax.random.normal(k, (K, 3)))(keys[:, 1])
        u_acc = jax.vmap(jax.random.uniform)(keys[:, 2])
        states, info_j, g_j, _ = jchees._chees_iteration(
            states, grad_fn, jnp.asarray(eps), jnp.asarray(inv_mass), mask,
            jchees._halton2(jnp.asarray(i)), jnp.asarray(traj), 1024, 1000.0)
        st_t, info_t, g_t = tchees._chees_iteration(
            st_t, lambda th: pg_t(th, mask_t), eps_t, inv_mass_t, mask_t,
            tchees._halton2(i), traj_t, 1024, 1000.0, torch.from_numpy(np.array(p0)),
            torch.from_numpy(np.array(u_acc)), impl)
        assert int(info_t.n_leapfrog) == int(info_j.n_leapfrog) >= 2
        np.testing.assert_array_equal(info_t.diverged.numpy(), np.asarray(info_j.diverged))
        acc_t = info_t.accept_prob.numpy() > np.asarray(u_acc)
        np.testing.assert_array_equal(acc_t, np.asarray(info_j.accept_prob) > np.asarray(u_acc))
        n_acc += int(acc_t.sum())
        np.testing.assert_allclose(st_t.theta.numpy(), np.asarray(states.theta), atol=3e-4)
        np.testing.assert_allclose(st_t.u.numpy(), np.asarray(states.u), atol=0.3)
        np.testing.assert_allclose(float(g_t), float(g_j), rtol=1e-3)
    assert n_acc > 0
