"""The fused leapfrog's plain version against the Pallas kernels it
replaces (starcat/pallas_kernels.py B1 and B2, interpret mode on the CPU),
at the flagship shape with 8 chains, plus the wrapper's CPU behaviour and
its domain checks.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starcat.configs import CONFIGS
from starcat.pallas_kernels import make_pallas_leapfrog, make_pallas_leapfrog_dyn
from starcat_torch import fused_leapfrog as fl
from starcat_torch.convert import prior_from_jax, spec_from_jax

torch.set_num_threads(1)

C = 8  # the Pallas tile shrinks to gcd(8, 128) = 8
TOL = dict(theta=3e-4, p=5e-3, u=0.3, grad_rel=5e-3)


@pytest.fixture(scope="module")
def scene():
    cfg = CONFIGS["cfg6_chees"]
    truth, img = cfg.make_data()
    rng = np.random.default_rng(0)
    theta = (np.asarray(truth)[None]
             + 0.02 * rng.standard_normal((C,) + truth.shape)).astype(np.float32)
    p = rng.standard_normal(theta.shape).astype(np.float32)
    eps = (0.002 * (0.8 + 0.4 * rng.random(C))).astype(np.float32)
    inv_mass = np.full((cfg.kmax, 3), 0.9, np.float32)
    return cfg, np.asarray(img), theta, p, eps, inv_mass


def _port(cfg, img):
    return spec_from_jax(cfg.scene), torch.from_numpy(img.copy()), prior_from_jax(cfg.prior)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _assert_close(out_t, out_j):
    th, p, u, g = (o.numpy() for o in out_t)
    th_j, p_j, u_j, g_j = (np.asarray(o) for o in out_j)
    np.testing.assert_allclose(th, th_j, atol=TOL["theta"])
    np.testing.assert_allclose(p, p_j, atol=TOL["p"])
    np.testing.assert_allclose(u, u_j, atol=TOL["u"])
    rel = np.abs(g - g_j) / (1.0 + np.abs(g_j))
    assert rel.max() < TOL["grad_rel"], rel.max()


@pytest.mark.parametrize("grad_in", [False, True])
@pytest.mark.parametrize("n_steps", [0, 1, 5])
def test_reference_matches_pallas_static(scene, n_steps, grad_in):
    cfg, img, theta, p, eps, inv_mass = scene
    mask = np.ones(cfg.kmax, np.float32)
    spec, img_t, prior = _port(cfg, img)
    grad = None
    if grad_in:
        *_, grad = fl.fused_leapfrog_reference(spec, img_t, prior, *_t(theta, p, eps, inv_mass, mask), 0)
        grad = grad.numpy()
    jfused = make_pallas_leapfrog(cfg.scene, jnp.asarray(img), cfg.prior, cfg.kmax,
                                  n_steps, interpret=True)
    out_j = jfused(theta, p, eps, inv_mass, mask,
                   grad=None if grad is None else jnp.asarray(grad))
    out_t = fl.fused_leapfrog_reference(spec, img_t, prior, *_t(theta, p, eps, inv_mass, mask),
                                        n_steps, *_t(grad))
    _assert_close(out_t, out_j)
    if n_steps == 0:
        np.testing.assert_array_equal(out_t[0].numpy(), theta)


@pytest.mark.parametrize("n_steps", [1, 5])
def test_reference_matches_pallas_dyn(scene, n_steps):
    cfg, img, theta, p, eps, inv_mass = scene
    mask = np.ones(cfg.kmax, np.float32)
    spec, img_t, prior = _port(cfg, img)
    *_, grad = fl.fused_leapfrog_reference(spec, img_t, prior, *_t(theta, p, eps, inv_mass, mask), 0)
    jdyn = make_pallas_leapfrog_dyn(cfg.scene, jnp.asarray(img), cfg.prior, cfg.kmax,
                                    interpret=True)
    out_j = jdyn(theta, p, eps, inv_mass, mask, jnp.asarray(n_steps), jnp.asarray(grad.numpy()))
    dyn = fl.make_fused_leapfrog_dyn(spec, img_t, prior, cfg.kmax)
    out_t = dyn(*_t(theta, p, eps, inv_mass, mask), torch.tensor([n_steps], dtype=torch.int32),
                grad)
    _assert_close(out_t, out_j)


def test_per_chain_mask_freezes_dead_slot(scene):
    cfg, img, theta, p, eps, inv_mass = scene
    mask = np.ones((C, cfg.kmax), np.float32)
    mask[1::2, 3] = 0.0
    p = p * mask[..., None]  # masked momenta, as the heads do
    spec, img_t, prior = _port(cfg, img)
    jfused = make_pallas_leapfrog(cfg.scene, jnp.asarray(img), cfg.prior, cfg.kmax, 4,
                                  interpret=True)
    out_j = jfused(theta, p, eps, inv_mass, jnp.asarray(mask))
    fused = fl.make_fused_leapfrog(spec, img_t, prior, cfg.kmax, 4)
    out_t = fused(*_t(theta, p, eps, inv_mass, mask))
    _assert_close(out_t, out_j)
    np.testing.assert_array_equal(out_t[0].numpy()[1::2, 3], theta[1::2, 3])
    np.testing.assert_array_equal(out_t[3].numpy()[1::2, 3], 0.0)


def test_scalar_eps_equals_per_chain_eps(scene):
    cfg, img, theta, p, _, inv_mass = scene
    mask = np.ones(cfg.kmax, np.float32)
    spec, img_t, prior = _port(cfg, img)
    fused = fl.make_fused_leapfrog(spec, img_t, prior, cfg.kmax, 3)
    a = fused(*_t(theta, p), 0.002, *_t(inv_mass, mask))
    b = fused(*_t(theta, p, np.full(C, 0.002, np.float32), inv_mass, mask))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_on_cpu_is_the_reference_and_counts_nothing(scene):
    cfg, img, theta, p, eps, inv_mass = scene
    mask = np.ones(cfg.kmax, np.float32)
    spec, img_t, prior = _port(cfg, img)
    before = (fl.LAUNCHES, fl.STATIC_LAUNCHES, fl.DYN_LAUNCHES)
    args = _t(theta, p, eps, inv_mass, mask)
    out_w = fl.make_fused_leapfrog(spec, img_t, prior, cfg.kmax, 2)(*args)
    out_d = fl.make_fused_leapfrog_dyn(spec, img_t, prior, cfg.kmax)(*args, 2, None)
    out_r = fl.fused_leapfrog_reference(spec, img_t, prior, *args, 2)
    for a, b, c in zip(out_w, out_d, out_r):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())
    assert (fl.LAUNCHES, fl.STATIC_LAUNCHES, fl.DYN_LAUNCHES) == before


@pytest.mark.parametrize("contract", ["static", "dyn"])
def test_wrapper_rejects_a_negative_step_count(scene, contract):
    cfg, img, theta, p, eps, inv_mass = scene
    spec, img_t, prior = _port(cfg, img)
    args = _t(theta, p, eps, inv_mass, np.ones(cfg.kmax, np.float32))
    with pytest.raises(ValueError, match="n_steps must be >= 0"):
        if contract == "static":
            fl.make_fused_leapfrog(spec, img_t, prior, cfg.kmax, -1)(*args)
        else:
            fl.make_fused_leapfrog_dyn(spec, img_t, prior, cfg.kmax)(*args, -1, None)


def test_wrapper_raises_off_cpu_and_cuda(scene):
    cfg, img, theta, p, eps, inv_mass = scene
    spec, _, prior = _port(cfg, img)
    img_m = torch.from_numpy(img.copy()).to("meta")
    fused = fl.make_fused_leapfrog(spec, img_m, prior, cfg.kmax, 2)
    args = [torch.from_numpy(a).to("meta") for a in (theta, p, eps, inv_mass)]
    with pytest.raises(ValueError, match="no fused leapfrog for device"):
        fused(*args, torch.ones(cfg.kmax, device="meta"))


@pytest.mark.parametrize("shape,kmax", [((64, 64), 10), ((32, 32), 17), ((48, 49), 4)])
def test_domain_check_names_the_crowded_field_kernel(shape, kmax):
    spec = fl.SceneSpec(shape[0], shape[1], 1.5, 10.0)
    with pytest.raises(ValueError, match="B5"):
        fl.check_domain(spec, kmax)


def test_domain_check_accepts_the_presets():
    for name in ("cfg0_single_star", "cfg6_chees"):
        cfg = CONFIGS[name]
        fl.check_domain(spec_from_jax(cfg.scene), cfg.kmax)
    # the largest square scene of the domain fits one block's shared memory
    assert fl.smem_bytes(16, 48, 48) <= fl.MAX_SMEM_BYTES
    assert fl.smem_bytes(10, 32, 32) == 4 * (19 * 10 + 9 + 2 * 1024 + 10 * 96)
