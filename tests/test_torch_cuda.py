"""The fused leapfrog CUDA kernel and the slice on an NVIDIA GPU.

Every test here needs the card: each is marked ``cuda`` and skips without
one.  This file imports no JAX (the card's machine has none); run it there
without the root conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from starcat_torch import api
from starcat_torch import fused_leapfrog as fl
from starcat_torch.configs import CONFIGS

pytestmark = pytest.mark.cuda

TOL = dict(theta=3e-4, p=5e-3, u=0.3, grad_rel=5e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(name, c, dev, seed=0):
    cfg = CONFIGS[name]
    truth, img = cfg.make_data()
    gen = torch.Generator(device=dev).manual_seed(seed)
    theta = truth.to(dev)[None] + 0.02 * torch.randn((c, cfg.kmax, 3), generator=gen, device=dev)
    p = torch.randn((c, cfg.kmax, 3), generator=gen, device=dev)
    eps = 0.002 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    inv_mass = torch.full((cfg.kmax, 3), 0.9, device=dev)
    return cfg, img.to(dev), theta, p, eps, inv_mass


def _assert_close(out, ref):
    th, p, u, g = out
    th_r, p_r, u_r, g_r = ref
    assert float((th - th_r).abs().max()) <= TOL["theta"]
    assert float((p - p_r).abs().max()) <= TOL["p"]
    assert float((u - u_r).abs().max()) <= TOL["u"]
    assert float(((g - g_r).abs() / (1 + g_r.abs())).max()) <= TOL["grad_rel"]


@pytest.mark.parametrize("grad_in", [False, True])
@pytest.mark.parametrize("n_steps", [0, 1, 5])
@pytest.mark.parametrize("name,c", [("cfg0_single_star", 5), ("cfg6_chees", 37)])
def test_kernel_matches_plain(dev, name, c, n_steps, grad_in):
    cfg, img, theta, p, eps, inv_mass = _inputs(name, c, dev)
    mask = torch.ones(cfg.kmax, device=dev)
    ref = lambda n, g: fl.fused_leapfrog_reference(  # noqa: E731
        cfg.scene, img, cfg.prior, theta, p, eps, inv_mass, mask, n, g)
    grad = ref(0, None)[3] if grad_in else None
    static = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, n_steps)
    dyn = fl.make_fused_leapfrog_dyn(cfg.scene, img, cfg.prior, cfg.kmax)
    want = ref(n_steps, grad)
    _assert_close(static(theta, p, eps, inv_mass, mask, grad=grad), want)
    n_dev = torch.full((1,), n_steps, dtype=torch.int32, device=dev)
    _assert_close(dyn(theta, p, eps, inv_mass, mask, n_dev, grad), want)
    torch.cuda.synchronize()


def test_kernel_per_chain_mask_freezes_dead_slot(dev):
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", 64, dev)
    mask = torch.ones((64, cfg.kmax), device=dev)
    mask[1::2, 3] = 0.0
    p = p * mask[..., None]
    out = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 5)(
        theta, p, eps, inv_mass, mask)
    _assert_close(out, fl.fused_leapfrog_reference(
        cfg.scene, img, cfg.prior, theta, p, eps, inv_mass, mask, 5))
    assert torch.equal(out[0][1::2, 3], theta[1::2, 3])
    assert bool((out[3][1::2, 3] == 0).all())


def test_kernel_gradient_within_float64_bar(dev):
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", 256, dev)
    mask = torch.ones(cfg.kmax, device=dev)
    *_, g = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 0)(
        theta, p, eps, inv_mass, mask)
    *_, g64 = fl.fused_leapfrog_reference(
        cfg.scene, img.double(), cfg.prior, theta.double(), p.double(), eps.double(),
        inv_mass.double(), mask.double(), 0)
    assert float((g.double() - g64).abs().max()) <= 0.017


def test_dyn_kernel_reads_the_device_step_count(dev):
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", 16, dev)
    mask = torch.ones(cfg.kmax, device=dev)
    dyn = fl.make_fused_leapfrog_dyn(cfg.scene, img, cfg.prior, cfg.kmax)
    grad = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps,
                                       inv_mass, mask, 0)[3]
    n_dev = torch.full((1,), 2, dtype=torch.int32, device=dev)
    a = dyn(theta, p, eps, inv_mass, mask, n_dev, grad)
    n_dev.fill_(4)  # on the device, no host round trip
    b = dyn(theta, p, eps, inv_mass, mask, n_dev, grad)
    _assert_close(a, fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p,
                                                 eps, inv_mass, mask, 2, grad))
    _assert_close(b, fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p,
                                                 eps, inv_mass, mask, 4, grad))
    n_dev.fill_(-3)  # a negative device count acts as 0: (U, grad U) at theta
    c = dyn(theta, p, eps, inv_mass, mask, n_dev, grad)
    _assert_close(c, fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p,
                                                 eps, inv_mass, mask, 0))


def test_launch_counts(dev):
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", 8, dev)
    mask = torch.ones(cfg.kmax, device=dev)
    fl.reset_launch_counts()
    fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 3)(theta, p, eps, inv_mass, mask)
    dyn = fl.make_fused_leapfrog_dyn(cfg.scene, img, cfg.prior, cfg.kmax)
    dyn(theta, p, eps, inv_mass, mask, 3, None)
    dyn(theta, p, eps, inv_mass, mask, 1, None)
    assert (fl.LAUNCHES, fl.STATIC_LAUNCHES, fl.DYN_LAUNCHES) == (3, 1, 2)


def test_wrapper_rejects_bad_inputs(dev):
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", 8, dev)
    mask = torch.ones(cfg.kmax, device=dev)
    fused = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 2)
    with pytest.raises(ValueError, match="float32"):
        fused(theta.double(), p, eps, inv_mass, mask)
    with pytest.raises(ValueError, match="contiguous"):
        fused(theta.transpose(0, 1).contiguous().transpose(0, 1), p, eps, inv_mass, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta[:, :5], p, eps, inv_mass, mask)
    with pytest.raises(ValueError, match="eps"):
        fused(theta, p, eps[:3], inv_mass, mask)
    img_cpu = fl.make_fused_leapfrog(cfg.scene, img.cpu(), cfg.prior, cfg.kmax, 2)
    with pytest.raises(ValueError, match="image is on"):
        img_cpu(theta, p, eps, inv_mass, mask)
    big = cfg.scene._replace(height=64, width=64)
    with pytest.raises(ValueError, match="B5"):
        fl.make_fused_leapfrog(big, torch.zeros((64, 64), device=dev), cfg.prior, cfg.kmax, 2)


@pytest.mark.parametrize("head", ["hmc", "chees"])
def test_slice_runs_through_the_kernel(dev, head):
    cfg = dataclasses.replace(CONFIGS["cfg0_single_star"], head=head, n_chains=64,
                              n_samples=200, n_warmup=200)
    out = api.sample(cfg, dev, seed=3)
    assert out.stats["kernel"] == "cuda_fused"
    assert out.stats["kernel_launches"] > 0
    assert np.isfinite(out.thetas).all()
    assert 0.5 < out.stats["accept"] < 0.99
    truth_flux = float(out.stats["truth"]["f"][0])
    flux = api.summarize_output(out)["flux"]
    assert abs(flux["mean"] - truth_flux) < 4 * flux["sd"]


# ---- kernel B3: the diagonal-Fisher Riemannian trajectory ----------------

# tests/test_pallas_rhmc_diag.py:119-126: theta 1e-4, p 1e-3, h 2e-3.  h0,
# h1 and u1 are float32 numbers of magnitude ~2e4 at the flagship scene,
# where float32's own spacing is ~2e-3, so the h bound adds four spacings.
RTOL = dict(theta=1e-4, p=1e-3, h=2e-3, resid=1e-5)


def _h_tol(h, spacings=4):
    return RTOL["h"] + spacings * float(np.spacing(np.float32(h.abs().max().item())))


def _rhmc_inputs(c, k, dev, per_chain, seed=0):
    cfg = CONFIGS["cfg5_transdim_mcmc"]
    truth, img = cfg.make_data()
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = min(10, k)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = truth[:n].to(dev)[None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    if k > n:
        theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
        theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.03 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    if per_chain:
        alive = torch.randint(6, k + 1, (c,), generator=gen, device=dev)
        order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
        mask = (order < alive[:, None]).to(torch.float32)
    else:
        mask = torch.ones(k, device=dev)
    return cfg, img.to(dev), theta, xi, eps, mask


def _assert_rhmc_close(out, ref, spacings=4):
    assert float((out[0] - ref[0]).abs().max()) <= RTOL["theta"]
    assert float((out[1] - ref[1]).abs().max()) <= RTOL["p"]
    for a, b in zip(out[2:5], ref[2:5]):
        assert float((a - b).abs().max()) <= _h_tol(b, spacings)
    assert float((out[5] - ref[5]).abs().max()) <= RTOL["resid"]


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("shape", ["cfg5", "cfg1"])
def test_rhmc_kernel_matches_plain(dev, shape, beta):
    from starcat_torch import fused_rhmc_diag as frd

    c, k, n_steps, fpi, per_chain = ((64, 16, 6, 4, True) if shape == "cfg5"
                                     else (32, 10, 16, 6, False))
    cfg, img, theta, xi, eps, mask = _rhmc_inputs(c, k, dev, per_chain)
    out = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, k, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(beta, device=dev))
    ref = frd.fused_rhmc_diag_reference(cfg.scene, img, cfg.prior, theta, xi, eps, mask,
                                        beta, n_steps, fpi)
    torch.cuda.synchronize()
    _assert_rhmc_close(out, ref)
    if per_chain:  # dead slots frozen bit for bit, their momentum zero
        dead = mask == 0
        assert bool(dead.any())
        assert torch.equal(out[0][dead], theta[dead])
        assert bool((out[1][dead] == 0).all())


def test_rhmc_kernel_reports_a_nan_chain_as_a_solver_failure(dev):
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch.driver import ChainState
    from starcat_torch.rhmc import rhmc_transition

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(16, 16, dev, True, seed=3)
    theta[0, :, 2] = 95.0  # exp(95) overflows float32
    fused = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 16, 6, 4)
    out = fused(theta, xi, eps, mask)
    assert bool(torch.isnan(out[5][0])) and bool(torch.isfinite(out[5][1:]).all())
    u = torch.zeros(16, device=dev)
    new, info = rhmc_transition(ChainState(theta, u, torch.zeros_like(theta)), xi,
                                torch.full((16,), 0.5, device=dev),
                                torch.full((16,), 0.01, device=dev), fused,
                                torch.tensor(0.03, device=dev), mask)
    assert bool(info.solver_fail[0]) and not bool(info.accepted[0])
    assert torch.equal(new.theta[0], theta[0])


def test_rhmc_wrapper_rejects_bad_inputs(dev):
    from starcat_torch import fused_rhmc_diag as frd

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(8, 16, dev, True)
    fused = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 16, 2, 2)
    with pytest.raises(ValueError, match="float32"):
        fused(theta.double(), xi, eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi[:, :5], eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi, eps, mask[:, :5])
    with pytest.raises(ValueError, match="eps"):
        fused(theta, xi, eps[:3], mask)
    with pytest.raises(ValueError, match="beta"):
        fused(theta, xi, eps, mask, torch.tensor(1.0))
    with pytest.raises(ValueError, match="B4"):
        frd.make_fused_rhmc_diag(cfg.scene._replace(height=64, width=64),
                                 torch.zeros((64, 64), device=dev), cfg.prior, 16, 2, 2)
    with pytest.raises(ValueError, match="B4"):
        frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 17, 2, 2)


def test_rhmc_launch_count(dev):
    from starcat_torch import fused_rhmc_diag as frd

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(8, 16, dev, True)
    frd.reset_launch_counts()
    fused = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 16, 1, 1)
    fused(theta, xi, eps, mask)
    fused(theta, xi, eps, mask, 0.5)
    assert frd.LAUNCHES == 2


@pytest.mark.parametrize("name,over,kernel", [
    ("cfg5_transdim_mcmc", {"n_chains": 64, "n_warmup": 40, "n_samples": 20},
     "rhmc_diag_cuda"),
    ("cfg5_transdim_mcmc", {"n_chains": 64, "n_warmup": 40, "n_samples": 20,
                            "tdm.mutation": "hmc"}, "hmc_cuda"),
    ("cfg1_rhmc", {"n_chains": 64, "n_warmup": 60, "n_samples": 30, "rhmc.metric": "diag"},
     "rhmc_diag_cuda"),
])
def test_riemannian_and_transdim_heads_run_through_the_kernels(dev, name, over, kernel):
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS[name], over)
    out = api.sample(cfg, dev, seed=1)
    assert out.stats["kernel"] == kernel and out.stats["kernel_launches"] > 0
    assert np.isfinite(out.thetas).all()
    assert 0.3 < out.stats["accept"] <= 1.0
    summ = api.summarize_output(out)
    assert np.isfinite(summ["total_flux"]["mean"])
    if name.startswith("cfg5"):
        assert out.masks.shape == (cfg.n_chains, cfg.n_samples, cfg.kmax)
        assert 6 <= summ["star_count"]["mean"] <= 14


# -- B6, the full-Fisher Riemannian trajectory --------------------------------

TIGHT = 1e-3  # chains whose fixed points converged this far in both versions


@pytest.mark.parametrize("beta", [0.3, 1.0])
@pytest.mark.parametrize("shape", ["cfg3", "cfg1"])
def test_full_rhmc_kernel_matches_plain(dev, shape, beta):
    """B6 against its plain version on the chains whose fixed points
    converged tightly in both (on the others float32 rounding is amplified
    by the chain's own trajectory, both versions alike); solver verdicts
    agree on every chain."""
    from starcat_torch import fused_rhmc as fr

    c, k, n_steps, fpi, per_chain = ((64, 16, 6, 4, True) if shape == "cfg3"
                                     else (32, 10, 16, 6, False))
    cfg, img, theta, xi, eps, mask = _rhmc_inputs(c, k, dev, per_chain)
    eps = eps / 3.0
    out = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, k, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(beta, device=dev))
    ref = fr.fused_rhmc_reference(cfg.scene, img, cfg.prior, theta, xi, eps, mask,
                                  beta, n_steps, fpi)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= 0.9 * c
    _assert_rhmc_close([o[tight] for o in out], [r[tight] for r in ref])
    if per_chain:  # dead slots of converged chains frozen bit for bit, momentum zero
        dead = (mask == 0) & (out[5] < 0.05)[:, None]
        assert bool(dead.any())
        assert torch.equal(out[0][dead], theta[dead])
        assert bool((out[1][dead] == 0).all())


def test_full_rhmc_kernel_reports_a_nan_chain_as_a_solver_failure(dev):
    from starcat_torch import fused_rhmc as fr
    from starcat_torch.driver import ChainState
    from starcat_torch.rhmc import rhmc_transition

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(16, 16, dev, True, seed=3)
    theta[0, :, 2] = 95.0  # exp(95) overflows float32
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 16, 6, 4)
    out = fused(theta, xi, eps / 3.0, mask)
    assert bool(torch.isnan(out[5][0])) and bool(torch.isfinite(out[5][1:]).all())
    u = torch.zeros(16, device=dev)
    new, info = rhmc_transition(ChainState(theta, u, torch.zeros_like(theta)), xi,
                                torch.full((16,), 0.5, device=dev),
                                torch.full((16,), 0.01, device=dev), fused,
                                torch.tensor(0.01, device=dev), mask)
    assert bool(info.solver_fail[0]) and not bool(info.accepted[0])
    assert torch.equal(new.theta[0], theta[0])


def test_full_rhmc_wrapper_rejects_bad_inputs(dev):
    from starcat_torch import fused_rhmc as fr

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(8, 16, dev, True)
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 16, 2, 2)
    with pytest.raises(ValueError, match="float32"):
        fused(theta.double(), xi, eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi[:, :5], eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi, eps, mask[:, :5])
    with pytest.raises(ValueError, match="eps"):
        fused(theta, xi, eps[:3], mask)
    with pytest.raises(ValueError, match="beta"):
        fused(theta, xi, eps, mask, torch.tensor(1.0))
    with pytest.raises(ValueError, match="B6"):
        fr.make_fused_rhmc(cfg.scene._replace(height=64, width=64),
                           torch.zeros((64, 64), device=dev), cfg.prior, 16, 2, 2)
    with pytest.raises(ValueError, match="B6"):
        fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 17, 2, 2)


def test_full_rhmc_launch_count(dev):
    from starcat_torch import fused_rhmc as fr

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(8, 16, dev, True)
    fr.reset_launch_counts()
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 16, 1, 1)
    fused(theta, xi, eps, mask)
    fused(theta, xi, eps, mask, 0.5)
    assert fr.LAUNCHES == 2


@pytest.mark.parametrize("name,over,kernel", [
    ("cfg1_rhmc", {"n_chains": 64, "n_warmup": 60, "n_samples": 30}, "rhmc_full_cuda"),
    ("cfg5_transdim_mcmc", {"n_chains": 64, "n_warmup": 40, "n_samples": 20,
                            "tdm.mutation": "rhmc"}, "rhmc_cuda"),
    ("cfg3_transdim_smc", {"smc.n_particles": 512, "smc.max_steps": 4}, "rhmc_cuda"),
])
def test_full_metric_heads_run_through_b6(dev, name, over, kernel):
    from starcat_torch import fused_rhmc as fr
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS[name], over)
    fr.reset_launch_counts()
    out = api.sample(cfg, dev, seed=1)
    assert out.stats["kernel"] == kernel and out.stats["kernel_launches"] > 0
    assert fr.LAUNCHES == out.stats["kernel_launches"]
    assert np.isfinite(out.thetas).all()
    assert 0.1 < out.stats["accept"] <= 1.0
    assert np.isfinite(api.summarize_output(out)["total_flux"]["mean"])
    if name.startswith("cfg3"):
        assert out.thetas.shape == (512, 1, cfg.kmax, 3) and out.masks.shape == (512, cfg.kmax)
        assert out.stats["n_temp_steps"] == 4 and 0.0 < out.stats["beta"] < 1.0


def _cut_scene(h, w, k, c, dev, seed):
    """An h x w cut of the crowded image with the true stars inside it near
    their truth in theta's first slots (prior-like draws in the rest),
    standard-normal xi and per-chain masks with 1..k live stars."""
    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    spec = cfg.scene._replace(height=h, width=w)
    x = cfg.scene.width * torch.sigmoid(truth[:, 0])
    y = cfg.scene.height * torch.sigmoid(truth[:, 1])
    inside = (x < w - 2.0) & (y < h - 2.0)
    xs, ys = x[inside] / w, y[inside] / h
    cut = torch.stack([torch.log(xs / (1 - xs)), torch.log(ys / (1 - ys)),
                       truth[inside, 2]], dim=1)[:k].to(dev)
    n = min(k, cut.shape[0])
    gen = torch.Generator(device=dev).manual_seed(seed)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = cut[:n][None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
    theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(1, k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    eps = torch.full((c,), 0.01, device=dev)
    return spec, cfg.prior, img[:h, :w].contiguous().to(dev), theta, xi, eps, mask


@pytest.mark.parametrize("c,k,h,w", [
    (1, 16, 32, 32),     # one chain
    (7, 16, 32, 32),     # an odd chain count
    (33, 1, 32, 32),     # one star (D = 3)
    (300, 10, 32, 32),   # enough chains for the 256-thread layout
    (9, 16, 48, 48),     # the shared-memory edge of the domain
    (16, 12, 40, 48),    # a non-square scene
])
def test_full_rhmc_kernel_at_the_edges_of_its_layout(dev, c, k, h, w):
    """B6 against its plain version where its layout is most at risk, chain
    by chain as test_full_rhmc_kernel_matches_plain; dead slots frozen."""
    from starcat_torch import fused_rhmc as fr

    if (h, w) == (32, 32):
        cfg, img, theta, xi, eps, mask = _rhmc_inputs(c, k, dev, k >= 6, seed=4)
        spec, prior, eps = cfg.scene, cfg.prior, eps / 3.0
    else:
        spec, prior, img, theta, xi, eps, mask = _cut_scene(h, w, k, c, dev, seed=4)
    out = fr.make_fused_rhmc(spec, img, prior, k, 6, 4)(theta, xi, eps, mask,
                                                        torch.tensor(0.7, device=dev))
    ref = fr.fused_rhmc_reference(spec, img, prior, theta, xi, eps, mask, 0.7, 6, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= max(1, int(0.8 * c))
    _assert_rhmc_close([o[tight] for o in out], [r[tight] for r in ref])
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    dead = (live == 0) & (out[5] < 0.05)[:, None]
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[1][dead] == 0).all())


def test_full_rhmc_kernel_result_does_not_depend_on_the_chain_count(dev):
    """At the cfg1 shape (K = 10, 16 x 6, shared mask) a chain's outputs are
    the same bits whether it runs alone, among 7 or among 64 in another
    order, and on a second run: nothing leaks between chains."""
    from starcat_torch import fused_rhmc as fr

    def bits(t):  # NaN (a blown-up chain) equals itself bit for bit
        return t.view(torch.int32)

    cfg, img, theta, xi, eps, mask = _rhmc_inputs(64, 10, dev, False, seed=6)
    eps = eps / 3.0
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 10, 16, 6)
    full = fused(theta, xi, eps, mask)
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(full, fused(theta, xi, eps, mask)))
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(63, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(), mask)
        for a, b in zip(part, full):
            assert torch.equal(bits(a), bits(b[sel]))


def test_full_rhmc_kernel_across_its_layout_boundary(dev):
    """A launch of as many chains as the card has SMs runs 512 threads a
    chain, one more chain 256 threads: the sums run in another order, so a
    chain agrees across the boundary within the tolerance that holds the
    kernel to its plain version (RTOL), not bit for bit."""
    from starcat_torch import fused_rhmc as fr

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fr.launch_layout(sms, 10, 32, 32)["threads"] == 512
    assert fr.launch_layout(sms + 1, 10, 32, 32)["threads"] == 256
    cfg, img, theta, xi, eps, mask = _rhmc_inputs(sms + 1, 10, dev, False, seed=7)
    eps = eps / 3.0
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, 10, 16, 6)
    wide = fused(theta[:sms].contiguous(), xi[:sms].contiguous(), eps[:sms].contiguous(), mask)
    narrow = [o[:sms] for o in fused(theta, xi, eps, mask)]
    torch.cuda.synchronize()
    tight = (wide[5] < TIGHT) & (narrow[5] < TIGHT)
    assert int(tight.sum()) >= int(0.8 * sms)
    _assert_rhmc_close([o[tight] for o in wide], [o[tight] for o in narrow])


# -- B6c, the full-Fisher trajectory beyond B6's domain -------------------------

def _b6c_inputs(h, w, k, c, dev, seed, live=None):
    """_cut_scene's inputs; with ``live``, per-chain masks of live - 5 ..
    live + 5 live stars (at most k) in shuffled slots."""
    spec, prior, img, theta, xi, eps, mask = _cut_scene(h, w, k, c, dev, seed)
    if live is not None:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        alive = torch.randint(live - 5, min(live + 5, k) + 1, (c,), generator=gen, device=dev)
        order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
        mask = (order < alive[:, None]).to(torch.float32)
    return spec, prior, img, theta, xi, eps, mask


@pytest.mark.parametrize("beta", [0.7, 1.0])
@pytest.mark.parametrize("h,w,k,c,live", [(64, 64, 20, 16, None), (128, 128, 64, 8, 50)])
def test_b6c_matches_plain(dev, h, w, k, c, live, beta):
    """B6c against its plain version on the chains whose fixed points
    converged tightly in both, solver verdicts equal on every chain, energies
    within RTOL plus four float32 spacings at their magnitude, eight on the
    128x128 field (the kernel sums them in double, the plain version in
    float32; chip_smoke.py's bars), dead slots frozen bit for bit."""
    from starcat_torch import fused_rhmc as fr
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(h, w, k, c, dev, 11, live)
    out = frc.make_fused_rhmc(spec, img, prior, k, 6, 4)(theta, xi, eps, mask,
                                                         torch.tensor(beta, device=dev))
    ref = fr.fused_rhmc_reference(spec, img, prior, theta, xi, eps, mask, beta, 6, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= int(0.8 * c)
    _assert_rhmc_close([o[tight] for o in out], [r[tight] for r in ref],
                       spacings=8 if h == 128 else 4)
    dead = (mask == 0) & (out[5] < 0.05)[:, None]
    assert bool(dead.any())
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[1][dead] == 0).all())


def test_b6c_reports_a_nan_chain_as_a_solver_failure(dev):
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch.driver import ChainState
    from starcat_torch.rhmc import rhmc_transition

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(64, 64, 20, 16, dev, 12)
    theta[0, :, 2] = 95.0  # exp(95) overflows float32
    fused = frc.make_fused_rhmc(spec, img, prior, 20, 6, 4)
    out = fused(theta, xi, eps, mask)
    assert bool(torch.isnan(out[5][0])) and bool(torch.isfinite(out[5][1:]).all())
    new, info = rhmc_transition(ChainState(theta, torch.zeros(16, device=dev),
                                           torch.zeros_like(theta)), xi,
                                torch.full((16,), 0.5, device=dev),
                                torch.full((16,), 0.01, device=dev), fused,
                                torch.tensor(0.01, device=dev), mask)
    assert bool(info.solver_fail[0]) and not bool(info.accepted[0])
    assert torch.equal(new.theta[0], theta[0])


def test_b6c_gives_a_chain_the_same_bits_at_any_chain_count(dev):
    """A block walks several chains in one workspace: a chain's outputs are
    the same bits alone, among 7 others and among 300, and on a rerun."""
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(49, 49, 16, 300, dev, 13)
    fused = frc.make_fused_rhmc(spec, img, prior, 16, 6, 4)
    assert frc.launch_layout(300, 16, 49, 49, dev)["chains_per_block"] >= 2
    full = fused(theta, xi, eps, mask)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(theta, xi, eps, mask)))
    for idx in ([5], [0, 9, 17, 5, 41, 52, 63, 299]):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(),
                     mask[sel].contiguous())
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))


def test_b6c_ptxas_reports_no_spills(dev):
    """The B6c build keeps every value in registers or shared memory in the
    kernels that run up to K = 347, the one-tile kernel and the wide
    kernel with the whole Cholesky panel in shared memory, and in the wide
    path's address probe: their ptxas reports (nvcc -Xptxas -v) show 0
    bytes of spill stores and loads and no stack frame.  The fourth, the
    wide kernel that streams the panel beyond K = 347 (wide_kernel<true>),
    spills, and is 1.14x the second's time where both run (PERF.md)."""
    import re

    from starcat_torch import build

    _, report, _ = build.build_kernel("fused_rhmc_crowded")
    rows = dict(re.findall(r"Function properties for (\S+)\s+(\d+ bytes stack frame, \d+ "
                           r"bytes spill stores, \d+ bytes spill loads)", report))
    assert len(rows) == 4, report
    kept = {f: r for f, r in rows.items() if "wide_kernelILb1E" not in f}
    assert len(kept) == 3 and any("addr_probe" in f for f in kept), report
    assert all(r == "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
               for r in kept.values()), report


def test_b6c_chain_counter_gives_the_same_bits_at_many_chains_a_block(dev):
    """Blocks take the chains from the workspace's counter: at 1200 chains
    (about nine a block on an H100), with live counts from 1 to K in
    shuffled slots, every chain gives the bits it gives alone and on a
    rerun, so the counter's order reaches no chain's result."""
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(40, 48, 12, 1200, dev, 16)
    fused = frc.make_fused_rhmc(spec, img, prior, 12, 2, 2)
    assert frc.launch_layout(1200, 12, 40, 48, dev)["chains_per_block"] >= 8
    full = fused(theta, xi, eps, mask)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(theta, xi, eps, mask)))
    for idx in ([1199], [3, 700, 11, 1199, 0]):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(),
                     mask[sel].contiguous())
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))


def test_b6c_launch_count(dev):
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(64, 64, 20, 4, dev, 14)
    frc.reset_launch_counts()
    fused = frc.make_fused_rhmc(spec, img, prior, 20, 1, 1)
    fused(theta, xi, eps, mask)
    fused(theta, xi, eps, mask, 0.5)
    assert frc.LAUNCHES == 2


def test_b6c_wrapper_rejects_bad_inputs(dev):
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_inputs(64, 64, 20, 8, dev, 15)
    fused = frc.make_fused_rhmc(spec, img, prior, 20, 2, 2)
    with pytest.raises(ValueError, match="float32"):
        fused(theta.double(), xi, eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi[:, :5], eps, mask)
    with pytest.raises(ValueError, match="shape"):
        fused(theta, xi, eps, mask[:, :5])
    with pytest.raises(ValueError, match="eps"):
        fused(theta, xi, eps[:3], mask)
    with pytest.raises(ValueError, match="beta"):
        fused(theta, xi, eps, mask, torch.tensor(1.0))
    with pytest.raises(ValueError, match="theta"):
        fused(theta[0], xi, eps, mask)
    # every scene and K >= 1: only below does the wrapper raise, and K =
    # 10923, past the old 32-bit pair-sum index, makes a trajectory
    with pytest.raises(ValueError, match="B6c"):
        frc.make_fused_rhmc(spec, img, prior, 0, 2, 2)
    assert callable(frc.make_fused_rhmc(spec, img, prior, 10923, 2, 2))


@pytest.mark.parametrize("h,w,k", [(32, 32, 65), (128, 128, 348), (128, 128, 700),
                                   (136, 18, 10923)])
def test_b6c_address_probe_reaches_every_corner_of_a_slice(dev, h, w, k):
    """The wide path's index helpers, run by the kernel's address probe in a
    real slice: every corner's offset (pair sums, packed L, the streamed
    panel's step, L^-1, G^-1, the q coefficients) equals the exact one, and
    its sentinel is read back there; at K = 10923 the last pair sum lies
    past 2^31 floats."""
    from starcat_torch import fused_rhmc_crowded as frc

    got = frc.address_probe(k, h, w, dev)
    assert got["ok"], got["corners"]
    if k == 10923:
        assert got["corners"][1]["offset"] > 2**31
    torch.cuda.empty_cache()


def _b6c_wide_inputs(h, w, k, c, dev, seed):
    """A drawn h x w field at cfg4's star density, theta near its truth in
    the first slots (prior-like draws in the rest), standard-normal xi, eps
    0.005 and per-chain masks with 1..k live stars in shuffled slots."""
    from starcat_torch.configs import apply_overrides

    n = max(1, round(50 * h * w / (128 * 128)))
    cfg = apply_overrides(CONFIGS["cfg4_crowded"],
                          {"scene.height": h, "scene.width": w, "n_stars": n})
    truth, img = cfg.make_data()
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = min(n, k)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :m] = truth[:m].to(dev)[None] + 0.02 * torch.randn((c, m, 3), generator=gen,
                                                                device=dev)
    theta[:, m:, :2] = 2.0 * torch.randn((c, k - m, 2), generator=gen, device=dev)
    theta[:, m:, 2] = 5.0 + 0.7 * torch.randn((c, k - m), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(1, k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    eps = torch.full((c,), 0.005, device=dev)
    return cfg.scene, cfg.prior, img.to(dev), theta, xi, eps, mask


@pytest.mark.parametrize("h,w,k,c", [
    (129, 128, 10, 8),   # one row past the one-tile path's 128
    (64, 136, 12, 8),    # columns past it
    (32, 32, 65, 6),     # one star past its K = 64
    (200, 136, 40, 6),   # both sides past it
])
def test_b6c_wide_path_matches_plain(dev, h, w, k, c):
    """B6c's wide path against its plain version on the chains whose fixed
    points converged tightly in both, solver verdicts equal on every chain,
    energies within RTOL plus eight float32 spacings at their magnitude,
    dead slots frozen bit for bit."""
    from starcat_torch import fused_rhmc as fr
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_wide_inputs(h, w, k, c, dev, 17)
    assert not frc.one_tile(k, h, w) and frc.domain_error(spec, k) is None
    out = frc.make_fused_rhmc(spec, img, prior, k, 6, 4)(theta, xi, eps, mask,
                                                         torch.tensor(0.8, device=dev))
    ref = fr.fused_rhmc_reference(spec, img, prior, theta, xi, eps, mask, 0.8, 6, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= int(0.8 * c)
    _assert_rhmc_close([o[tight] for o in out], [r[tight] for r in ref], spacings=8)
    dead = (mask == 0) & (out[5] < 0.05)[:, None]
    assert bool(dead.any())
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[1][dead] == 0).all())


def test_b6c_wide_path_gives_a_chain_the_same_bits_at_any_chain_count(dev):
    """The wide path's blocks take chains from the counter too: a chain's
    outputs are the same bits alone, among others and among 300, and on a
    rerun; a chain that overflows is a NaN residual alone."""
    from starcat_torch import fused_rhmc_crowded as frc

    spec, prior, img, theta, xi, eps, mask = _b6c_wide_inputs(129, 128, 10, 300, dev, 18)
    fused = frc.make_fused_rhmc(spec, img, prior, 10, 2, 2)
    assert frc.launch_layout(300, 10, 129, 128, dev)["chains_per_block"] >= 2
    full = fused(theta, xi, eps, mask)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(theta, xi, eps, mask)))
    for idx in ([5], [0, 9, 17, 5, 41, 52, 63, 299]):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(),
                     mask[sel].contiguous())
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))
    theta[0, :, 2] = 95.0  # exp(95) overflows float32
    out = fused(theta, xi, eps, mask)
    assert bool(torch.isnan(out[5][0])) and bool(torch.isfinite(out[5][1:]).all())


WIDE_FIELD = {"scene.height": 64, "scene.width": 64, "n_stars": 20, "truth_seed": 41,
              "data_seed": 42}


@pytest.mark.parametrize("name,over,kernel", [
    ("cfg1_rhmc", {**WIDE_FIELD, "kmax": 20, "n_warmup": 60, "n_samples": 30},
     "rhmc_full_cuda"),
    ("cfg5_transdim_mcmc", {**WIDE_FIELD, "kmax": 24, "tdm.mutation": "rhmc",
                            "n_chains": 64, "n_warmup": 20, "n_samples": 10}, "rhmc_cuda"),
    ("cfg4_crowded", {"smc.mutation": "rhmc", "smc.n_particles": 512, "smc.max_steps": 2},
     "rhmc_cuda"),
])
def test_full_metric_heads_run_through_b6c_beyond_b6s_domain(dev, name, over, kernel):
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS[name], over)
    frc.reset_launch_counts()
    out = api.sample(cfg, dev, seed=1)
    assert out.stats["kernel"] == kernel and out.stats["trajectory_kernel"] == "B6c"
    assert out.stats["kernel_launches"] > 0 and frc.LAUNCHES == out.stats["kernel_launches"]
    assert np.isfinite(out.thetas).all()
    assert np.isfinite(api.summarize_output(out)["total_flux"]["mean"])


# -- B5 and B4, the crowded-field kernels -------------------------------------

def _crowded_inputs(c, k, dev, seed=0):
    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = min(50, k)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = truth[:n].to(dev)[None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    if k > n:
        theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
        theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    p = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(min(30, k), k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    return cfg, img.to(dev), theta, p, mask


def _spacings(x, n=8):
    return n * float(np.spacing(np.float32(x.abs().max().item())))


@pytest.mark.parametrize("grad_in", [False, True])
@pytest.mark.parametrize("n_steps", [0, 1])
@pytest.mark.parametrize("per_chain", [False, True])
def test_crowded_leapfrog_kernel_matches_plain(dev, per_chain, n_steps, grad_in):
    """B5 at the crowded field (K = 50, 128x128) against its plain version;
    U is a sum of order 7e5, so its bound adds eight float32 spacings."""
    from starcat_torch import fused_leapfrog_crowded as flc

    cfg, img, theta, p, mask_c = _crowded_inputs(64, 50, dev)
    mask = mask_c if per_chain else torch.ones(50, device=dev)
    p = p * mask[..., None] if per_chain else p
    eps = torch.full((64,), 0.002, device=dev)
    inv_mass = torch.full((50, 3), 0.9, device=dev)
    ref = lambda n, g: fl.fused_leapfrog_reference(  # noqa: E731
        cfg.scene, img, cfg.prior, theta, p, eps, inv_mass, mask, n, g)
    grad = ref(0, None)[3] if grad_in else None
    want = ref(n_steps, grad)
    out = flc.make_fused_leapfrog(cfg.scene, img, cfg.prior, 50, n_steps)(
        theta, p, eps, inv_mass, mask, grad=grad)
    torch.cuda.synchronize()
    assert float((out[0] - want[0]).abs().max()) <= TOL["theta"]
    assert float((out[1] - want[1]).abs().max()) <= TOL["p"]
    assert float((out[2] - want[2]).abs().max()) <= TOL["u"] + _spacings(want[2])
    assert float(((out[3] - want[3]).abs() / (1 + want[3].abs())).max()) <= TOL["grad_rel"]
    if per_chain:
        dead = mask == 0
        assert torch.equal(out[0][dead], theta[dead]) and bool((out[3][dead] == 0).all())


@pytest.mark.parametrize("beta", [0.3, 1.0])
def test_crowded_rhmc_kernel_matches_plain(dev, beta):
    """B4 at the cfg4 mutation shape (K = 64, 128x128, 6 x 4, per-particle
    masks) against its plain version on the chains whose fixed points
    converged tightly in both; p relative to 1 + |p| (p = sqrt(g) xi
    reaches 1e3 here), h with eight float32 spacings."""
    cfg, img, theta, xi, mask = _crowded_inputs(32, 64, dev, seed=1)
    eps = torch.full((32,), 0.05, device=dev)
    _check_crowded_rhmc(cfg.scene, img, cfg.prior, theta, xi, eps, mask, beta)


def _check_crowded_rhmc(spec, img, prior, theta, xi, eps, mask, beta, min_tight=0.8):
    """B4 (6 x 4) against its plain version: solver verdicts equal, at least
    a min_tight share of the chains converged tightly in both, and on those
    theta, p relative to 1 + |p| and the energies with eight float32
    spacings; dead slots frozen."""
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    k = theta.shape[1]
    out = frdc.make_fused_rhmc_diag(spec, img, prior, k, 6, 4)(
        theta, xi, eps, mask, torch.tensor(beta, device=img.device))
    ref = frd.fused_rhmc_diag_reference(spec, img, prior, theta, xi, eps, mask, beta, 6, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= min_tight * theta.shape[0]
    o, r = [a[tight] for a in out], [b[tight] for b in ref]
    assert float((o[0] - r[0]).abs().max()) <= RTOL["theta"]
    assert float(((o[1] - r[1]).abs() / (1 + r[1].abs())).max()) <= RTOL["p"]
    for a, b in zip(o[2:5], r[2:5]):
        assert float((a - b).abs().max()) <= RTOL["h"] + _spacings(b)
    live = mask if mask.ndim == 2 else mask.expand(theta.shape[:2])
    dead = (live == 0) & (out[5] < 0.05)[:, None]
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[1][dead] == 0).all())


@pytest.mark.parametrize("h,w,k", [(96, 128, 37), (100, 84, 50)])
def test_crowded_rhmc_kernel_on_ragged_scenes(dev, h, w, k):
    """B4 on scenes that are neither square nor multiples of its tiles, with
    catalog sizes that are not multiples of its star tiles: the crowded
    image cut to h x w, its true stars inside the cut in the first slots,
    per-chain masks with 30..k live stars in shuffled slots."""
    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    spec = cfg.scene._replace(height=h, width=w)
    x = cfg.scene.width * torch.sigmoid(truth[:, 0])
    y = cfg.scene.height * torch.sigmoid(truth[:, 1])
    inside = (x < w - 2.0) & (y < h - 2.0)
    xs, ys = x[inside] / w, y[inside] / h
    cut = torch.stack([torch.log(xs / (1 - xs)), torch.log(ys / (1 - ys)),
                       truth[inside, 2]], dim=1)[:k].to(dev)
    c, n = 32, min(k, cut.shape[0])
    gen = torch.Generator(device=dev).manual_seed(5)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = cut[:n][None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
    theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(30, k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    eps = torch.full((c,), 0.04, device=dev)
    _check_crowded_rhmc(spec, img[:h, :w].contiguous().to(dev), cfg.prior, theta, xi, eps,
                        mask, 1.0)


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_crowded_rhmc_kernel_with_scattered_live_stars(dev, form):
    """B4 at cfg4's shape when the live stars are not contiguous: a shared
    mask alive on two slots of every three, or per-chain masks alive on
    the even slots of even chains and the odd slots of odd chains."""
    cfg, img, theta, xi, _ = _crowded_inputs(32, 64, dev, seed=2)
    slot = torch.arange(64, device=dev)
    if form == "shared":
        mask = (slot % 3 != 1).to(torch.float32)
    else:
        chain = torch.arange(32, device=dev)[:, None]
        mask = ((slot[None] + chain) % 2 == 0).to(torch.float32)
    eps = torch.full((32,), 0.05, device=dev)
    _check_crowded_rhmc(cfg.scene, img, cfg.prior, theta, xi, eps, mask, 1.0)


def test_crowded_launch_counts(dev):
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    cfg, img, theta, p, mask = _crowded_inputs(8, 64, dev)
    flc.reset_launch_counts()
    frdc.reset_launch_counts()
    flc.make_fused_leapfrog(cfg.scene, img, cfg.prior, 64, 2)(
        theta, p, 0.001, torch.ones((64, 3), device=dev), mask)
    traj = frdc.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 64, 1, 1)
    traj(theta, p, 0.01, mask)
    traj(theta, p, 0.01, mask, 0.5)
    assert (flc.LAUNCHES, frdc.LAUNCHES) == (1, 2)


@pytest.mark.parametrize("over,kernel,traj", [
    ({"smc.n_particles": 256, "smc.max_steps": 2}, "rhmc_diag_cuda", "B4"),
    ({"scene.height": 192, "scene.width": 192, "n_stars": 112, "kmax": 125,
      "smc.n_particles": 256, "smc.max_steps": 2}, "rhmc_diag_cuda", "B4"),
    ({"scene.height": 192, "scene.width": 192, "n_stars": 112, "kmax": 112, "head": "chees",
      "n_chains": 64, "n_warmup": 20, "n_samples": 10, "chees.max_leapfrog": 32},
     "cuda_fused", "B5"),
    ({"head": "hmc", "kmax": 50, "n_chains": 64, "n_warmup": 20, "n_samples": 10},
     "cuda_fused", "B5"),
    ({"head": "rhmc", "rhmc.metric": "diag", "kmax": 50, "n_chains": 32, "n_warmup": 10,
      "n_samples": 5}, "rhmc_diag_cuda", "B4"),
])
def test_crowded_heads_run_through_b4_and_b5(dev, over, kernel, traj):
    from starcat_torch.configs import apply_overrides

    out = api.sample(apply_overrides(CONFIGS["cfg4_crowded"], over), dev, seed=1)
    assert out.stats["kernel"] == kernel and out.stats["trajectory_kernel"] == traj
    assert out.stats["kernel_launches"] > 0 and np.isfinite(out.thetas).all()


def test_crowded_dyn_leapfrog_reads_the_device_step_count(dev):
    """B2's contract on B5 (ChEES on crowded fields) at K = 50, 128x128: the
    step count read from a device int32, two counts, against the plain
    version; U with eight float32 spacings."""
    from starcat_torch import fused_leapfrog_crowded as flc

    cfg, img, theta, p, _ = _crowded_inputs(64, 50, dev, seed=3)
    mask = torch.ones(50, device=dev)
    eps = torch.full((64,), 0.002, device=dev)
    inv_mass = torch.full((50, 3), 0.9, device=dev)
    dyn = flc.make_fused_leapfrog_dyn(cfg.scene, img, cfg.prior, 50)
    grad = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                       mask, 0)[3]
    n_dev = torch.full((1,), 3, dtype=torch.int32, device=dev)
    flc.reset_launch_counts()
    for n in (3, 7):
        n_dev.fill_(n)  # on the device, no host round trip
        out = dyn(theta, p, eps, inv_mass, mask, n_dev, grad)
        want = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps,
                                           inv_mass, mask, n, grad)
        torch.cuda.synchronize()
        assert float((out[0] - want[0]).abs().max()) <= TOL["theta"]
        assert float((out[1] - want[1]).abs().max()) <= TOL["p"]
        assert float((out[2] - want[2]).abs().max()) <= TOL["u"] + _spacings(want[2])
        assert float(((out[3] - want[3]).abs() / (1 + want[3].abs())).max()) <= TOL["grad_rel"]
    assert flc.LAUNCHES == 2


def test_chees_on_a_crowded_scene_runs_through_b5(dev):
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS["cfg4_crowded"], {
        "head": "chees", "kmax": 50, "n_chains": 64, "n_warmup": 30, "n_samples": 10})
    flc.reset_launch_counts()
    out = api.sample(cfg, dev, seed=1)
    st = out.stats
    assert st["kernel"] == "cuda_fused" and st["trajectory_kernel"] == "B5"
    assert st["kernel_launches"] > 0 and flc.LAUNCHES == st["kernel_launches"]
    assert np.isfinite(out.thetas).all() and out.thetas.shape == (64, 10, 50, 3)


# -- B5's block GEMMs and B3's tiles at their edges ----------------------------

def _b5_errors(out, want):
    th, p, u, g = (o.double() for o in out)
    return {"theta": float((th - want[0]).abs().max()), "p": float((p - want[1]).abs().max()),
            "u": float((u - want[2]).abs().max()),
            "grad_rel": float(((g - want[3]).abs() / (1 + want[3].abs())).max())}


def _check_b5(spec, img, prior, theta, p, mask, n_steps=3):
    """B5 against its plain version: within TOL (U with eight float32
    spacings), or, where float32 rounding grows along the trajectory, no
    farther from a float64 run of the plain version than the float32 plain
    version is, plus TOL; dead slots frozen with zero gradient."""
    from starcat_torch import fused_leapfrog_crowded as flc

    c, k = theta.shape[:2]
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    p = p * live[..., None]
    eps = torch.full((c,), 0.002, device=theta.device)
    inv_mass = torch.full((k, 3), 0.9, device=theta.device)
    fused = flc.make_fused_leapfrog(spec, img, prior, k, n_steps)
    out = fused(theta, p, eps, inv_mass, mask)
    want = fl.fused_leapfrog_reference(spec, img, prior, theta, p, eps, inv_mass, mask,
                                       n_steps, None)
    want64 = fl.fused_leapfrog_reference(spec, img.double(), prior, theta.double(), p.double(),
                                         eps.double(), inv_mass.double(), mask.double(),
                                         n_steps, None)
    torch.cuda.synchronize()
    tol = dict(TOL, u=TOL["u"] + _spacings(want[2]))
    errs, far, near = _b5_errors(out, want), _b5_errors(out, want64), _b5_errors(want, want64)
    for name, e in errs.items():
        assert e <= tol[name] or far[name] <= near[name] + tol[name], (name, e, far, near)
    dead = live == 0
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[3][dead] == 0).all())
    return fused, (theta, p, eps, inv_mass, mask), out


@pytest.mark.parametrize("h,w,k", [(96, 128, 37), (100, 84, 50), (64, 64, 30), (20, 48, 7),
                                   (32, 32, 20), (32, 32, 128), (5, 3, 2)])
def test_crowded_leapfrog_kernel_on_ragged_scenes(dev, h, w, k):
    """B5 on scenes that are neither square nor multiples of its tiles,
    with catalog sizes that are not multiples of its star groups, per-chain
    masks with 1..K live stars in shuffled slots, in each of its three
    tiles (one warp a chain at 32 pixels a side, with K = 128 more state
    than it has threads; four at 64; sixteen at 128): the layout the tile
    gives, and the same bits on a rerun and for a chain alone."""
    from starcat_torch import fused_leapfrog_crowded as flc

    spec, prior, img, theta, xi, _, mask = _cut_scene(h, w, k, 32, dev, seed=8)
    fused, args, full = _check_b5(spec, img, prior, theta, xi, mask)
    side = 32 if max(h, w) <= 32 else 64 if max(h, w) <= 64 else 128
    assert flc.launch_layout(1024, k, h, w)["threads"] == side * side // 32
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(*args)))
    th, pp, eps, im, m = args
    sel = torch.tensor([7], device=dev)
    part = fused(th[sel].contiguous(), pp[sel].contiguous(), eps[sel].contiguous(), im,
                 m[sel].contiguous())
    assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))


@pytest.mark.parametrize("k", [1, 128])
def test_crowded_leapfrog_kernel_at_one_star_and_the_domain_edge(dev, k):
    """One star, and the largest catalog B5 takes (K = 128 at 128x128,
    every star of the tile's shared memory)."""
    cfg, img, theta, p, _ = _crowded_inputs(32, k, dev, seed=9)
    _check_b5(cfg.scene, img, cfg.prior, theta, p, torch.ones(k, device=dev))


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_crowded_leapfrog_kernel_with_scattered_live_stars(dev, form):
    """B5 at the crowded field when the live stars are not contiguous: a
    shared mask alive on two slots of every three, or per-chain masks alive
    on the even slots of even chains and the odd slots of odd chains."""
    cfg, img, theta, p, _ = _crowded_inputs(32, 50, dev, seed=10)
    slot = torch.arange(50, device=dev)
    if form == "shared":
        mask = (slot % 3 != 1).to(torch.float32)
    else:
        mask = ((slot[None] + torch.arange(32, device=dev)[:, None]) % 2 == 0).to(torch.float32)
    _check_b5(cfg.scene, img, cfg.prior, theta, p, mask)


def _bits(t):  # NaN (a blown-up chain) equals itself bit for bit
    return t.view(torch.int32)


def test_crowded_leapfrog_kernel_is_deterministic(dev):
    """B5 gives the same bits on a rerun, and a chain the same bits alone,
    among 7 others or among all 32 in another order: its sums run in a
    fixed order, and a block holds one chain."""
    cfg, img, theta, p, mask = _crowded_inputs(32, 50, dev, seed=11)
    fused, args, full = _check_b5(cfg.scene, img, cfg.prior, theta, p, mask, n_steps=5)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(*args)))
    th, pp, eps, im, m = args
    for idx in ([5], [0, 3, 9, 14, 20, 25, 31], list(range(31, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(th[sel].contiguous(), pp[sel].contiguous(), eps[sel].contiguous(), im,
                     m[sel].contiguous())
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))


# -- B5 and B4 beyond their one-tile domains (the wide paths) ---------------

def _wide_inputs(h, w, k, c, dev, seed):
    """A drawn h x w field at cfg4's star density, theta near its truth in
    the first slots (prior-like draws in the rest), standard-normal xi and
    per-chain masks with 1..k live stars in shuffled slots."""
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS["cfg4_crowded"], {
        "scene.height": h, "scene.width": w, "n_stars": max(1, round(50 * h * w / 16384))})
    truth, img = cfg.make_data()
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = min(k, truth.shape[0])
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = truth[:n].to(dev)[None] + 0.02 * torch.randn((c, n, 3), generator=gen,
                                                                  device=dev)
    theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
    theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(1, k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    return cfg.scene, cfg.prior, img.to(dev), theta, xi, mask


@pytest.mark.parametrize("h,w,k", [(136, 18, 6), (18, 136, 5), (16, 12, 130), (200, 136, 40),
                                   (128, 128, 300)])
def test_wide_leapfrog_kernel_matches_plain(dev, h, w, k):
    """B5's wide path (a side above 128 pixels, or K above 128) against its
    plain version as _check_b5 holds the one-tile path, per-chain masks and
    shared, and the same bits for a chain alone."""
    from starcat_torch import fused_leapfrog_crowded as flc

    assert not flc.one_tile(k, h, w)
    spec, prior, img, theta, xi, mask = _wide_inputs(h, w, k, 8, dev, seed=20)
    fused, args, full = _check_b5(spec, img, prior, theta, xi, mask)
    _check_b5(spec, img, prior, theta, xi, torch.ones(k, device=dev))
    assert flc.launch_layout(8, k, h, w)["threads"] == 512
    th, pp, eps, im, m = args
    sel = torch.tensor([3], device=dev)
    part = fused(th[sel].contiguous(), pp[sel].contiguous(), eps[sel].contiguous(), im,
                 m[sel].contiguous())
    assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))


@pytest.mark.parametrize("h,w,k", [(136, 18, 6), (18, 136, 5), (16, 12, 130), (200, 136, 40),
                                   (128, 128, 100)])
def test_wide_rhmc_kernel_matches_plain(dev, h, w, k):
    """B4's wide path against its plain version as _check_crowded_rhmc
    holds the one-tile path (beta 0.7 from a device scalar), at a step
    where 80% of the chains' fixed points converge tightly even with 130
    stars on 16x12 (at 0.02 there 9 of 16 do not, in both versions)."""
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    assert not frdc.one_tile(k, h, w)
    spec, prior, img, theta, xi, mask = _wide_inputs(h, w, k, 16, dev, seed=21)
    eps = torch.full((16,), 0.005, device=dev)
    _check_crowded_rhmc(spec, img, prior, theta, xi, eps, mask, 0.7)


@pytest.mark.parametrize("h,w,k,c,step", [(16, 12, 130, 64, 0.02), (192, 192, 125, 32, 0.05)])
def test_wide_rhmc_kernel_at_the_steps_cfg4_reaches(dev, h, w, k, c, step):
    """B4's wide path against its plain version at the steps cfg4's
    mutation takes (0.04-0.06 at 4096 particles; 0.02 on 130 stars packed
    into 16x12), up to 130 live stars.  There the diagonal metric's fixed
    points miss TIGHT on many chains in both versions alike (the plain
    version on the CPU: 32-38 of 64 tight at 16x12, 7-10 of 16 at
    192x192), so solver verdicts must agree on every chain and at least a
    quarter of the chains be tight, and those are held as
    _check_crowded_rhmc holds them."""
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    assert not frdc.one_tile(k, h, w)
    spec, prior, img, theta, xi, mask = _wide_inputs(h, w, k, c, dev, seed=21)
    assert int(mask.sum(1).max()) >= 120
    eps = torch.full((c,), step, device=dev)
    _check_crowded_rhmc(spec, img, prior, theta, xi, eps, mask, 0.7, min_tight=0.25)


def test_wide_paths_are_deterministic_and_counted(dev):
    """At the slice's 192x192 field (K = 125): a rerun and a chain alone
    give the same bits on both wide paths, one launch a call each."""
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    spec, prior, img, theta, xi, mask = _wide_inputs(192, 192, 125, 6, dev, seed=22)
    p = xi * mask[..., None]
    im = torch.full((125, 3), 0.9, device=dev)
    flc.reset_launch_counts()
    frdc.reset_launch_counts()
    for fused, args in ((flc.make_fused_leapfrog(spec, img, prior, 125, 3),
                         (theta, p, torch.full((6,), 0.002, device=dev), im, mask)),
                        (frdc.make_fused_rhmc_diag(spec, img, prior, 125, 2, 2),
                         (theta, xi, torch.full((6,), 0.02, device=dev), mask))):
        full = fused(*args)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(full, fused(*args)))
        sel = torch.tensor([4], device=dev)
        part = fused(*(a if a is im else a[sel].contiguous() for a in args))
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, full))
    assert (flc.LAUNCHES, frdc.LAUNCHES) == (3, 3)


def _check_b3(spec, prior, img, theta, xi, eps, mask, beta=0.7, n_steps=6, fpi=4):
    """B3 against its plain version chain by chain: solver verdicts equal,
    and on the chains whose fixed points converged tightly in both every
    output within RTOL (h with four float32 spacings); dead slots frozen."""
    from starcat_torch import fused_rhmc_diag as frd

    c, k = theta.shape[:2]
    fused = frd.make_fused_rhmc_diag(spec, img, prior, k, n_steps, fpi)
    out = fused(theta, xi, eps, mask, torch.tensor(beta, device=img.device))
    ref = frd.fused_rhmc_diag_reference(spec, img, prior, theta, xi, eps, mask, beta, n_steps,
                                        fpi)
    torch.cuda.synchronize()
    assert torch.equal(out[5] < 0.05, ref[5] < 0.05)
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    assert int(tight.sum()) >= max(1, int(0.8 * c))
    _assert_rhmc_close([o[tight] for o in out], [r[tight] for r in ref])
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    dead = (live == 0) & (out[5] < 0.05)[:, None]
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[1][dead] == 0).all())
    return fused, out


@pytest.mark.parametrize("c,k,h,w", [
    (1, 16, 32, 32),     # one chain
    (7, 16, 32, 32),     # an odd chain count
    (33, 1, 32, 32),     # one star
    (9, 16, 48, 48),     # the 48-row tile at the edge of the domain
    (16, 16, 40, 48),    # a non-square scene in the 48-row tile
    (16, 10, 24, 96),    # a wide scene in the 32-row tile
    (16, 10, 96, 24),    # a tall scene, held transposed
])
def test_rhmc_kernel_at_the_edges_of_its_tiles(dev, c, k, h, w):
    """B3 where its layout and tiles are most at risk, chain by chain."""
    if (h, w) == (32, 32):
        cfg, img, theta, xi, eps, mask = _rhmc_inputs(c, k, dev, k >= 6, seed=12)
        spec, prior = cfg.scene, cfg.prior
    else:
        spec, prior, img, theta, xi, eps, mask = _cut_scene(h, w, k, c, dev, seed=12)
    _check_b3(spec, prior, img, theta, xi, eps, mask)


def test_rhmc_kernel_with_scattered_dead_slots(dev):
    """Per-chain masks alive on the even slots of even chains and the odd
    slots of odd chains."""
    cfg, img, theta, xi, eps, _ = _rhmc_inputs(32, 16, dev, True, seed=13)
    slot = torch.arange(16, device=dev)
    mask = ((slot[None] + torch.arange(32, device=dev)[:, None]) % 2 == 0).to(torch.float32)
    _check_b3(cfg.scene, cfg.prior, img, theta, xi, eps, mask, beta=1.0)


def test_rhmc_kernel_gives_a_chain_the_same_bits_at_any_chain_count(dev):
    """One layout, 256 threads a chain, at every chain count: a launch of
    as many chains as the card has SMs and one of one more give a chain the
    same bits, and so do a rerun and a chain alone or among others."""
    from starcat_torch import fused_rhmc_diag as frd

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert frd.launch_layout(sms, 10, 32, 32)["threads"] == 256
    assert frd.launch_layout(sms + 1, 10, 32, 32)["threads"] == 256
    cfg, img, theta, xi, eps, mask = _rhmc_inputs(sms + 1, 10, dev, False, seed=14)
    fused = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, 10, 16, 6)
    wide = fused(theta[:sms].contiguous(), xi[:sms].contiguous(), eps[:sms].contiguous(), mask)
    narrow = fused(theta, xi, eps, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b[:sms])) for a, b in zip(wide, narrow))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(narrow, fused(theta, xi, eps, mask)))
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(sms - 1, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(), mask)
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, wide))


# -- B1/B2: a chain a warp (two at the 32-column tile), compile-time tiles ----

def _check_b1(spec, img, prior, theta, p, mask, n_steps=10, dyn=False):
    """B1 (B2 with ``dyn``: the count from a device int32) against its plain
    version: within TOL (U with eight float32 spacings) or, where float32
    rounding grows along the trajectory, no farther from a float64 run of
    the plain version than the float32 plain version is, plus TOL; dead
    slots frozen with zero gradient.  Returns the call and its output."""
    c, k = theta.shape[:2]
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    p = p * live[..., None]
    eps = torch.full((c,), 0.002, device=theta.device)
    inv_mass = torch.full((k, 3), 0.9, device=theta.device)
    if dyn:
        n_dev = torch.full((1,), n_steps, dtype=torch.int32, device=theta.device)
        kern = fl.make_fused_leapfrog_dyn(spec, img, prior, k)
        fused = lambda th, pp, e, im, m: kern(th, pp, e, im, m, n_dev, None)  # noqa: E731
    else:
        fused = fl.make_fused_leapfrog(spec, img, prior, k, n_steps)
    out = fused(theta, p, eps, inv_mass, mask)
    want = fl.fused_leapfrog_reference(spec, img, prior, theta, p, eps, inv_mass, mask,
                                       n_steps, None)
    want64 = fl.fused_leapfrog_reference(spec, img.double(), prior, theta.double(), p.double(),
                                         eps.double(), inv_mass.double(), mask.double(),
                                         n_steps, None)
    torch.cuda.synchronize()
    tol = dict(TOL, u=TOL["u"] + _spacings(want[2]))
    errs, far, near = _b5_errors(out, want), _b5_errors(out, want64), _b5_errors(want, want64)
    for name, e in errs.items():
        assert e <= tol[name] or far[name] <= near[name] + tol[name], (name, e, far, near)
    dead = live == 0
    assert torch.equal(out[0][dead], theta[dead]) and bool((out[3][dead] == 0).all())
    return fused, (theta, p, eps, inv_mass, mask), out


@pytest.mark.parametrize("c", ["1", "7", "sms", "sms+1"])
def test_b1_kernel_at_the_edges_of_its_layout(dev, c):
    """One chain, an odd count (a block of four chains part empty), the
    card's SM count of chains and one more, on the flagship scene."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"1": 1, "7": 7, "sms": sms, "sms+1": sms + 1}[c]
    cfg, img, theta, p, _, _ = _inputs("cfg6_chees", n, dev, seed=15)
    _check_b1(cfg.scene, img, cfg.prior, theta, p, torch.ones(cfg.kmax, device=dev))


@pytest.mark.parametrize("h,w,k", [
    (16, 16, 1),     # cfg0's shape: the 16-column tile, one star (a pad of 4)
    (48, 48, 16),    # the 48-column tile at the edge of the domain
    (40, 48, 16),    # a non-square scene in the 48-column tile
    (20, 48, 16),    # rows not a multiple of the register tile
    (24, 96, 16),    # wider than 48 columns: held transposed, two chunks of rows
    (96, 24, 16),    # taller than a chunk of row profiles
    (9, 13, 5),      # ragged everywhere, a pad of 8
])
def test_b1_kernel_at_the_edges_of_its_tiles(dev, h, w, k):
    """B1 where its tiles are most at risk, per-chain masks with 1..K live
    stars in shuffled slots."""
    spec, prior, img, theta, xi, _, mask = _cut_scene(h, w, k, 24, dev, seed=16)
    assert fl.launch_tile(h, w, k)["transposed"] == (w > 48)
    _check_b1(spec, img, prior, theta, xi, mask)


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b1_kernel_with_scattered_dead_slots(dev, form):
    """A shared mask alive on two slots of every three, or per-chain masks
    alive on the even slots of even chains and the odd of odd ones."""
    cfg, img, theta, p, _, _ = _inputs("cfg6_chees", 32, dev, seed=17)
    slot = torch.arange(cfg.kmax, device=dev)
    if form == "shared":
        mask = (slot % 3 != 1).to(torch.float32)
    else:
        mask = ((slot[None] + torch.arange(32, device=dev)[:, None]) % 2 == 0).to(torch.float32)
    _check_b1(cfg.scene, img, cfg.prior, theta, p, mask)


@pytest.mark.parametrize("n", [0, 512])
def test_b2_kernel_reads_zero_and_a_long_count_from_the_device(dev, n):
    """B2's step count from a device int32: 0 returns (U, grad U) at theta;
    512 steps on the flagship's whole catalog, as ChEES runs it."""
    cfg, img, theta, p, _, _ = _inputs("cfg6_chees", 64, dev, seed=18)
    _, _, out = _check_b1(cfg.scene, img, cfg.prior, theta, p,
                          torch.ones(cfg.kmax, device=dev), n_steps=n, dyn=True)
    if n == 0:
        assert torch.equal(out[0], theta)


def test_b1_kernel_gives_a_chain_the_same_bits_at_any_chain_count(dev):
    """A chain's bits do not depend on the chain count (the SM count and
    one more), a rerun, or its place among other chains (alone, among 7,
    or all in reverse order)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg6_chees", sms + 1, dev, seed=19)
    mask = torch.ones(cfg.kmax, device=dev)
    fused = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 10)
    narrow = fused(theta, p, eps, inv_mass, mask)
    wide = fused(theta[:sms].contiguous(), p[:sms].contiguous(), eps[:sms].contiguous(),
                 inv_mass, mask)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b[:sms])) for a, b in zip(wide, narrow))
    assert all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(narrow, fused(theta, p, eps, inv_mass, mask)))
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(sms, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), p[sel].contiguous(), eps[sel].contiguous(),
                     inv_mass, mask)
        assert all(torch.equal(_bits(a), _bits(b[sel])) for a, b in zip(part, narrow))


@pytest.mark.parametrize("h,w,k", [(32, 32, 10), (16, 16, 1), (48, 48, 16), (24, 96, 16)])
def test_b1_launch_layout_follows_the_tile(dev, h, w, k):
    """The build's layout is the one the wrapper mirrors: warps a chain by
    the column tile, CHAINS_PER_BLOCK chains a block, and at 1024 chains
    every SM holds its share of the chains at once."""
    lay = fl.launch_layout(1024, k, h, w)
    tile = fl.launch_tile(h, w, k)
    assert lay["warps_per_chain"] == tile["warps_per_chain"]
    assert lay["threads"] == 32 * tile["warps_per_chain"] * fl.CHAINS_PER_BLOCK
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lay["blocks_per_sm"] * sms * fl.CHAINS_PER_BLOCK >= 1024


# -- the NUTS and ADVI heads on B1: one step with a signed eps, and n_steps = 0 --

def test_b1_leaf_with_signed_per_chain_eps(dev):
    """A NUTS leaf: one step of B1 at cfg2's shape (1024 chains), half the
    chains stepping backward, against the plain version (TOL, U with eight
    float32 spacings) and against float64 (no farther than the float32 plain
    version, plus TOL)."""
    cfg, img, theta, p, eps, inv_mass = _inputs("cfg2_nuts", 1024, dev, seed=21)
    eps = torch.where(torch.arange(1024, device=dev) % 2 == 0, eps, -eps)
    mask = torch.ones(cfg.kmax, device=dev)
    grad = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                       mask, 0)[3]
    fl.reset_launch_counts()
    out = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 1)(
        theta, p, eps, inv_mass, mask, grad=grad)
    want = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                       mask, 1, grad)
    want64 = fl.fused_leapfrog_reference(cfg.scene, img.double(), cfg.prior, theta.double(),
                                         p.double(), eps.double(), inv_mass.double(),
                                         mask.double(), 1, grad.double())
    torch.cuda.synchronize()
    assert fl.STATIC_LAUNCHES == 1
    tol = dict(TOL, u=TOL["u"] + _spacings(want[2]))
    assert float((out[0] - want[0]).abs().max()) <= tol["theta"]
    assert float((out[1] - want[1]).abs().max()) <= tol["p"]
    assert float((out[2] - want[2]).abs().max()) <= tol["u"]
    assert float(((out[3] - want[3]).abs() / (1 + want[3].abs())).max()) <= tol["grad_rel"]
    far, near = _b5_errors(out, want64), _b5_errors(want, want64)
    for name, f in far.items():
        assert f <= near[name] + tol[name], (name, f, near)
    # the backward chains moved against their momentum
    back = eps < 0
    step = (out[0] - theta)[back]
    assert float((step * p[back]).sum()) < 0


def test_b1_at_zero_steps_is_advis_gradient(dev):
    """ADVI's gradient: B1 at n_steps = 0 on an 8-draw batch at cfg7's shape
    returns theta and p unchanged and (U, grad U) of the plain potential."""
    from starcat_torch import dispatch

    cfg, img, theta, p, eps, inv_mass = _inputs("cfg7_advi", 8, dev, seed=22)
    mask = torch.ones(cfg.kmax, device=dev)
    fl.reset_launch_counts()
    u, g = dispatch.make_grad_fn(cfg.scene, img, cfg.prior, mask)(theta)
    out = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 0)(
        theta, p, eps, inv_mass, mask)
    want = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                       mask, 0)
    torch.cuda.synchronize()
    assert fl.STATIC_LAUNCHES == 2
    assert torch.equal(out[0], theta) and torch.equal(out[1], p)
    assert torch.equal(u, out[2]) and torch.equal(g, out[3])
    assert float((u - want[2]).abs().max()) <= TOL["u"] + _spacings(want[2])
    assert float(((g - want[3]).abs() / (1 + want[3].abs())).max()) <= TOL["grad_rel"]


@pytest.mark.parametrize("name,over", [
    ("cfg2_nuts", {"n_chains": 64, "n_warmup": 20, "n_samples": 10, "nuts.max_depth": 6}),
    ("cfg7_advi", {"advi.n_steps": 200}),
    ("cfg7_advi", {"advi.n_steps": 100, "advi.full_rank": True}),
])
def test_nuts_and_advi_run_through_b1(dev, name, over):
    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(CONFIGS[name], over)
    fl.reset_launch_counts()
    out = api.sample(cfg, dev, seed=1)
    st = out.stats
    assert st["kernel"] == "cuda_fused" and st["trajectory_kernel"] == "B1"
    assert st["kernel_launches"] > 0 and fl.STATIC_LAUNCHES == st["kernel_launches"]
    assert np.isfinite(out.thetas).all()
    if cfg.head == "advi":
        calls = 2 if cfg.advi.full_rank else 1   # the full-rank trace evaluates again
        assert st["kernel_launches"] == calls * cfg.advi.n_steps
        assert out.thetas.shape == (api.ADVI_DRAWS, 1, cfg.kmax, 3)
    else:
        assert out.thetas.shape == (cfg.n_chains, cfg.n_samples, cfg.kmax, 3)
        assert 0.3 < st["accept"] <= 1.0


# ---- durability: blocked sampling and a SIGKILLed run resumed, on the card ----


def _kill_on_the_card(config, over, ckpt):
    """tests/torch_fault_worker.py's crash-api leg on the card: the run dies
    at its third block's record (SMC: its fourth step's)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    over_arg = ",".join(f"{k}={v}" for k, v in over.items())
    return subprocess.run([sys.executable, os.path.join(repo, "tests", "torch_fault_worker.py"),
                           "crash-api", config, over_arg, "cuda", ckpt],
                          capture_output=True, text=True, timeout=600, env=env)


def test_chees_on_b2_blocked_and_resumed_after_sigkill_give_the_same_bits(dev, tmp_path):
    """cfg6 at 256 chains on B2: blocks of 10 with checkpoints give the
    unblocked run's draws, and a run SIGKILLed after two blocks' checkpoints
    resumes to its last 20 draws, bit for bit."""
    import signal

    from starcat_torch.configs import apply_overrides

    over = {"n_chains": 256, "n_warmup": 60, "n_samples": 40}
    cfg = apply_overrides(CONFIGS["cfg6_chees"], over)
    one = api.sample(cfg, dev, seed=0)
    blocked = api.sample(cfg, dev, seed=0, checkpoint_path=str(tmp_path / "a.ck"),
                         metrics_path=str(tmp_path / "a.jsonl"))
    assert blocked.stats["trajectory_kernel"] == "B2" and blocked.stats["kernel_launches"] > 0
    np.testing.assert_array_equal(blocked.thetas, one.thetas)
    ckpt = str(tmp_path / "killed.ck")
    r = _kill_on_the_card("cfg6_chees", over, ckpt)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    rest = api.sample(cfg, dev, seed=0, checkpoint_path=ckpt, resume=True)
    assert rest.thetas.shape[1] == 20
    np.testing.assert_array_equal(rest.thetas, one.thetas[:, 20:])


def test_smc_on_b6_resumed_after_sigkill_gives_the_same_bits(dev, tmp_path):
    """cfg3 at 512 particles on B6, killed after three temperature steps'
    checkpoints: the resumed pass ends at the uninterrupted pass's beta,
    log Z and population, bit for bit; so does a pass without checkpoints."""
    import signal

    from starcat_torch.configs import apply_overrides

    over = {"smc.n_particles": 512, "smc.max_steps": 6}
    cfg = apply_overrides(CONFIGS["cfg3_transdim_smc"], over)
    full = api.sample(cfg, dev, seed=0, checkpoint_path=str(tmp_path / "a.ck"))
    again = api.sample(cfg, dev, seed=0)
    assert full.stats["kernel"] == "rhmc_cuda" and full.stats["n_temp_steps"] == 6
    ckpt = str(tmp_path / "killed.ck")
    r = _kill_on_the_card("cfg3_transdim_smc", over, ckpt)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    assert int(torch.load(ckpt, weights_only=True)["state.n_steps"]) == 3
    rest = api.sample(cfg, dev, seed=0, checkpoint_path=ckpt, resume=True)
    for out in (again, rest):
        np.testing.assert_array_equal(out.thetas, full.thetas)
        np.testing.assert_array_equal(out.masks, full.masks)
        assert out.stats["log_z"] == full.stats["log_z"] and out.stats["beta"] == full.stats["beta"]


def test_a_cuda_checkpoint_does_not_restore_on_the_cpu(dev, tmp_path):
    from starcat_torch.checkpoint import CheckpointError, restore_state, save_state
    from starcat_torch.driver import ChainState, checkpoint_like

    th = torch.zeros((4, 2, 3), device=dev)
    path = str(tmp_path / "cuda_ck")
    save_state(path, checkpoint_like(ChainState(th, torch.zeros(4, device=dev), th),
                                     torch.Generator(device=dev)))
    th_cpu = th.cpu()
    like = checkpoint_like(ChainState(th_cpu, torch.zeros(4), th_cpu), torch.Generator())
    with pytest.raises(CheckpointError, match="cuda_ck.*cuda generator state.*cpu"):
        restore_state(path, like, "cpu")
    back = restore_state(path, checkpoint_like(ChainState(th, torch.zeros(4, device=dev), th),
                                               torch.Generator(device=dev)), dev)
    assert back.states.theta.device.type == "cuda"


# -- the trans-d sweep kernel ---------------------------------------------------


def _sweep_case(name, c, dev, seed=60):
    """chip_smoke.SWEEP_SHAPES' entry ``name`` at c chains."""
    import chip_smoke

    _, preset, over, _, beta = next(e for e in chip_smoke.SWEEP_SHAPES if e[0] == name)
    cfg = chip_smoke.sweep_config(CONFIGS, preset, over)
    return cfg, chip_smoke.sweep_inputs(cfg, c, dev, seed, beta)


# the shapes that walk regions or chunks at 256-301 chains, so that the
# bar's 99.5% leaves room for a decision within float32's rounding of log
# u; 250x240 at phase 6b's own inputs (256 chains), since there the plain
# version's log alpha is itself up to 0.15 off float64
@pytest.mark.parametrize("name,c", [("cfg4", 96), ("cfg3", 301), ("cfg5", 64),
                                    ("cfg4_192", 301), ("cfg4_prior_k100", 257),
                                    ("cfg4_200x136", 301), ("cfg4_250x240", 256)])
def test_sweep_kernel_matches_plain(dev, name, c):
    """The sweep kernel against its plain version on the same inputs and
    draws, at chip_smoke.py phase 6b's bars, one launch a sweep, the same
    bits on a rerun; at the presets' shapes (one region, one chunk) and at
    shapes that walk several regions of the field or chunks of the
    catalog, as the build's layout says."""
    import chip_smoke
    from starcat_torch import fused_transdim_sweep as fts
    from starcat_torch import transdim as td

    cfg, (img, theta, mask, tll, b, tcfg, draws) = _sweep_case(name, c, dev)
    fts.reset_launch_counts()
    out = td.poisson_sweep(theta, mask, tll, b, cfg.prior, cfg.scene, img, tcfg, draws)
    again = td.poisson_sweep(theta, mask, tll, b, cfg.prior, cfg.scene, img, tcfg, draws)
    assert fts.LAUNCHES == 2
    ref = td.poisson_sweep_reference(theta, mask, tll, b, cfg.prior, cfg.scene, img, tcfg, draws)
    spacing = float(np.spacing(np.float32(tll.abs().max().item())))
    chip_smoke._compare_sweep(name, out, ref, draws, spacing)
    for a, r in zip(out[:3] + tuple(out[3]), again[:3] + tuple(again[3])):
        assert torch.equal(a, r)
    h, w, k = cfg.scene.height, cfg.scene.width, cfg.kmax
    lay = fts.launch_layout(c, k, h, w)
    side = lay["region_rows"]
    assert lay["chains_per_block"] * lay["threads_per_chain"] == 256
    assert lay["chunk"] == min(k, 64) and lay["blocks"] == -(-c // lay["chains_per_block"])
    walks = (-(-h // side)) * (-(-w // side)) > 1 or k > 64
    assert walks == (name not in ("cfg4", "cfg3", "cfg5"))


@pytest.mark.parametrize("fused", [True, False])
def test_sweep_kernel_on_smc_steps_counts_its_moves(dev, fused):
    """cfg4's SMC steps on the card run their sweeps on the kernel with
    fused=True, and the program's transdim.kernel_moves equals
    transdim.moves; with fused=False on the plain version, none."""
    from starcat_torch import metrics, smc
    from starcat_torch import fused_transdim_sweep as fts

    cfg = CONFIGS["cfg4_crowded"]
    truth, img = cfg.make_data()
    img = img.to(dev)
    scfg = cfg.smc._replace(n_particles=256)
    gen = torch.Generator(device=dev).manual_seed(3)
    step = smc.make_smc_step(cfg.scene, img, cfg.prior, cfg.kmax, scfg, fused=fused)
    s = smc.init_smc(gen, cfg.scene, img, cfg.prior, cfg.kmax, scfg)
    fts.reset_launch_counts()
    metrics.reset_record()
    with metrics.tracing():
        for _ in range(2):
            s = step(s, smc.draw_step(gen, 256, cfg.kmax, cfg.scene, cfg.prior, scfg, dev))
    counters = metrics.record()["counters"]
    metrics.reset_record()
    moves = 2 * 256 * 12
    assert fts.LAUNCHES == (2 * scfg.n_transdim_sweeps if fused else 0)
    assert counters["transdim.moves"] == moves
    assert counters["transdim.kernel_moves"] == (moves if fused else 0)
    assert torch.isfinite(s.theta).all() and 0.0 < float(s.beta) < 1.0
