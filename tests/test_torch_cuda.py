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
