"""The crowded-field slice of starcat_torch (cfg4_crowded): one cfg4-shaped
SMC temperature step (residual-driven births, the rhmc_diag_pallas
mutation, which the JAX package runs on Pallas B4 in interpret mode below a
64-chain tile) fed the JAX keys' own draws; the choice between the
small-scene and crowded-field kernels; the preset and its scene against the
JAX package's; short cfg4 and crowded-HMC runs through api.sample on the
plain path."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import starcat
from starcat import smc as jsmc
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import api, dispatch, smc
from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch import fused_rhmc_diag_crowded as frdc
from starcat_torch import transdim as ttd
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.convert import (
    prior_from_jax,
    smc_config_from_jax,
    smc_state_from_numpy,
    spec_from_jax,
)
from starcat_torch.potential import PriorSpec, sample_prior
from starcat_torch.scene import SceneSpec

from jax_draws import jax_step_draws

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- one cfg4-shaped temperature step on the JAX keys' own draws --------------

P, K = 16, 4
SPEC_J = starcat.SceneSpec(16, 12, 1.5, 4.0)
PRIOR_J = starcat.PriorSpec(4.0, 0.7)
HW = SPEC_J.height * SPEC_J.width


def test_cfg4_shaped_temperature_step_matches_jax_on_its_draws():
    """One step from the prior population of a 16x12 scene: beta by
    bisection, logZ, resampling, two sweeps with residual-driven births at
    the tempered likelihood, two diagonal-Fisher mutations (the plain B4
    trajectory against Pallas B4 in interpret mode), the eps controller and
    the log-likelihood refresh.  Bounds as tests/test_torch_smc.py's step:
    beta and logZ rtol 1e-5 (float32 sums over the population), theta 1e-4
    (tests/test_pallas_rhmc.py), log-likelihoods rtol 1e-5 with atol 2e-3."""
    truth = starcat.sample_prior(jax.random.key(0), 3, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, SPEC_J)
    cfg_j = jsmc.SMCConfig(n_particles=P, mutation="rhmc_diag_pallas", n_mutation_steps=2,
                           n_leapfrog=3, fixed_point_iters=3, n_transdim_sweeps=2,
                           step_size0=0.05,
                           transdim=JTransDimConfig(lam_count=2.0, birth_proposal="residual"))
    st0 = jsmc.init_smc(jax.random.key(4), SPEC_J, img, PRIOR_J, K, cfg_j)
    st1 = jsmc.make_smc_step(SPEC_J, img, PRIOR_J, cfg_j)(st0)
    cfg = smc_config_from_jax(cfg_j)
    assert cfg.mutation == "rhmc_diag" and cfg.transdim.birth_proposal == "residual"
    tst0 = smc_state_from_numpy(st0.theta, st0.mask, st0.loglik, st0.beta, st0.log_z,
                                st0.eps, st0.n_steps, st0.mean_accept, st0.final_done, "cpu")
    step = smc.make_smc_step(spec_from_jax(SPEC_J), _t(img), prior_from_jax(PRIOR_J), K, cfg)
    tst1 = step(tst0, jax_step_draws(st0.key, cfg_j, K, HW))
    assert float(tst1.beta) == pytest.approx(float(st1.beta), rel=1e-5)
    assert 0.0 < float(tst1.beta) < 1.0
    assert float(tst1.log_z) == pytest.approx(float(st1.log_z), rel=1e-5, abs=1e-3)
    np.testing.assert_array_equal(tst1.mask.numpy(), np.asarray(st1.mask))
    np.testing.assert_allclose(tst1.theta.numpy(), np.asarray(st1.theta), atol=1e-4)
    np.testing.assert_allclose(tst1.loglik.numpy(), np.asarray(st1.loglik), rtol=1e-5, atol=2e-3)
    assert float(tst1.mean_accept) == pytest.approx(float(st1.mean_accept), abs=5e-3)
    assert float(tst1.eps) == pytest.approx(float(st1.eps), rel=1e-4)
    assert 0.0 < float(tst1.mean_accept) <= 1.0
    # the sweeps moved the star counts: births and deaths happened
    assert not np.array_equal(np.asarray(st1.mask).sum(-1), np.asarray(st0.mask).sum(-1))


def test_residual_birth_sweeps_on_their_own_draws_recover_the_prior():
    """The sweeps as run_smc runs them, on the port's own draws (draw_sweep:
    the Gumbel over H*W that picks a residual birth's pixel), with a flat
    likelihood and a residual proposal steered by a bright non-square
    image: the proposal's density cancels in the acceptance only if pixel,
    offset and reverse density agree, so n must stay ~ truncated
    Poisson(Lambda) (pmf within 0.03, as tests/test_transdim.py:73-90),
    the fluxes ~ the prior and the positions uniform over the image (KS
    p > 1e-4), not drawn toward the stars."""
    spec = SceneSpec(16, 12, 1.5, 4.0)
    prior = PriorSpec(3.0, 0.8)
    truth = starcat.sample_prior(jax.random.key(0), 3, starcat.PriorSpec(6.0, 0.2))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = _t(starcat.make_mock_image(jax.random.key(1), x, y, f, SPEC_J))
    kmax, n_chains, n_sweeps, lam = 8, 256, 600, 2.5
    cfg = ttd.TransDimConfig(lam_count=lam, split_sigma=1.0, birth_proposal="residual")
    gen = torch.Generator().manual_seed(3)
    theta = sample_prior(gen, n_chains * kmax, prior, "cpu").reshape(n_chains, kmax, 3)
    mask = torch.zeros((n_chains, kmax))
    mask[:, 0] = 1.0
    ll = torch.zeros(n_chains)
    flat = lambda t, m: torch.zeros(t.shape[0])  # noqa: E731
    ns, pos = [], []
    for i in range(n_sweeps):
        draws = ttd.draw_sweep(gen, n_chains, kmax, spec, prior, cfg, "cpu")
        theta, mask, ll, _ = ttd.transdim_sweep(theta, mask, ll, flat, prior, spec, cfg,
                                                draws, img)
        if i >= 300:
            ns.append(mask.sum(-1))
            if i % 100 == 99:  # snapshots far enough apart to be near independent
                pos.append(theta[mask > 0])
    counts = torch.stack(ns).reshape(-1).long().numpy()
    pmf = stats.poisson.pmf(np.arange(kmax + 1), lam)
    emp = np.bincount(counts, minlength=kmax + 1)[: kmax + 1] / counts.size
    assert np.abs(emp - pmf / pmf.sum()).max() < 0.03, (emp, pmf / pmf.sum())
    alive = torch.cat(pos)
    assert alive.shape[0] > 1500
    for col, args in ((0, ()), (1, ()), (2, (prior.logf_mean, prior.logf_sigma))):
        v = alive[:, col].numpy()
        # logit positions map to uniform on (0, 1) by the logistic function
        sample = 1.0 / (1.0 + np.exp(-v)) if col < 2 else v
        ks = stats.kstest(sample, "uniform" if col < 2 else "norm", args=args)
        assert ks.pvalue > 1e-4, (col, ks)


# -- the kernel choice ---------------------------------------------------------

FLAGSHIP = SceneSpec(32, 32, 1.5, 10.0)
CROWDED = SceneSpec(128, 128, 1.5, 20.0)


@pytest.mark.parametrize("spec,kmax,leapfrog,diag", [
    (FLAGSHIP, 10, "B1", "B3"),
    (FLAGSHIP, 16, "B1", "B3"),
    (SceneSpec(48, 48, 1.5, 10.0), 16, "B1", "B3"),
    (FLAGSHIP, 17, "B5", "B4"),
    (CROWDED, 50, "B5", "B4"),
    (CROWDED, 64, "B5", "B4"),
    (SceneSpec(128, 96, 1.5, 20.0), 64, "B5", "B4"),
])
def test_kernel_choice_by_shape(spec, kmax, leapfrog, diag):
    assert dispatch.leapfrog_module(spec, kmax)[1] == leapfrog
    assert dispatch.rhmc_diag_module(spec, kmax)[1] == diag
    assert dispatch.trajectory_kernel("hmc", None, spec, kmax) == leapfrog
    assert dispatch.trajectory_kernel("smc", "diag", spec, kmax) == diag


def test_kernel_choice_raises_beyond_both_domains():
    """The crowded-field kernels take every scene beyond their TPU kernels'
    VMEM gates (tests/test_torch_beyond_gates.py holds a grid up to 512 x
    512 and K = 1000): the choice raises only for an empty catalog, naming
    both kernels of the pair."""
    big = SceneSpec(384, 384, 1.5, 20.0)
    assert dispatch.leapfrog_module(big, 64)[1] == "B5"
    assert dispatch.rhmc_diag_module(big, 64)[1] == "B4"
    assert dispatch.rhmc_diag_module(CROWDED, 255)[1] == "B4"
    with pytest.raises(ValueError, match=r"\(B1/B2\).*\(B5\) takes K >= 1, got K=0"):
        dispatch.leapfrog_module(big, 0)
    with pytest.raises(ValueError, match=r"\(B3\).*\(B4\) takes K >= 1, got K=0"):
        dispatch.rhmc_diag_module(big, 0)
    # B4's one-tile shared memory holds K <= 78 at 128x128, its wide path
    # the rest of its gate's K <= 254; B5's one-tile path every K <= 128,
    # its wide path up to its gate's 667
    assert frdc.smem_bytes(78, 128, 128) <= MAX_SMEM_BYTES < frdc.smem_bytes(79, 128, 128)
    assert flc.smem_bytes(128, 128, 128) <= MAX_SMEM_BYTES
    assert dispatch.leapfrog_module(CROWDED, 128)[1] == "B5"
    assert dispatch.leapfrog_module(CROWDED, 667)[1] == "B5"
    assert dispatch.leapfrog_module(CROWDED, 668)[1] == "B5"
    assert dispatch.rhmc_diag_module(CROWDED, 79)[1] == "B4"
    assert dispatch.rhmc_diag_module(CROWDED, 254)[1] == "B4"
    # the full metric runs on B6c, its crowded-field kernel, there and on
    # the big field; ChEES's runtime step count (B2's contract) on B5
    assert dispatch.trajectory_kernel("rhmc", "full", CROWDED, 64) == "B6c"
    assert dispatch.trajectory_kernel("rhmc", "full", big, 64) == "B6c"
    assert dispatch.trajectory_kernel("chees", None, CROWDED, 50) == "B5"
    assert dispatch.trajectory_kernel("chees", None, big, 64) == "B5"
    with pytest.raises(ValueError, match=r"\(B6\).*\(B6c\)"):
        dispatch.trajectory_kernel("rhmc", "full", big, 0)
    with pytest.raises(ValueError, match=r"\(B1/B2\).*\(B5\)"):
        dispatch.trajectory_kernel("chees", None, big, 0)


def test_b4_shared_memory_follows_its_gemm_layout():
    """smem_bytes mirrors the source's layout: 1/lam and the working field,
    128 rows by W columns each; the profiles gx (K + 3 rows of 132) and gy
    (K, 128); 55 floats of state per star, the partial sums and scratch.
    cfg4 (K = 64) and the crowded rhmc head (K = 50) fit at 128x128 and
    take the one-tile path; K = 79 does not fit and, like a side above
    128, takes the wide path."""
    fields = 2 * 128 * 128
    assert frdc.smem_bytes(64, 128, 128) == 4 * (fields + 67 * 132 + 64 * 128 + 32 + 55 * 64
                                                 + 288 + 8) == 214608
    # every field is 128 rows tall, whatever the height: 96x128 (chip_smoke's
    # ragged case) holds as much as 128x128, 100x84 a field of 84 columns
    assert frdc.smem_bytes(37, 96, 128) == frdc.smem_bytes(37, 128, 128)
    assert frdc.smem_bytes(5, 100, 84) == 4 * (2 * 128 * 84 + 8 * 132 + 5 * 128 + 32
                                               + 55 * 5 + 296)
    # a field smaller than one star's 512 q-field operands is raised to it
    assert frdc.smem_bytes(1, 2, 2) == 4 * (256 + 512 + 4 * 132 + 128 + 32 + 55 + 296)
    for k in (50, 64, 78):
        assert frdc.domain_error(CROWDED, k) is None and frdc.one_tile(k, 128, 128)
    assert frdc.smem_bytes(79, 128, 128) > MAX_SMEM_BYTES and not frdc.one_tile(79, 128, 128)
    assert frdc.domain_error(CROWDED, 79) is None
    assert not frdc.one_tile(8, 136, 128)
    assert frdc.domain_error(SceneSpec(136, 128, 1.5, 20.0), 8) is None
    assert frdc.domain_error(SceneSpec(96, 128, 1.5, 20.0), 37) is None
    assert frdc.one_tile(37, 96, 128)


def test_api_resolves_the_crowded_kernels():
    cfg = CONFIGS["cfg4_crowded"]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert api.resolve_kernel("cuda", cuda, cfg) == "cuda"
    assert api.resolve_kernel("auto", cpu, cfg) == "torch"
    hmc = apply_overrides(cfg, {"head": "hmc", "kmax": 50})
    assert api.resolve_kernel("cuda", cuda, hmc) == "cuda"
    rh = apply_overrides(hmc, {"head": "rhmc", "rhmc.metric": "diag"})
    assert api.resolve_kernel("cuda", cuda, rh) == "cuda"
    full = apply_overrides(rh, {"rhmc.metric": "full"})
    assert api.resolve_kernel("cuda", cuda, full) == "cuda"
    # beyond the TPU kernels' gates (256x256 at K = 50 and 64) auto and
    # cuda take the crowded-field kernels on a card; cuda off a card raises
    for c in (dataclasses.replace(full, scene=full.scene._replace(height=256, width=256)),
              dataclasses.replace(cfg, scene=cfg.scene._replace(height=256, width=256))):
        assert api.resolve_kernel("cuda", cuda, c) == "cuda"
        assert api.resolve_kernel("auto", cuda, c) == "cuda"
        with pytest.raises(ValueError, match="needs a CUDA device"):
            api.resolve_kernel("cuda", cpu, c)


# -- the preset and its scene --------------------------------------------------

def test_cfg4_preset_and_scene_match_jax():
    jcfg, cfg = JAX_CONFIGS["cfg4_crowded"], CONFIGS["cfg4_crowded"]
    assert cfg.smc == smc_config_from_jax(jcfg.smc)
    assert cfg.scene == spec_from_jax(jcfg.scene) and cfg.prior == prior_from_jax(jcfg.prior)
    assert (cfg.n_stars, cfg.kmax, cfg.head) == (jcfg.n_stars, jcfg.kmax, jcfg.head)
    assert (cfg.truth_seed, cfg.data_seed) == (jcfg.truth_seed, jcfg.data_seed)
    truth_j, img_j = jcfg.make_data()
    truth_t, img_t = cfg.make_data()
    np.testing.assert_array_equal(truth_t.numpy(), np.asarray(truth_j, np.float32))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j, np.float32))
    assert truth_t.shape == (50, 3) and img_t.shape == (128, 128)


# -- short runs through the API on the plain path -------------------------------

def test_short_cfg4_runs_through_the_api_on_the_plain_path():
    """The cfg4 preset at 16 particles for two temperature steps."""
    cfg = apply_overrides(CONFIGS["cfg4_crowded"], {
        "smc.n_particles": 16, "smc.max_steps": 2, "smc.mutation_chunk": 16})
    out = api.sample(cfg, "cpu", seed=0)
    st = out.stats
    assert out.thetas.shape == (16, 1, 64, 3) and np.isfinite(out.thetas).all()
    assert out.masks.shape == (16, 64)
    assert st["kernel"] == "rhmc_diag_torch" and st["trajectory_kernel"] == "torch"
    assert st["kernel_launches"] == 0 and st["n_temp_steps"] == 2
    assert np.isfinite(st["log_z"]) and 0.0 < st["beta"] < 1.0
    summ = api.summarize_output(out)
    assert np.isfinite(summ["total_flux"]["mean"]) and 0 <= summ["star_count"]["mode"] <= 64


def test_short_crowded_hmc_runs_through_the_api_on_the_plain_path():
    """head=hmc kmax=50: the fixed-K head on the crowded field at its true
    star count, started at the truth."""
    cfg = apply_overrides(CONFIGS["cfg4_crowded"], {
        "head": "hmc", "kmax": 50, "n_chains": 4, "n_warmup": 6, "n_samples": 4,
        "hmc.n_leapfrog": 3})
    out = api.sample(cfg, "cpu", seed=0)
    assert out.thetas.shape == (4, 4, 50, 3) and np.isfinite(out.thetas).all()
    assert out.stats["trajectory_kernel"] == "torch" and 0.0 < out.stats["accept"] <= 1.0
    truth = float(np.sum(out.stats["truth"]["f"]))
    flux = api.summarize_output(out)["total_flux"]["mean"]
    assert abs(flux - truth) < 0.1 * truth
