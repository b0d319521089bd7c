"""The full-Fisher trajectory beyond B6c's one-tile domain (fields beyond
128 x 128 pixels, or K > 64), where the port runs B6c's wide path
(starcat_torch/fused_rhmc_crowded.py) and the JAX package XLA: the plain
version (what the wrapper runs on the CPU and what chip_smoke.py holds the
wide path against) against the JAX type-major tile
(starcat/pallas_rhmc.py: rhmc_trajectory_tile, which takes any shape) at
two fields with a side beyond 128 pixels; the Hamiltonian and its
derivatives against the XLA route's make_rhmc_functions at K = 72; one
full-metric SMC temperature step on a 132-row field against the JAX
package's on its own draws; the new domain and its edges; and the wide
path's shared-memory and workspace arithmetic.  The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_rhmc as prh
from starcat import smc as jsmc
from starcat.metric import make_metric_fn as j_metric_fn
from starcat.pallas_kernels import _pack, _unpack
from starcat.potential import make_tempered_potential_and_grad as j_tempered
from starcat.rhmc import make_rhmc_functions as j_rhmc_functions
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import api, dispatch, smc
from starcat_torch import fused_rhmc as fr
from starcat_torch import fused_rhmc_crowded as frc
from starcat_torch import fused_rhmc_diag_crowded as frdc
from starcat_torch import rhmc as trhmc
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.convert import (
    prior_from_jax,
    smc_config_from_jax,
    smc_state_from_numpy,
    spec_from_jax,
)
from starcat_torch.metric import make_metric_fn
from starcat_torch.potential import make_tempered_potential_and_grad
from starcat_torch.scene import SceneSpec

from jax_draws import jax_step_draws

torch.set_num_threads(1)

C = 4
JITTER = 1e-3
# tests/test_torch_rhmc_full_crowded.py's TOL: theta 1e-4, p 1e-3, h 2e-3,
# the solver residual 1e-6
TOL = dict(theta=1e-4, p=1e-3, h=2e-3, resid=1e-6)
# fields with a side beyond 128 pixels, few stars: the tile unrolls K^2
# pair passes, which op by op stay quick at K = 4
SHAPES = {"132x18 K=4": (132, 18, 4), "18x136 K=4": (18, 136, 4)}
N_STEPS, FPI, EPS = 2, 2, 0.01
CASES = [(form, beta) for beta in (1.0, 0.7) for form in ("shared", "per_chain")]


def _d(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@functools.cache
def _scene(h, w, k, seed=3):
    """A mock h x w scene of k stars, theta near the truth, xi, and
    per-chain masks with dead slots (two on chain 1, one on chain 3)."""
    spec = starcat.SceneSpec(h, w, 1.5, 5.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(seed), k, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(seed + 1), x, y, f, spec),
                     np.float32)
    rng = np.random.default_rng(seed + 2)
    theta = (np.asarray(truth)[None] + 0.05 * rng.standard_normal((C, k, 3))).astype(np.float32)
    xi = rng.standard_normal((C, k, 3)).astype(np.float32)
    mask_c = np.ones((C, k), np.float32)
    mask_c[1, [0, k // 2]] = 0.0
    mask_c[3, -1] = 0.0
    return dict(spec=spec, prior=prior, img=img, theta=theta, xi=xi, mask_c=mask_c, k=k,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


def _case_masks(s, form):
    return np.ones((C, s["k"])) if form == "shared" else s["mask_c"].astype(np.float64)


@functools.cache
def _jax_tile(name):
    """rhmc_trajectory_tile at the shape in float64, run op by op, one call
    for every case (C chains each, beta per chain)."""
    s = _scene(*SHAPES[name])
    k = s["k"]
    theta = np.concatenate([s["theta"]] * len(CASES)).astype(np.float64)
    xi = np.concatenate([s["xi"]] * len(CASES)).astype(np.float64)
    mask = np.concatenate([_case_masks(s, form) for form, _ in CASES])
    beta = np.repeat([b for _, b in CASES], C)
    with jax.enable_x64(True), jax.disable_jit():
        out = prh.rhmc_trajectory_tile(
            _pack(jnp.asarray(theta), k), _pack(jnp.asarray(xi), k),
            jnp.full((1, C * len(CASES)), EPS, jnp.float64), jnp.asarray(mask).T,
            jnp.asarray(s["img"], jnp.float64), s["spec"], s["prior"], k, N_STEPS, FPI,
            jnp.asarray(beta), JITTER)
        out = (np.asarray(_unpack(out[0], k)), np.asarray(_unpack(out[1], k)),
               *(np.asarray(o) for o in out[2:]))
    return {case: tuple(o[i * C:(i + 1) * C] for o in out) for i, case in enumerate(CASES)}


@pytest.mark.parametrize("form,beta", CASES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_reference_matches_jax_tile_beyond_128(name, form, beta):
    """The plain version against the JAX type-major tile on a field with a
    side beyond 128 pixels (B6c's wide path there), both in float64, with
    TOL; dead slots frozen bit for bit, momentum exactly 0."""
    s = _scene(*SHAPES[name])
    k = s["k"]
    assert max(s["tspec"].height, s["tspec"].width) > 128
    assert dispatch.rhmc_full_module(s["tspec"], k)[1] == "B6c"
    assert not frc.one_tile(k, s["tspec"].height, s["tspec"].width)
    want = _jax_tile(name)[(form, beta)]
    mask = _case_masks(s, form)
    out_t = fr.fused_rhmc_reference(s["tspec"], _d(s["img"]), s["tprior"], _d(s["theta"]),
                                    _d(s["xi"]), EPS, _d(mask[0] if form == "shared" else mask),
                                    beta, N_STEPS, FPI, JITTER)
    assert out_t[0].dtype == torch.float64
    np.testing.assert_allclose(out_t[0].numpy(), want[0], atol=TOL["theta"])
    np.testing.assert_allclose(out_t[1].numpy(), want[1], atol=TOL["p"])
    for got, ref in zip(out_t[2:5], want[2:5]):
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL["h"])
    np.testing.assert_allclose(out_t[5].numpy(), want[5], atol=TOL["resid"])
    assert np.isfinite(out_t[5].numpy()).all() and float(out_t[5].max()) > 0.0
    dead = mask == 0.0
    assert dead.any() == (form == "per_chain")
    np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])
    assert not out_t[1].numpy()[dead].any()


# K = 72 stars on a 24x24 field (D = 216, beyond the one-tile K <= 64; the
# tile unrolls K^2 pair passes, so the XLA route is the reference there),
# and 8 stars on a 136x20 field (rows beyond 128)
XLA_SHAPES = {"24x24 K=72": (24, 24, 72), "136x20 K=8": (136, 20, 8)}


@functools.cache
def _xla_route(name):
    """The XLA route's H, dH/dtheta and dH/dp at the shape, vmapped over the
    chains, beta an argument: one compile a shape, in float64."""
    s = _scene(*XLA_SHAPES[name], seed=11)

    def route(theta, p, mask, beta):
        tpg_j = j_tempered(s["spec"], jnp.asarray(s["img"], jnp.float64), s["prior"])
        jm = j_metric_fn(s["spec"], s["prior"], JITTER)
        fns = j_rhmc_functions(lambda th, m: tpg_j(th, m, beta)[0],
                               lambda th, m: jm(th, m, beta))
        return tuple(jax.vmap(f)(theta, p, mask) for f in fns)

    return jax.jit(route)


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("name", list(XLA_SHAPES))
def test_hamiltonian_and_derivatives_match_the_xla_route_beyond_the_one_tile_domain(
        name, beta):
    """H, dH/dtheta and dH/dp against the JAX package's XLA
    make_rhmc_functions (the route it runs beyond B6's gate), both in
    float64, with tests/test_torch_rhmc_full_crowded.py's tolerances; some
    slots dead."""
    h, w, k = XLA_SHAPES[name]
    s = _scene(h, w, k, seed=11)
    assert not frc.one_tile(k, h, w)
    assert frc.domain_error(s["tspec"], k) is None
    p = 3.0 * s["xi"].astype(np.float64) * s["mask_c"][..., None]
    theta = s["theta"].astype(np.float64)
    mask = s["mask_c"].astype(np.float64)
    with jax.enable_x64(True):
        want = [np.asarray(o) for o in _xla_route(name)(
            jnp.asarray(theta).reshape(C, -1), jnp.asarray(p).reshape(C, -1),
            jnp.asarray(mask), jnp.float64(beta))]
    assert want[0].dtype == np.float64
    tpg_t = make_tempered_potential_and_grad(s["tspec"], _d(s["img"]), s["tprior"])
    tm = make_metric_fn(s["tspec"], s["tprior"], JITTER)
    ham_t, dhdt_t, dhdp_t = trhmc.make_rhmc_functions(lambda th, m: tpg_t(th, m, beta)[0],
                                                      lambda th, m: tm(th, m, beta))
    args_t = (_d(theta), _d(p), _d(mask))
    np.testing.assert_allclose(ham_t(*args_t).numpy(), want[0], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(dhdt_t(*args_t).numpy().reshape(C, -1), want[1],
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(dhdp_t(*args_t).numpy().reshape(C, -1), want[2],
                               rtol=1e-4, atol=1e-4)


# -- one full-metric SMC step on a field beyond 128 rows -------------------------

P, K = 16, 3
SPEC_J = starcat.SceneSpec(132, 18, 1.5, 4.0)
PRIOR_J = starcat.PriorSpec(4.0, 0.7)


def test_full_metric_smc_step_beyond_128_rows_matches_jax_on_its_draws():
    """One step from the prior population of a 132x18 field, where the card
    runs B6c's wide path: beta by bisection, logZ, resampling, two sweeps
    with residual-driven births, two full-metric mutations (the plain
    trajectory against the JAX SMC's rhmc_pallas, Pallas B6 in interpret
    mode, whose type-major factor the port's p0 = L xi shares), the eps
    controller and the log-likelihood refresh.  Bounds as
    tests/test_torch_wide_fields.py's diagonal step."""
    truth = starcat.sample_prior(jax.random.key(0), 3, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, SPEC_J)
    cfg_j = jsmc.SMCConfig(n_particles=P, mutation="rhmc_pallas", n_mutation_steps=2,
                           n_leapfrog=2, fixed_point_iters=2, n_transdim_sweeps=2,
                           step_size0=0.05,
                           transdim=JTransDimConfig(lam_count=2.0, birth_proposal="residual"))
    st0 = jsmc.init_smc(jax.random.key(4), SPEC_J, img, PRIOR_J, K, cfg_j)
    st1 = jsmc.make_smc_step(SPEC_J, img, PRIOR_J, cfg_j)(st0)
    cfg = smc_config_from_jax(cfg_j)
    tspec = spec_from_jax(SPEC_J)
    assert cfg.mutation == "rhmc" and tspec.height > 128
    assert dispatch.trajectory_kernel("smc", "full", tspec, K) == "B6c"
    assert not frc.one_tile(K, tspec.height, tspec.width)
    tst0 = smc_state_from_numpy(st0.theta, st0.mask, st0.loglik, st0.beta, st0.log_z,
                                st0.eps, st0.n_steps, st0.mean_accept, st0.final_done, "cpu")
    step = smc.make_smc_step(tspec, _t(img), prior_from_jax(PRIOR_J), K, cfg)
    tst1 = step(tst0, jax_step_draws(st0.key, cfg_j, K, SPEC_J.height * SPEC_J.width))
    assert float(tst1.beta) == pytest.approx(float(st1.beta), rel=1e-5)
    assert 0.0 < float(tst1.beta) < 1.0
    assert float(tst1.log_z) == pytest.approx(float(st1.log_z), rel=1e-5, abs=1e-3)
    np.testing.assert_array_equal(tst1.mask.numpy(), np.asarray(st1.mask))
    np.testing.assert_allclose(tst1.theta.numpy(), np.asarray(st1.theta), atol=1e-4)
    np.testing.assert_allclose(tst1.loglik.numpy(), np.asarray(st1.loglik), rtol=1e-5, atol=2e-3)
    assert float(tst1.mean_accept) == pytest.approx(float(st1.mean_accept), abs=5e-3)
    assert float(tst1.eps) == pytest.approx(float(st1.eps), rel=1e-4)
    assert 0.0 < float(tst1.mean_accept) <= 1.0


# -- the domain -----------------------------------------------------------------

def _spec(h, w):
    return SceneSpec(h, w, 1.5, 20.0)


# B6c's old domain edges (before the TPU gates went), each with B4's (the
# TPU gate's) largest K there: the one-tile edge, then the wide path's
EDGES = ((128, 128, 64), (128, 128, 254), (192, 192, 125), (256, 256, 47), (304, 96, 89),
         (96, 304, 89), (32, 32, 256), (1, 1, 1))


@pytest.mark.parametrize("h,w,k", EDGES)
def test_b6c_takes_the_edges_of_its_domain(h, w, k):
    assert frc.domain_error(_spec(h, w), k) is None
    frc.check_domain(_spec(h, w), k)
    assert dispatch.trajectory_kernel("rhmc", "full", _spec(h, w), k) in ("B6", "B6c")
    # wherever the diagonal metric runs on B4, the full metric runs on B6c
    assert frdc.domain_error(_spec(h, w), k) is None


@pytest.mark.parametrize("h,w,k,match", [
    (128, 128, 255, None),
    (192, 192, 126, None),
    (256, 256, 48, None),
    (304, 96, 90, None),
    (400, 400, 1, None),
    (32, 32, 257, None),
    (32, 32, 0, r"\(B6\).*\(B6c\) takes K >= 1, got K=0"),
])
def test_one_past_each_edge_raises_naming_b6_and_b6c(h, w, k, match):
    """One past each of the old edges B6c now runs (match None: its wide
    path, as the JAX package runs XLA there); only K < 1 raises, naming
    both kernels."""
    prior = CONFIGS["cfg4_crowded"].prior
    if match is None:
        assert dispatch.trajectory_kernel("rhmc", "full", _spec(h, w), k) == "B6c"
        assert not frc.one_tile(k, h, w) and frc.domain_error(_spec(h, w), k) is None
        fused = dispatch.make_rhmc_full(_spec(h, w), torch.zeros((h, w)), prior, k, 2, 2)
        assert callable(fused)
        return
    with pytest.raises(ValueError, match=match):
        dispatch.trajectory_kernel("rhmc", "full", _spec(h, w), k)
    with pytest.raises(ValueError, match=match):
        dispatch.make_rhmc_full(_spec(h, w), torch.zeros((h, w)), prior, k, 2, 2)


# the wide runs on the card: cfg4's SMC with the full-metric mutation on the
# 192x192 slice, and the rhmc head at K = 80 on 128x128
R1 = {"scene.height": 192, "scene.width": 192, "n_stars": 112, "kmax": 125,
      "smc.mutation": "rhmc", "smc.max_steps": 8}
R2 = {"scene.height": 128, "scene.width": 128, "n_stars": 80, "kmax": 80, "n_warmup": 300,
      "n_samples": 300}


@pytest.mark.parametrize("name,over", [("cfg4_crowded", R1), ("cfg1_rhmc", R2)])
def test_the_wide_runs_resolve_to_b6c(name, over):
    cfg = apply_overrides(CONFIGS[name], over)
    cuda = torch.device("cuda")
    for pref in ("auto", "cuda"):
        assert api.resolve_kernel(pref, cuda, cfg) == "cuda"
    assert dispatch.trajectory_kernel(cfg.head, api._metric_of(cfg), cfg.scene,
                                      cfg.kmax) == "B6c"
    assert not frc.one_tile(cfg.kmax, cfg.scene.height, cfg.scene.width)
    # beyond B4's TPU gate (400x400) B6c runs too, on kernel=auto and cuda
    beyond = dataclasses.replace(cfg, scene=cfg.scene._replace(height=400, width=400))
    for pref in ("auto", "cuda"):
        assert api.resolve_kernel(pref, cuda, beyond) == "cuda"
    assert dispatch.trajectory_kernel(cfg.head, "full", beyond.scene, cfg.kmax) == "B6c"


# -- the wide path's sizes ------------------------------------------------------

@pytest.mark.parametrize("k,h,w,one", [
    (64, 128, 128, True), (1, 1, 1, True), (65, 32, 32, False), (10, 129, 128, False),
    (12, 64, 136, False), (125, 192, 192, False), (254, 128, 128, False)])
def test_b6c_launch_takes_the_one_tile_path_inside_its_old_domain(k, h, w, one):
    """one_tile (one_tile in the source) is the kernel's first domain, H,
    W <= 128 and K <= 64; the launch's shared memory and workspace follow
    its path."""
    assert frc.one_tile(k, h, w) == one
    if one:
        assert frc.launch_smem_bytes(k, h, w) == frc.smem_bytes(k, h, w)
        assert frc.launch_workspace_floats(k, h, w) == frc.workspace_floats(k, h, w)
    else:
        assert frc.launch_smem_bytes(k, h, w) == frc.wide_smem_bytes(k)
        assert frc.launch_workspace_floats(k, h, w) == frc.wide_workspace_floats(k, h, w)
    assert frc.workspace_bytes(k, h, w, 3) == 4 * (4 + 3 * frc.launch_workspace_floats(k, h, w))


def test_b6c_wide_shared_memory_follows_the_source():
    """wide_smem_bytes mirrors wide::smem_floats: the region (the q field's
    two operand stages over a 128x128 tile, 2 (32 x 256 + 16) floats, or the
    Cholesky's 32-column panel by rows, 33 (3K + 1) floats, whichever is
    larger, rounded up to 4), the q coefficient ring (192 floats), 67
    floats a star and 12 of per-chain scalars; it fits a block on an H100
    at every K up to 256."""
    stages = 2 * (32 * 256 + 16)
    assert frc.wide_region_floats(1) == stages == 16416
    assert frc.wide_region_floats(165) == 16416  # 33 x 496 = 16368
    assert frc.wide_region_floats(166) == 33 * 499 + 1 == 16468
    assert frc.wide_region_floats(256) == 33 * 769 + 3
    assert frc.wide_smem_bytes(125) == 4 * (16416 + 192 + 67 * 125 + 12) == 99980
    assert frc.wide_smem_bytes(256) == 4 * (25380 + 192 + 67 * 256 + 12) == 170944
    assert max(frc.wide_smem_bytes(k) for k in range(1, 257)) <= MAX_SMEM_BYTES - 1024
    # L^-1's sixteen column vectors of D fit the region
    assert all(frc.wide_region_floats(k) >= 16 * 3 * k for k in range(1, 257))


def test_b6c_wide_workspace_follows_the_source():
    """wide_workspace_floats mirrors wide::work_floats: the working field
    and 1/lam (H rows at the field stride each), gy and gy' at the odd star
    stride, gx, gx', gx'', gy'', the 18 K^2 pair sums, G^-1, the q
    coefficient table (12 floats a pair, whole chunks of 8), packed L with
    the momentum's row and L^-1 (D x D), and the chain's live slots and
    their mask values (2 K, once in static shared memory), each
    a multiple of 4 floats."""
    k, h, w, d = 125, 192, 192, 375
    pairs = (k * (k + 1) // 2 + 7) // 8 * 8
    assert pairs == 7880
    assert frc.wide_workspace_floats(k, h, w) == (
        2 * 192 * 192 + (2 * 125 * 193 + 2) + 3 * 125 * 192 + (125 * 193 + 3)
        + (18 * 125 * 125 + 2) + (d * d + 3) + 12 * pairs + 376 * 377 // 2
        + (d * d + 3) + 252) == 946304
    # a block works in 3.8 MB at the slice's shape, 12.9 MB at 128x128 K = 254
    # (1.71 GB for a grid of one block on each of an H100's 132 SMs)
    assert frc.workspace_bytes(125, 192, 192, 1) == 4 * (4 + 946304)
    assert round(frc.workspace_bytes(254, 128, 128, 132) / 1e9, 2) == 1.71
    assert all(frc.wide_workspace_floats(k, h, w) % 4 == 0
               for k in (1, 5, 65, 125, 254) for h, w in ((129, 128), (7, 13), (304, 96)))
