"""B5 and B4 over their TPU kernels' whole domains and beyond.  The kernel
choice on a grid of fields and catalogs against the JAX package's own VMEM
gates (starcat/pallas_mxu.py:mxu_fused_supported at an 8-chain tile for B5;
starcat/pallas_rhmc_diag.py:diag_mxu_supported at an 8-chain tile or
diag_fused_supported at 1024 chains for B4): every shape a gate takes runs
on a CUDA kernel of the pair, and so does every shape beyond it, on the
crowded-field kernel (tests/test_torch_beyond_gates.py holds the grid up to
512 x 512 and K = 1000).
The plain versions, which the wrappers run on the CPU and against which
chip_smoke.py holds the wide CUDA paths, against Pallas B5 and B4 in
interpret mode and the pure-JAX MXU tile at fields with one side above 128
pixels and at catalogs beyond the one-tile caps (K = 130).  One cfg4-shaped
SMC temperature step with the diagonal mutation on a 136-row field, fed
the JAX keys' own draws, against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_mxu as pmx
from starcat import pallas_rhmc_diag as prd
from starcat import smc as jsmc
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import dispatch, smc
from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch import fused_rhmc_diag_crowded as frdc
from starcat_torch.convert import (
    prior_from_jax,
    smc_config_from_jax,
    smc_state_from_numpy,
    spec_from_jax,
)
from starcat_torch.fused_leapfrog import fused_leapfrog_reference
from starcat_torch.fused_rhmc_diag import fused_rhmc_diag_reference
from starcat_torch.scene import SceneSpec

from jax_draws import jax_step_draws
from test_torch_crowded_kernels import TOL, JITTER, T, _energy_tol, _masks, _scene, _t

torch.set_num_threads(1)


# -- (a) the kernel choice against the TPU kernels' gates ----------------------

# the fields of the table in PERF.md's kernel section, both orientations of
# the oblong ones, and a grid up to past the largest square either gate takes
SIDES = (1, 8, 16, 40, 64, 96, 128, 136, 192, 200, 256, 304, 352, 360)
TABLE = ((128, 128, 667, 254), (136, 40, 691, 272), (192, 192, 361, 125),
         (200, 136, 385, 140), (256, 256, 183, 47), (304, 96, 248, 89),
         (96, 304, 248, 89), (352, 128, 179, 58), (128, 352, 179, 58))


def _b5_gate(h, w, k):
    return pmx.mxu_fused_supported(starcat.SceneSpec(h, w, 1.5, 20.0), k, 8)


def _b4_gate(h, w, k):
    js = starcat.SceneSpec(h, w, 1.5, 20.0)
    return prd.diag_mxu_supported(js, k, 8) or prd.diag_fused_supported(js, k, 1024)


def _edge(gate, h, w):
    """The largest K the gate takes at h x w (0 if none)."""
    lo, hi = 0, 1
    while gate(h, w, hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gate(h, w, mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("h,w,k5,k4", TABLE)
def test_table_edges_are_the_tpu_gates(h, w, k5, k4):
    """The table's edges are the gates' own; the port runs on the crowded
    kernel at each edge and one past it, where the JAX package takes XLA."""
    spec = SceneSpec(h, w, 1.5, 20.0)
    assert _edge(_b5_gate, h, w) == k5 and _edge(_b4_gate, h, w) == k4
    for k in (k5, k5 + 1):
        assert flc.domain_error(spec, k) is None
        assert dispatch.trajectory_kernel("chees", None, spec, k) == "B5"
        assert dispatch.trajectory_kernel("hmc", None, spec, k) == "B5"
    for k in (k4, k4 + 1):
        assert frdc.domain_error(spec, k) is None
        assert dispatch.trajectory_kernel("smc", "diag", spec, k) == "B4"


@pytest.mark.parametrize("h", SIDES)
def test_every_shape_the_gates_take_runs_on_the_pair(h):
    """At every width of the grid, the catalogs around each gate's edge and
    a spread below it: the crowded-field kernel's domain holds every (H, W,
    K), and the pair's choice names a kernel; the one-tile domains lie
    inside the gates, so where a gate does not take the shape the choice
    names the crowded-field kernel on its wide path."""
    for w in SIDES:
        spec = SceneSpec(h, w, 1.5, 20.0)
        for gate, mod, names, pattern in (
                (_b5_gate, flc, ("B1", "B2", "B5"), r"\(B1/B2\).*\(B5\) takes K >= 1"),
                (_b4_gate, frdc, ("B3", "B4"), r"\(B3\).*\(B4\) takes K >= 1")):
            edge = _edge(gate, h, w)
            ks = {1, 2, 16, 64, 78, 79, 128, 129, edge, edge + 1, max(1, edge // 2)}
            for k in sorted(ks):
                if k < 1:  # a gate that takes no catalog here: only K < 1 raises
                    with pytest.raises(ValueError, match=pattern):
                        dispatch.trajectory_kernel("hmc", None if mod is flc else "diag",
                                                   spec, k)
                    continue
                takes = gate(h, w, k)
                assert mod.domain_error(spec, k) is None, (h, w, k)
                assert takes or not mod.one_tile(k, h, w), (h, w, k)
                got = dispatch.trajectory_kernel("chees", None if mod is flc else "diag",
                                                 spec, k)
                assert got in names and (takes or got == names[-1]), (h, w, k, got)


def test_no_catalog_of_the_diagonal_gates_raises_up_to_128_a_side():
    """Every (H, W, K) on an 8-pixel grid up to 128 x 128 with K from 79 to
    128, all of which the TPU's diagonal gates take, runs on B3 or B4; the
    one-tile path takes those whose shared memory fits, the wide path the
    rest (the first at 8x72 with K = 124)."""
    wide = []
    for h in range(8, 129, 8):
        for w in range(8, 129, 8):
            spec = SceneSpec(h, w, 1.5, 20.0)
            for k in range(79, 129):
                assert _b4_gate(h, w, k)
                assert dispatch.rhmc_diag_module(spec, k)[1] in ("B3", "B4")
                if not frdc.one_tile(k, h, w):
                    wide.append((h, w, k))
    assert wide[0] == (8, 72, 124)
    assert all(frdc.domain_error(SceneSpec(h, w, 1.5, 20.0), k) is None for h, w, k in wide)


def test_wide_paths_fit_a_block():
    """The wide paths' shared memory (the tile's fields, one chunk's
    profiles) is fixed whatever the scene and fits the card; B4's workspace
    holds a build's 1/lam in 128-row bands and 49 floats a slot."""
    from starcat_torch.build import MAX_SMEM_BYTES

    assert flc.wide_smem_bytes() == 4 * (128 * 128 + 131 * 132 + 128 * 128 + 32 + 192
                                         + 768 + 16 + 4) == 204288 <= MAX_SMEM_BYTES
    assert frdc.wide_smem_bytes() == 4 * (2 * 128 * 128 + 67 * 132 + 64 * 128 + 32 + 288
                                          + 448 + 8) == 202320 <= MAX_SMEM_BYTES
    assert frdc.workspace_floats(125, 192, 192) == 2 * 192 * 128 + 49 * 125 + 3 == 55280
    assert frdc.workspace_floats(1, 128, 128) == 128 * 128 + 52
    assert not flc.one_tile(125, 192, 192) and flc.one_tile(128, 128, 128)
    assert not frdc.one_tile(79, 128, 128) and frdc.one_tile(78, 128, 128)


# -- (b) the plain versions against Pallas B5 and B4 beyond the old caps ------

# (h, w, k, seed): one side above 128 pixels either way, and K beyond both
# kernels' one-tile caps on a small field; each runs on B5 and on B4's wide
# path on the card (beyond B1's and B3's H W <= 48^2)
WIDE_SHAPES = ((136, 18, 6, 11), (18, 136, 5, 12), (16, 12, 130, 13))


@pytest.fixture(scope="module", params=WIDE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}K{s[2]}")
def scene(request):
    h, w, k, seed = request.param
    spec = SceneSpec(h, w, 1.5, 5.0)
    assert dispatch.leapfrog_module(spec, k)[1] == "B5" and not flc.one_tile(k, h, w)
    assert dispatch.rhmc_diag_module(spec, k)[1] == "B4" and not frdc.one_tile(k, h, w)
    return _scene(h, w, k, seed)


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b5_reference_matches_pallas_interpret_beyond_the_caps(scene, form):
    """Pallas B5 in interpret mode against the wrapper on CPU tensors (what
    the wide CUDA path is held to on the card), three steps with per-chain
    eps and the entry gradient in.  Bounds as
    tests/test_torch_crowded_kernels.py: theta 3e-4, p 5e-3, U as
    _energy_tol(2e-3), grad 1e-4 relative to 1 + |grad|, or, where the two
    float32 programs part by more (136 rows of a field with bright stars
    put both about 1e-3 from float64), no farther from the plain version
    in float64 than Pallas B5 is, plus 1e-4."""
    s = scene
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(k)
    eps = (0.01 * (1.0 + 0.1 * np.arange(T))).astype(np.float32)
    inv_mass = np.full((k, 3), 0.8, np.float32)
    p = s["p"] * mask_j[..., None]
    grad = fused_leapfrog_reference(s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]),
                                    _t(p), 0.01, _t(inv_mass), mask_t, 0)[3].numpy()
    out_j = pmx.make_pallas_leapfrog_mxu(s["spec"], jnp.asarray(s["img"]), s["prior"], k, 3,
                                         interpret=True)(
        jnp.asarray(s["theta"]), jnp.asarray(p), jnp.asarray(eps), jnp.asarray(inv_mass),
        jmask, jnp.asarray(grad))
    out_t = flc.make_fused_leapfrog(s["tspec"], _t(s["img"]), s["tprior"], k, 3)(
        _t(s["theta"]), _t(p), _t(eps), _t(inv_mass), mask_t, grad=_t(grad))
    th_j, p_j, u_j, g_j = (np.asarray(o) for o in out_j)
    np.testing.assert_allclose(out_t[0].numpy(), th_j, atol=3e-4)
    np.testing.assert_allclose(out_t[1].numpy(), p_j, atol=5e-3)
    np.testing.assert_allclose(out_t[2].numpy(), u_j, rtol=0, atol=_energy_tol(u_j, 2e-3))
    rel = np.abs(out_t[3].numpy() - g_j) / (1.0 + np.abs(g_j))
    if rel.max() >= 1e-4:
        f64 = [_t(a).double() for a in (s["img"], s["theta"], p, eps, inv_mass, grad)]
        g64 = fused_leapfrog_reference(s["tspec"], f64[0], s["tprior"], *f64[1:5],
                                       mask_t.double(), 3, f64[5])[3].numpy()
        far_t = np.abs(out_t[3].numpy() - g64) / (1.0 + np.abs(g64))
        far_j = np.abs(g_j - g64) / (1.0 + np.abs(g64))
        assert far_t.max() <= far_j.max() + 1e-4, (rel.max(), far_t.max(), far_j.max())
    if form == "per_chain":  # dead slots frozen bit for bit
        dead = s["mask_c"] == 0
        np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])


def _check_trajectory(out_t, ref64, th, p, h0, h1, u1, resid):
    """tests/test_torch_crowded_kernels.py's bounds (theta 1e-5, the
    residual 1e-6, h and u as _energy_tol(2e-3)), with p's 1e-4 taken
    relative to 1 + |p|: p = sqrt(g) xi grows with the Fisher information,
    and 136 rows of a bright star's profile put |p| near 15 (chip_smoke.py
    holds B4's p so on the card).  An energy beyond its bound passes if
    the plain version is no farther from its own float64 run (ref64) than
    the JAX one is, plus the bound: the two float32 programs sum 2448
    pixels in their own orders."""
    np.testing.assert_allclose(out_t[0].numpy(), th, atol=TOL["theta"])
    np.testing.assert_array_less(np.abs(out_t[1].numpy() - p), TOL["p"] * (1.0 + np.abs(p)))
    for got, want, z in zip(out_t[2:5], (h0, h1, u1), ref64[2:5]):
        tol, got, z = _energy_tol(want, 2e-3), got.numpy(), z.numpy()
        if np.abs(got - want).max() > tol:
            assert np.abs(got - z).max() <= np.abs(want - z).max() + tol
    np.testing.assert_allclose(out_t[5].numpy(), resid, atol=TOL["resid"])


def _plain64(s, p, eps, mask_t, beta, n_steps, fpi):
    return fused_rhmc_diag_reference(
        s["tspec"], _t(s["img"]).double(), s["tprior"], _t(s["theta"]).double(),
        _t(p).double(), torch.as_tensor(eps).double(), mask_t.double(), beta, n_steps, fpi,
        JITTER)


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b4_reference_matches_pallas_interpret_beyond_the_caps(scene, beta, form):
    """Pallas B4 in interpret mode against the wrapper on CPU tensors, beta
    as a tensor, per-chain eps; bounds as _check_trajectory."""
    s = scene
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    eps = (0.01 * (1.0 + 0.1 * np.arange(T))).astype(np.float32)
    jmask = jnp.asarray(mask_j) if form == "per_chain" else jnp.ones(k)
    out_j = prd.make_pallas_rhmc_diag_mxu(
        s["spec"], jnp.asarray(s["img"]), s["prior"], k, n_steps=2, fixed_point_iters=3,
        jitter=JITTER, interpret=True)(
        jnp.asarray(s["theta"]), jnp.asarray(s["p"]), jnp.asarray(eps), jmask, beta)
    out_t = frdc.make_fused_rhmc_diag(s["tspec"], _t(s["img"]), s["tprior"], k, 2, 3, JITTER)(
        _t(s["theta"]), _t(s["p"]), _t(eps), mask_t, torch.tensor(beta))
    _check_trajectory(out_t, _plain64(s, s["p"], eps, mask_t, beta, 2, 3),
                      *(np.asarray(o) for o in out_j))


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b4_reference_matches_mxu_tile_beyond_the_caps(scene, form):
    """The pure-JAX MXU tile (the reference's own B4 math) against the
    plain version at beta 0.7, three steps of four sweeps; dead slots frozen
    with zero momentum."""
    s = scene
    k = s["k"]
    mask_j, mask_t = _masks(s, form)
    out_j = prd.rhmc_diag_trajectory_mxu(
        pmx._pack_rows(jnp.asarray(s["theta"]), k), pmx._pack_rows(jnp.asarray(s["p"]), k),
        jnp.full((T, 1), 0.02), jnp.asarray(mask_j), jnp.asarray(s["img"]), s["spec"],
        s["prior"], k, 3, 4, 0.7, JITTER)
    out_t = fused_rhmc_diag_reference(s["tspec"], _t(s["img"]), s["tprior"], _t(s["theta"]),
                                      _t(s["p"]), 0.02, mask_t, 0.7, 3, 4, JITTER)
    _check_trajectory(out_t, _plain64(s, s["p"], 0.02, mask_t, 0.7, 3, 4),
                      np.asarray(pmx._unpack_rows(out_j[0], k)),
                      np.asarray(pmx._unpack_rows(out_j[1], k)),
                      *(np.asarray(o) for o in out_j[2:]))
    dead = s["mask_c"] == 0.0 if form == "per_chain" else np.zeros((T, k), bool)
    np.testing.assert_array_equal(out_t[0].numpy()[dead], s["theta"][dead])
    np.testing.assert_array_equal(out_t[1].numpy()[dead], 0.0)


# -- (c) one SMC step with the diagonal mutation on a field beyond 128 rows ----

P, K = 16, 4
SPEC_J = starcat.SceneSpec(136, 18, 1.5, 4.0)
PRIOR_J = starcat.PriorSpec(4.0, 0.7)


def test_diag_smc_step_beyond_128_rows_matches_jax_on_its_draws():
    """One step from the prior population of a 136x18 field (rows beyond one
    128-row band of B4's wide path, where the card runs it): beta by bisection, logZ, resampling,
    two sweeps with residual-driven births, two diagonal-Fisher mutations
    (B4's plain trajectory against Pallas B4 in interpret mode, the JAX
    SMC's rhmc_diag_pallas), the eps controller and the log-likelihood
    refresh.  Bounds as tests/test_torch_crowded.py's cfg4-shaped step."""
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
    tspec = spec_from_jax(SPEC_J)
    assert cfg.mutation == "rhmc_diag" and tspec.height > 128
    assert dispatch.trajectory_kernel("smc", "diag", tspec, K) == "B4"
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
