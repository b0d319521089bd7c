"""The full-Fisher trajectory beyond kernel B6's domain, where the port runs
B6c (starcat_torch/fused_rhmc_crowded.py) and the JAX package XLA: the
plain version against the JAX package's type-major tile
(starcat/pallas_rhmc.py: rhmc_trajectory_tile, which takes any shape) at
two shapes B6 refuses, the Hamiltonian and its derivatives against the XLA
route's make_rhmc_functions, the B6c wrapper on CPU tensors, the choice
between B6 and B6c, and B6c's shared-memory and workspace layout.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_rhmc as prh
from starcat.metric import make_metric_fn as j_metric_fn
from starcat.pallas_kernels import _pack, _unpack
from starcat.potential import make_tempered_potential_and_grad as j_tempered
from starcat.rhmc import make_rhmc_functions as j_rhmc_functions
from starcat_torch import api, dispatch
from starcat_torch import fused_rhmc as fr
from starcat_torch import fused_rhmc_crowded as frc
from starcat_torch import rhmc as trhmc
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.convert import prior_from_jax, spec_from_jax
from starcat_torch.metric import make_metric_fn
from starcat_torch.potential import make_tempered_potential_and_grad
from starcat_torch.scene import SceneSpec

torch.set_num_threads(1)

C = 4
JITTER = 1e-3
# tests/test_torch_rhmc_full.py's TOL (tests/test_pallas_rhmc.py:134-141):
# theta 1e-4, p 1e-3, h 2e-3; the solver residual, a ratio of float32
# deltas, 1e-6
TOL = dict(theta=1e-4, p=1e-3, h=2e-3, resid=1e-6)
SHAPES = {"50x50 K=18": (50, 50, 18), "40x72 K=12": (40, 72, 12)}


@functools.cache
def _scene(name):
    """A mock scene of the shape's K stars, theta near the truth, xi, and
    per-chain masks with dead slots (two on chain 1, one on chain 3, the
    first and last slots among them)."""
    h, w, k = SHAPES[name]
    spec = starcat.SceneSpec(h, w, 1.5, 5.0)
    prior = starcat.PriorSpec(3.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(3), k, prior)
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(4), x, y, f, spec), np.float32)
    rng = np.random.default_rng(5)
    theta = (np.asarray(truth)[None] + 0.05 * rng.standard_normal((C, k, 3))).astype(np.float32)
    xi = rng.standard_normal((C, k, 3)).astype(np.float32)
    mask_c = np.ones((C, k), np.float32)
    mask_c[1, [0, k // 2]] = 0.0
    mask_c[3, -1] = 0.0
    return dict(spec=spec, prior=prior, img=img, theta=theta, xi=xi, mask_c=mask_c, k=k,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


N_STEPS, FPI, EPS = 2, 3, 0.01
CASES = [(form, beta) for beta in (1.0, 0.7) for form in ("shared", "per_chain")]


def _case_masks(s, form):
    if form == "shared":
        return np.ones((C, s["k"]))
    return s["mask_c"].astype(np.float64)


@functools.cache
def _jax_tile(name):
    """rhmc_trajectory_tile at the shape in float64, one call for every case
    (CASES, C chains each; beta per chain), run op by op: at K = 18 the tile
    unrolls K^2 pair passes and a 54-column Cholesky, which XLA takes some
    minutes to compile.  Returns the case's outputs, (C, K, 3) and (C,)."""
    s = _scene(name)
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("form,beta", CASES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_reference_matches_jax_tile_beyond_b6(name, form, beta):
    """The plain version of B6 and B6c against the JAX type-major tile at a
    shape B6 refuses, both in float64: in float32 the two programs sum the
    log-likelihood of 2500 pixels in other orders, and the energies (about
    8e3 here) differ by some ten float32 spacings, more than TOL's h.  Dead
    slots frozen bit for bit, momentum exactly 0."""
    s = _scene(name)
    k = s["k"]
    assert dispatch.rhmc_full_module(s["tspec"], k)[1] == "B6c"
    want = _jax_tile(name)[(form, beta)]
    mask = _case_masks(s, form)
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    out_t = fr.fused_rhmc_reference(s["tspec"], d(s["img"]), s["tprior"], d(s["theta"]),
                                    d(s["xi"]), EPS, d(mask[0] if form == "shared" else mask),
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


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_hamiltonian_and_derivatives_match_the_xla_route(beta):
    """H, dH/dtheta and dH/dp at 50x50, K = 18 against the JAX package's
    XLA make_rhmc_functions (the route it runs beyond B6's gate), with
    tests/test_torch_rhmc_full.py's tolerances, both in float64 for the
    reason test_reference_matches_jax_tile_beyond_b6 gives.  None depends
    on the momentum's order."""
    s = _scene("50x50 K=18")
    p = 3.0 * s["xi"].astype(np.float64) * s["mask_c"][..., None]
    theta = s["theta"].astype(np.float64)
    mask = s["mask_c"].astype(np.float64)
    with jax.enable_x64(True):
        tpg_j = j_tempered(s["spec"], jnp.asarray(s["img"], jnp.float64), s["prior"])
        jm = j_metric_fn(s["spec"], s["prior"], JITTER)
        ham_j, dhdt_j, dhdp_j = j_rhmc_functions(lambda th, m: tpg_j(th, m, beta)[0],
                                                 lambda th, m: jm(th, m, beta))
        args_j = (jnp.asarray(theta).reshape(C, -1), jnp.asarray(p).reshape(C, -1),
                  jnp.asarray(mask))
        want = [np.asarray(jax.vmap(f)(*args_j)) for f in (ham_j, dhdt_j, dhdp_j)]
    assert want[0].dtype == np.float64
    d = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    tpg_t = make_tempered_potential_and_grad(s["tspec"], d(s["img"]), s["tprior"])
    tm = make_metric_fn(s["tspec"], s["tprior"], JITTER)
    ham_t, dhdt_t, dhdp_t = trhmc.make_rhmc_functions(lambda th, m: tpg_t(th, m, beta)[0],
                                                      lambda th, m: tm(th, m, beta))
    args_t = (d(theta), d(p), d(mask))
    np.testing.assert_allclose(ham_t(*args_t).numpy(), want[0], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(dhdt_t(*args_t).numpy().reshape(C, -1), want[1],
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(dhdp_t(*args_t).numpy().reshape(C, -1), want[2],
                               rtol=1e-4, atol=1e-4)


def test_b6c_wrapper_on_cpu_tensors_is_the_plain_version():
    """make_trajectory(fused=True) gives B6c's wrapper beyond B6's domain;
    on CPU tensors it returns exactly the plain version's outputs."""
    s = _scene("40x72 K=12")
    k = s["k"]
    cfg = trhmc.RHMCConfig(n_leapfrog=2, fixed_point_iters=3)
    args = (_t(s["theta"]), _t(s["xi"]), torch.tensor([0.01, 0.012, 0.009, 0.011]),
            _t(s["mask_c"]), torch.tensor(0.7))
    via_dispatch = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], k, cfg, True)
    direct = frc.make_fused_rhmc(s["tspec"], _t(s["img"]), s["tprior"], k, 2, 3)
    plain = trhmc.make_trajectory(s["tspec"], _t(s["img"]), s["tprior"], k, cfg, False)
    frc.reset_launch_counts()
    want = plain(*args)
    for fused in (via_dispatch, direct):
        for a, b in zip(fused(*args), want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert frc.LAUNCHES == 0


def _spec(h, w):
    return SceneSpec(h, w, 1.5, 20.0)


@pytest.mark.parametrize("h,w,k,kernel", [
    (48, 48, 16, "B6"),     # B6's own edge
    (32, 32, 17, "B6c"),    # one star past B6's catalog
    (49, 49, 16, "B6c"),    # one row and column past B6's field
    (64, 64, 20, "B6c"),
    (128, 96, 40, "B6c"),
    (128, 128, 1, "B6c"),
    (128, 128, 64, "B6c"),  # cfg4's field and K_max, B6c's edge
])
def test_full_metric_kernel_choice(h, w, k, kernel):
    assert dispatch.rhmc_full_module(_spec(h, w), k)[1] == kernel
    for head in ("rhmc", "smc", "transdim"):
        assert dispatch.trajectory_kernel(head, "full", _spec(h, w), k) == kernel


@pytest.mark.parametrize("h,w,k,match", [
    (400, 400, 16, None),
    (256, 256, 48, None),
    (128, 128, 257, None),
    (32, 32, 0, r"\(B6\).*\(B6c\).*K >= 1"),
])
def test_full_metric_beyond_both_domains_names_both_kernels(h, w, k, match):
    """Beyond B6's domain and B4's TPU gate (match None) the full metric runs
    on B6c, as the JAX package runs XLA there; only K < 1 lies beyond both
    kernels, and the choice names both."""
    if match is None:
        assert dispatch.trajectory_kernel("rhmc", "full", _spec(h, w), k) == "B6c"
        assert callable(dispatch.make_rhmc_full(_spec(h, w), torch.zeros((h, w)),
                                                CONFIGS["cfg4_crowded"].prior, k, 2, 2))
        return
    with pytest.raises(ValueError, match=match):
        dispatch.trajectory_kernel("rhmc", "full", _spec(h, w), k)
    with pytest.raises(ValueError, match=match):
        dispatch.make_rhmc_full(_spec(h, w), torch.zeros((h, w)), CONFIGS["cfg4_crowded"].prior,
                                k, 2, 2)


def test_api_resolves_b6c_for_the_full_metric_on_crowded_fields():
    cuda = torch.device("cuda")
    wide = apply_overrides(CONFIGS["cfg1_rhmc"], {"scene.height": 64, "scene.width": 64,
                                                  "n_stars": 20, "kmax": 20})
    cfg4 = apply_overrides(CONFIGS["cfg4_crowded"], {"smc.mutation": "rhmc"})
    cfg5 = apply_overrides(CONFIGS["cfg5_transdim_mcmc"],
                           {"scene.height": 64, "scene.width": 64, "n_stars": 20,
                            "kmax": 24, "tdm.mutation": "rhmc"})
    for cfg in (wide, cfg4, cfg5):
        assert api.resolve_kernel("cuda", cuda, cfg) == "cuda"
        assert dispatch.trajectory_kernel(cfg.head, api._metric_of(cfg), cfg.scene,
                                          cfg.kmax) == "B6c"
    # the presets on B6's scenes keep B6
    for name in ("cfg1_rhmc", "cfg3_transdim_smc"):
        cfg = CONFIGS[name]
        assert dispatch.trajectory_kernel(cfg.head, api._metric_of(cfg), cfg.scene,
                                          cfg.kmax) == "B6"
    # beyond B4's TPU gate too, on kernel=auto and cuda; cuda off a card raises
    huge = dataclasses.replace(wide, scene=wide.scene._replace(height=400, width=400))
    for pref in ("auto", "cuda"):
        assert api.resolve_kernel(pref, cuda, huge) == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        api.resolve_kernel("cuda", torch.device("cpu"), huge)


def test_b6c_shared_memory_and_workspace_follow_its_layout():
    """smem_bytes mirrors smem_floats in csrc/fused_rhmc_crowded.cu: the
    phase region (region_floats), the q coefficient ring of two chunks of
    8 pairs at 12 floats, 67 floats a star and 12 of per-chain scalars;
    workspace_bytes mirrors work_floats after the 4-float header (the chain
    counter): the working field, the three column profile sets, gy'' at the
    odd star stride H | 1, the 18 K^2 pair sums, G^-1 (D^2) and the q
    coefficient table (12 floats a star pair, whole chunks of 8 pairs),
    each rounded up to a multiple of 4 floats."""
    assert [frc.field_stride(w) for w in (1, 4, 49, 72, 128)] == [4, 4, 52, 72, 128]
    assert frc.smem_bytes(64, 128, 128) == 4 * (49312 + 2 * 8 * 12 + 67 * 64 + 12) == 215216
    assert frc.smem_bytes(18, 50, 50) == 4 * (frc.region_floats(18, 50, 50) + 192 + 67 * 18 + 12)
    assert frc.workspace_floats(64, 128, 128) == (128 * 128 + 3 * 64 * 128 + 64 * 129
                                                  + 18 * 4096 + 192 * 192 + 12 * 2080) == 184768
    assert frc.workspace_floats(20, 64, 64) == (64 * 64 + 3 * 20 * 64 + 1300 + 7200 + 3600
                                                + 12 * 216)
    assert frc.workspace_floats(1, 49, 49) == 49 * 52 + 3 * 52 + 52 + 20 + 12 + 12 * 8
    assert all(frc.workspace_floats(k, h, w) % 4 == 0
               for k in (1, 5, 17, 64) for h, w in ((49, 49), (128, 96), (7, 13)))
    # at K = 64 on 128x128 a block works in 0.74 MB of device memory, 97.6
    # MB for a grid of one block on each of an H100's 132 SMs
    assert frc.workspace_bytes(64, 128, 128, 132) == 4 * (4 + 132 * 184768)
    # the shared memory holds every scene of the domain in one block
    assert frc.smem_bytes(frc.MAX_STARS, 128, 128) <= MAX_SMEM_BYTES - 1024
    assert max(frc.smem_bytes(k, h, w) for k in (1, 20, 47, 64)
               for h, w in ((1, 1), (16, 16), (49, 49), (128, 4), (4, 128), (128, 128))) == 215216


@pytest.mark.parametrize("k,h,w,want", [
    # the field phase: 1/lam (or the q field's two operand stages of depth
    # 32 and 16 floats of row ranges, where larger), gy and gy' at the odd
    # star stride, gx and gx' (or gy'')
    (64, 128, 128, 2 * (32 * 256 + 16) + 2 * 8256 + 16384),
    (20, 64, 64, 2 * (32 * 128 + 16) + 2 * 1300 + 2560),
    (47, 128, 128, 2 * (32 * 256 + 16) + 2 * 6064 + 12032),
    # a narrow field: gy'' is wider than gx and gx'
    (8, 128, 4, 2 * (32 * (128 + 8) + 16) + 2 * 1032 + 1032),
    # the dense phase wins at small fields: packed L (D + 1 rows) and L^-1
    (64, 16, 16, 193 * 194 // 2 + 192 * 193 // 2 + 3),
    (1, 1, 1, 2 * (32 * (4 + 8) + 16) + 2 * 4 + 8),
])
def test_b6c_phase_region_holds_the_larger_phase(k, h, w, want):
    """region_floats mirrors the source: the larger of the field phase and
    the dense phase, rounded up to a multiple of 4 floats; the dense phase
    (packed L and L^-1 at D = 3K) always fits, and so do the q field's
    operand stages in 1/lam's slot."""
    assert frc.region_floats(k, h, w) == want
    d = 3 * k
    assert frc.region_floats(k, h, w) >= (d + 1) * (d + 2) // 2 + d * (d + 1) // 2
    hq, wq = frc.q_extent(h, w)
    assert frc.region_floats(k, h, w) >= (2 * (frc.Q_DEPTH * (hq + wq) + 2 * frc.Q_PAIRS)
                                          + 2 * k * (h | 1))


@pytest.mark.parametrize("h,w,extent,tile", [
    (128, 128, (128, 128), (4, 8)),   # cfg4: 32 x 16 tiles, one a thread
    (64, 64, (64, 64), (2, 4)),         # the 64x64 field: 32 x 16 tiles
    (128, 96, (128, 96), (4, 8)),
    (49, 49, (52, 56), (2, 4)),
    (128, 4, (128, 8), (2, 4)),
    (1, 1, (4, 8), (2, 4)),
    (65, 64, (68, 64), (4, 8)),         # 34 x 16 small tiles would exceed 512
])
def test_b6c_q_field_tiles_fill_at_most_the_block(h, w, extent, tile):
    """The q and phi fields' padded extent (rows to 4, columns to 8) and
    the pixel tile a thread holds: 2 x 4 where those tiles number at most
    the block's 512 threads, else 4 x 8, which never number more."""
    assert frc.q_extent(h, w) == extent
    assert frc.q_tile(h, w) == tile
    tr, tc = tile
    assert (extent[0] // tr) * (extent[1] // tc) <= frc.THREADS
    assert extent[0] % tr == 0 and extent[1] % tc == 0


def test_b6c_bound_counts_the_pixels_where_both_profiles_are_non_zero():
    """chip_smoke.rhmc_full_sparse_ops, B6c's bound: with a PSF wide enough
    for every float32 profile to be non-zero on the whole field it is the
    every-pixel count rhmc_full_crowded_ops plus the dense algebra; two
    stars in opposite corners of a 128x128 field share no pixel, so their
    pair terms are left out and only each star's own remain; a dead slot
    counts nothing."""
    import chip_smoke

    n, fpi, h, w = 2, 3, 16, 16
    wide = SceneSpec(h, w, 1000.0, 5.0)
    theta = torch.zeros((2, 3, 3))
    mask = torch.ones(3)
    algebra = 2 * 2 * 9.0 ** 3 * ((1 + n + n * fpi) / 3 + (1 + n) / 3)
    assert chip_smoke.rhmc_full_sparse_ops(theta, mask, wide, n, fpi) == pytest.approx(
        chip_smoke.rhmc_full_crowded_ops(2, 3, h, w, n, fpi) + algebra)
    field = SceneSpec(128, 128, 1.5, 20.0)
    corners = torch.tensor([[[-6.0, -6.0, 5.0], [6.0, 6.0, 5.0], [0.0, 0.0, 5.0]]])
    one = chip_smoke.rhmc_full_sparse_ops(corners[:, :1], torch.ones(1), field, n, fpi)
    two = chip_smoke.rhmc_full_sparse_ops(corners[:, :2], torch.ones(2), field, n, fpi)
    d3_one, d3_two = 2 * 3.0 ** 3, 2 * 6.0 ** 3
    shape = (1 + n + n * fpi) / 3 + (1 + n) / 3
    assert two - d3_two * shape == pytest.approx(2 * (one - d3_one * shape))
    dead = chip_smoke.rhmc_full_sparse_ops(corners, torch.tensor([1.0, 1.0, 0.0]), field, n,
                                           fpi)
    assert dead == pytest.approx(two)


def test_b6c_workspace_header_holds_the_chain_counter():
    """The launch's workspace starts with HEADER_FLOATS floats, the chain
    counter first, before one slice a block; the slices stay 16-byte
    aligned."""
    assert frc.HEADER_FLOATS == 4
    for k, h, w in ((64, 128, 128), (20, 64, 64), (1, 49, 49)):
        assert frc.workspace_bytes(k, h, w, 3) == 4 * (4 + 3 * frc.workspace_floats(k, h, w))
        assert (4 * frc.HEADER_FLOATS) % 16 == 0


@pytest.mark.parametrize("h,w,k", [(128, 128, 64), (128, 128, 1), (128, 96, 64), (49, 49, 16),
                                   (1, 1, 1)])
def test_b6c_domain_takes_its_edges(h, w, k):
    assert frc.domain_error(_spec(h, w), k) is None
    frc.check_domain(_spec(h, w), k)


@pytest.mark.parametrize("h,w,k,match", [
    (128, 128, 257, None),
    (32, 32, 0, "takes K >= 1, got K=0"),
    (400, 400, 8, None),
    (256, 256, 48, None),
    (128, 128, 10923, None),
])
def test_b6c_domain_rejects_beyond_its_edges(h, w, k, match):
    """The old edges (K = 256, B4's TPU gate; the last K whose 18 K^2 pair
    sums a 32-bit index reached) are gone: B6c takes every scene and K >= 1;
    below, the error names it (match)."""
    err = frc.domain_error(_spec(h, w), k)
    if match is None:
        assert err is None
        frc.check_domain(_spec(h, w), k)
        return
    assert err is not None and "(B6c)" in err and match in err
    with pytest.raises(ValueError, match="B6c"):
        frc.check_domain(_spec(h, w), k)
