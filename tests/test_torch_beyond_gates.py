"""The port beyond the TPU kernels' VMEM gates, where the JAX package runs
XLA (starcat/api.py:44-53) and the port its crowded-field kernels B5, B4
and B6c.  The kernel choice on a grid of fields up to 512 x 512 and
catalogs up to K = 1000: every shape names a CUDA kernel of the head's pair
and kernel=auto resolves to it on a card; B6c's shared memory and
workspace mirrors at the new catalogs.  The plain versions (what the
wrappers run on the CPU and what chip_smoke.py holds the kernels against on
the card) against the JAX package's XLA route beyond each gate, both in
float64: B5's against starcat/integrators.py's leapfrog on
make_potential_and_grad at 128x128 with K = 700; B4's against rhmc_step's
generalised leapfrog over make_rhmc_diag_functions and the diagonal metric
(starcat/rhmc.py:109, :135, starcat/metric.py:93) at 256x256 with K = 64;
B6c's Hamiltonian and its derivatives against make_rhmc_functions at
K = 260 on 24x24.  One cfg4-shaped SMC temperature step with the diagonal
mutation on a 256x64 field at K_max 128, beyond B4's gate, fed the JAX
keys' own draws, against the JAX package's XLA step."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat import pallas_mxu as pmx
from starcat import pallas_rhmc_diag as prd
from starcat import smc as jsmc
from starcat.integrators import leapfrog as j_leapfrog
from starcat.integrators import riemannian_leapfrog as j_riemannian_leapfrog
from starcat.metric import make_diag_metric_fn as j_diag_metric_fn
from starcat.metric import make_metric_fn as j_metric_fn
from starcat.potential import make_potential_and_grad as j_potential_and_grad
from starcat.potential import make_tempered_potential_and_grad as j_tempered
from starcat.rhmc import make_rhmc_diag_functions as j_rhmc_diag_functions
from starcat.rhmc import make_rhmc_functions as j_rhmc_functions
from starcat.transdim import TransDimConfig as JTransDimConfig
from starcat_torch import api, dispatch, smc
from starcat_torch import fused_leapfrog_crowded as flc
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
from starcat_torch.fused_leapfrog import fused_leapfrog_reference
from starcat_torch.fused_rhmc_diag import fused_rhmc_diag_reference
from starcat_torch.metric import make_metric_fn
from starcat_torch.potential import make_tempered_potential_and_grad
from starcat_torch.scene import SceneSpec

from jax_draws import jax_step_draws

torch.set_num_threads(1)

JITTER = 1e-3


def _spec(h, w):
    return SceneSpec(h, w, 1.5, 20.0)


def _b5_gate(h, w, k):
    return pmx.mxu_fused_supported(starcat.SceneSpec(h, w, 1.5, 20.0), k, 8)


def _b4_gate(h, w, k):
    js = starcat.SceneSpec(h, w, 1.5, 20.0)
    return prd.diag_mxu_supported(js, k, 8) or prd.diag_fused_supported(js, k, 1024)


# -- (a) the kernel choice on the grid ------------------------------------------

# the catalogs: both sides of every old edge (B1/B3/B6's 16, B6c's one-tile
# 64, the one-tile caps 78 / 128, B5's gate at 256x256 and 128x128, B4's at
# 256x256 and 128x128, B6c's old 256, its full-panel 347 and shared-vector
# 615 paths) and up to 1000
GRID_K = (1, 16, 17, 47, 48, 64, 65, 78, 79, 128, 129, 183, 184, 254, 255, 256, 257, 300,
          347, 348, 615, 616, 667, 668, 700, 1000)
GRID_SIDES = tuple(range(8, 513, 8))
PAIRS = (("hmc", None, ("B1", "B5")), ("chees", None, ("B2", "B5")),
         ("smc", "diag", ("B3", "B4")), ("rhmc", "full", ("B6", "B6c")))


@pytest.mark.parametrize("h", GRID_SIDES)
def test_every_field_and_catalog_of_the_grid_runs_on_a_kernel_of_the_pair(h):
    """At every H x W on 8-pixel steps up to 512 x 512 and every K of
    GRID_K, each head's trajectory names a CUDA kernel of its pair, the
    crowded-field one beyond the small-scene kernel's domain, whether the
    TPU kernel's gate takes the shape or not; nothing raises."""
    for w in GRID_SIDES:
        spec = _spec(h, w)
        for k in GRID_K:
            small = h * w <= 48 * 48 and k <= 16
            for head, metric, names in PAIRS:
                got = dispatch.trajectory_kernel(head, metric, spec, k)
                assert got in names and (small or got == names[1]), (h, w, k, head, got)
            assert flc.domain_error(spec, k) is None
            assert frdc.domain_error(spec, k) is None
            assert frc.domain_error(spec, k) is None


# beyond every old edge: (H, W, K) that the TPU gates refused, and the
# JAX package's own examples (a 512x512 field, K = 1000 on 128x128)
BEYOND = ((256, 256, 256), (256, 256, 200), (512, 512, 64), (512, 512, 32),
          (128, 128, 1000), (128, 128, 668), (128, 128, 300), (512, 8, 1000))


@pytest.mark.parametrize("h,w,k", BEYOND)
def test_kernel_auto_resolves_to_cuda_beyond_the_tpu_gates(h, w, k):
    """Every head's config at these shapes resolves kernel=auto (and cuda)
    to the CUDA kernel on a card and to the plain version on the CPU;
    kernel=cuda off a card still raises.  At least one TPU gate refused
    each shape."""
    assert not (_b5_gate(h, w, k) and _b4_gate(h, w, k))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    over = {"scene.height": h, "scene.width": w, "n_stars": min(k, 50), "kmax": k}
    cfgs = [apply_overrides(CONFIGS["cfg4_crowded"], over),
            apply_overrides(CONFIGS["cfg4_crowded"], {**over, "smc.mutation": "rhmc"}),
            apply_overrides(CONFIGS["cfg1_rhmc"], over),
            apply_overrides(CONFIGS["cfg1_rhmc"], {**over, "rhmc.metric": "diag"}),
            apply_overrides(CONFIGS["cfg4_crowded"], {**over, "head": "chees"}),
            apply_overrides(CONFIGS["cfg4_crowded"], {**over, "head": "hmc"}),
            apply_overrides(CONFIGS["cfg5_transdim_mcmc"], over)]
    for cfg in cfgs:
        assert api.resolve_kernel("auto", cuda, cfg) == "cuda"
        assert api.resolve_kernel("cuda", cuda, cfg) == "cuda"
        assert api.resolve_kernel("auto", cpu, cfg) == "torch"
        with pytest.raises(ValueError, match="needs a CUDA device"):
            api.resolve_kernel("cuda", cpu, cfg)
        assert dispatch.trajectory_kernel(cfg.head, api._metric_of(cfg), cfg.scene,
                                          cfg.kmax) in ("B4", "B5", "B6c")


@pytest.mark.parametrize("head,metric,pattern", [
    ("hmc", None, r"\(B1/B2\).*\(B5\) takes K >= 1, got K=0"),
    ("smc", "diag", r"\(B3\).*\(B4\) takes K >= 1, got K=0"),
    ("rhmc", "full", r"\(B6\).*\(B6c\) takes K >= 1, got K=0"),
])
def test_only_an_empty_catalog_raises(head, metric, pattern):
    """K < 1 raises naming both kernels of the pair, on every field; K =
    10923, past the full metric's old 32-bit pair-sum index, runs on the
    crowded-field kernel of every pair."""
    for h, w in ((8, 8), (512, 512)):
        with pytest.raises(ValueError, match=pattern):
            dispatch.trajectory_kernel(head, metric, _spec(h, w), 0)
    want = ("B6c",) if metric == "full" else ("B4", "B5")
    assert dispatch.trajectory_kernel(head, metric, _spec(128, 128), 10923) in want


# -- (b) B6c's sizes beyond K = 256 ----------------------------------------------

def test_b6c_shared_memory_fits_a_block_at_every_catalog():
    """wide_smem_bytes stays within the card's shared memory less 1 KB of
    static arrays at every K up to 2048: the whole Cholesky panel up to
    K = 347, a region of the q field's two operand stages beyond it (the
    streamed panel's top block and 448-row block, 33 x 480 floats, fit
    there); the per-star vectors in shared memory up to K = 615."""
    budget = MAX_SMEM_BYTES - 1024
    assert all(frc.wide_smem_bytes(k) <= budget for k in range(1, 2049))
    assert frc.full_panel(347) and not frc.full_panel(348)
    assert frc.vectors_in_shared(615) and not frc.vectors_in_shared(616)
    assert all(frc.full_panel(k) for k in range(1, 348))
    assert all(frc.vectors_in_shared(k) for k in range(1, 616))
    stages = 2 * (32 * 256 + 16)
    assert frc.wide_region_floats(348) == stages >= 33 * (32 + 448)
    assert frc.wide_smem_bytes(348) == 4 * (stages + 192 + 67 * 348 + 12)
    assert frc.wide_smem_bytes(616) == frc.wide_smem_bytes(2048) == 4 * (stages + 192)
    # up to K = 256 the sizes are the old ones
    assert frc.wide_smem_bytes(256) == 4 * (25380 + 192 + 67 * 256 + 12)


def test_b6c_workspace_sizes_are_exact_past_two_to_the_31():
    """wide_workspace_floats mirrors wide::work_floats in 64 bits: beyond
    K = 347 it adds the streamed panel's rows (32 (D + 1)), beyond K = 615
    the per-star vectors (67 K + 12, rounded up to 4); the sizes are exact
    ints, and a full grid's workspace passes 2^31 floats (at K = 1000 on
    128x128, 47.5 M floats, 190 MB, a block)."""
    def r4(n):
        return (n + 3) // 4 * 4

    k, h, w, d = 1000, 128, 128, 3000
    pairs = (k * (k + 1) // 2 + 7) // 8 * 8
    base = (2 * h * 128 + r4(2 * k * 129) + 3 * k * 128 + r4(k * 129) + r4(18 * k * k)
            + r4(d * d) + 12 * pairs + r4((d + 1) * (d + 2) // 2) + r4(d * d) + r4(2 * k))
    assert frc.wide_workspace_floats(k, h, w) == base + 32 * (d + 1) + r4(67 * k + 12)
    assert frc.wide_workspace_floats(k, h, w) == 47479364
    assert frc.wide_workspace_floats(300, 128, 128) % 4 == 0
    for kk in (300, 347, 348, 615, 616, 700, 1000, 2048):
        per = frc.launch_workspace_floats(kk, 128, 128)
        assert isinstance(per, int) and per % 4 == 0
        assert frc.workspace_bytes(kk, 128, 128, 132) == 4 * (4 + 132 * per)
    assert 132 * frc.launch_workspace_floats(1000, 128, 128) > 2**31
    assert frc.workspace_bytes(2048, 512, 512, 132) > 4 * 2**31
    # the grid follows the card's free memory: a full grid's slices take at
    # most WORKSPACE_SHARE of it, and at least one block runs
    slice_bytes = 4 * frc.launch_workspace_floats(1000, 128, 128)
    assert frc.memory_grid(1000, 128, 128, 80 * 10**9) == int(0.5 * 80e9) // slice_bytes == 210
    assert frc.memory_grid(1000, 128, 128, 10 * 10**9) == 26
    assert frc.memory_grid(1000, 128, 128, 10**6) == 1


# -- (b2) the full metric at every catalog the card holds ------------------------

INT32_MAX = 2**31 - 1
# where B6c's slice offsets pass 32 bits: the 18 K^2 pair sums, the D x D
# matrices (D (D + 1), D = 3 K) and the q coefficient table (6 K^2)
PAIR_SUMS_K = math.isqrt(INT32_MAX // 18) + 1
DENSE_K = next(k for k in range(15000, 16000) if 3 * k * (3 * k + 1) > INT32_MAX)
COEF_K = next(k for k in range(18000, 20000) if 6 * k * (k + 1) > INT32_MAX)
# the last K whose pair sums a 32-bit index reached, the first past it, the
# first past the dense matrices' threshold, and near the largest slice an
# 80 GB card holds at 128x128
LARGE_K = (PAIR_SUMS_K - 1, PAIR_SUMS_K, DENSE_K, 21000)


def test_the_thresholds_are_where_the_source_says():
    """The K at which each of B6c's slice arrays passes 2^31 - 1 floats:
    plane 17's last pair sum at K = 10923, D (D + 1) at K = 15447 (D =
    46341), the q coefficient table (and G^-1's star blocks 2 K D rows
    apart) at K = 18919; each array fits at the K before.  The fields and
    profiles, addressed in 32 bits, pass it only on fields of about 10^9
    pixels."""
    assert (PAIR_SUMS_K, DENSE_K, COEF_K) == (10923, 15447, 18919)
    for k, size in ((PAIR_SUMS_K, lambda k: 18 * k * k),
                    (DENSE_K, lambda k: 3 * k * (3 * k + 1)),
                    (COEF_K, lambda k: 12 * ((k * (k + 1) // 2 + 7) // 8 * 8))):
        assert size(k) > INT32_MAX >= size(k - 1) - 1
    # the fields and profiles stay in 32 bits but on fields of about 10^9
    # pixels, where a launch raises rather than wrap
    assert frc.wide_fields_in_32_bits(21000, 512, 512)
    assert frc.wide_fields_in_32_bits(1, 32000, 32000)
    assert not frc.wide_fields_in_32_bits(1, 32767, 32767)


@pytest.mark.parametrize("k", LARGE_K)
@pytest.mark.parametrize("h,w", ((8, 8), (128, 128), (512, 512)))
def test_the_full_metric_runs_on_b6c_at_every_catalog(h, w, k):
    """The full metric's trajectory (the rhmc head, SMC's and trans-d's rhmc
    mutation) names B6c at K up to 21000 on every field, and kernel=auto and
    cuda resolve to the kernel on a card: nothing gives way to the plain
    version; only the workspace's allocation can refuse, past the card's
    memory."""
    spec = _spec(h, w)
    assert frc.domain_error(spec, k) is None
    assert dispatch.trajectory_kernel("rhmc", "full", spec, k) == "B6c"
    cuda = torch.device("cuda")
    over = {"scene.height": h, "scene.width": w, "n_stars": 50, "kmax": k}
    cfgs = [apply_overrides(CONFIGS["cfg1_rhmc"], over),
            apply_overrides(CONFIGS["cfg4_crowded"], {**over, "smc.mutation": "rhmc"}),
            apply_overrides(CONFIGS["cfg5_transdim_mcmc"], {**over, "tdm.mutation": "rhmc"})]
    for cfg in cfgs:
        assert api._metric_of(cfg) == "full"
        assert dispatch.trajectory_kernel(cfg.head, "full", cfg.scene, cfg.kmax) == "B6c"
        assert api.resolve_kernel("auto", cuda, cfg) == "cuda"
        assert api.resolve_kernel("cuda", cuda, cfg) == "cuda"


@pytest.mark.parametrize("k", LARGE_K)
def test_b6c_sizes_at_the_largest_catalogs_are_exact(k):
    """At K up to 21000 on 128x128: the streamed panel and the per-star
    vectors in the slice, the shared memory of the stages and the ring, the
    workspace by exact integer formulas (past 2^31 floats), the grid one
    block on an 80 GB card (WORKSPACE_SHARE of 80 GB holds no whole slice)
    and more where more is free, the largest catalog that just this slice
    holds this K, and the probe's corners inside the slice, each past 2^31
    - 1 where its array passes it."""
    def r4(n):
        return (n + 3) // 4 * 4

    h = w = 128
    d, hp = 3 * k, h | 1
    pairs = (k * (k + 1) // 2 + 7) // 8 * 8
    assert not frc.full_panel(k) and not frc.vectors_in_shared(k)
    assert frc.wide_smem_bytes(k) == 4 * (2 * (32 * 256 + 16) + 192)
    want = (2 * h * w + r4(2 * k * hp) + 3 * k * w + r4(k * hp) + r4(18 * k * k) + r4(d * d)
            + 12 * pairs + r4((d + 1) * (d + 2) // 2) + r4(d * d) + r4(2 * k)
            + 32 * (d + 1) + r4(67 * k + 12))
    floats = frc.wide_workspace_floats(k, h, w)
    assert floats == want and floats > INT32_MAX
    assert frc.workspace_bytes(k, h, w, 1) == 4 * (4 + want)
    assert frc.memory_grid(k, h, w, 80 * 10**9) == 1
    assert frc.memory_grid(20000, h, w, 80 * 10**9) == frc.memory_grid(40000, h, w, 80 * 10**9) == 1
    assert frc.memory_grid(k, h, w, 10**6) == 1
    assert frc.memory_grid(k, h, w, 400 * 10**9) == max(1, 200 * 10**9 // (4 * want))
    # the largest catalog a card with just this slice free holds is this one
    assert frc.largest_kmax(h, w, 4 * (4 + want)) == k
    assert frc.largest_kmax(h, w, 4 * (4 + want) - 1) == k - 1
    assert frc.wide_fields_in_32_bits(k, h, w)
    off = frc.probe_offsets(k, h, w)
    assert len(off) == len(frc.PROBE_CORNERS)
    assert all(4 <= o < 4 + floats for o in off)
    lay = frc.wide_layout(k, h, w)
    # each corner's offset within its array, past 32 bits where the array is
    within = {1: (off[1] - 4 - lay["sraw"], 18 * k * k - 1),
              6: (off[6] - 4 - lay["linv"], d * d - 1),
              8: (off[8] - 4 - lay["ginv"], d * d - 1),
              10: (off[10] - 4 - lay["qcoef"], 12 * pairs - 1)}
    for n, (got, last) in within.items():
        assert got == last
    assert (18 * k * k - 1 > INT32_MAX) == (k >= PAIR_SUMS_K)
    assert (d * d - 1 > INT32_MAX) == (k >= DENSE_K)


@pytest.mark.parametrize("d", (3, 96, 2100, 3 * PAIR_SUMS_K, 3 * DENSE_K, 63000))
def test_packed_column_steps_are_exact_in_32_bits(d):
    """B6c's streamed Cholesky takes its panel's first column's offset in 64
    bits (col_off) and the steps to the panel's other columns in 32
    (col_step): col_off(c + k) - col_off(c) - k = k (n - c - 1) - k (k -
    1) / 2 below 2^31, for every panel of a D-parameter factor (n = D + 1
    rows)."""
    n = d + 1

    def col_off(c):
        return c * n - c * (c - 1) // 2

    for p0 in sorted({0, 32, (d - 1) // 32 * 32, max(0, d - 33) // 32 * 32}):
        for k in range(min(32, d - p0)):
            step = k * (n - p0 - 1) - k * (k - 1) // 2
            assert col_off(p0 + k) - (p0 + k) - (col_off(p0) - p0) == step
            assert 0 <= step <= 32 * n < INT32_MAX
    assert col_off(d - 1) + 1 == (d + 1) * (d + 2) // 2 - 2


# -- (c) the plain versions against the JAX package's XLA route ------------------

def _d(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@functools.cache
def _scene(h, w, k, c, seed):
    """A mock h x w scene of k stars, c chains near the truth, momenta or
    xi, and per-chain masks with a dead slot on chain 1 and two on the
    last."""
    spec = starcat.SceneSpec(h, w, 1.5, 5.0)
    prior = starcat.PriorSpec(4.0, 0.7)
    truth = starcat.sample_prior(jax.random.key(seed), k, starcat.PriorSpec(5.0, 0.3))
    x, y, f = starcat.constrain(truth, spec)
    img = np.asarray(starcat.make_mock_image(jax.random.key(seed + 1), x, y, f, spec),
                     np.float64)
    rng = np.random.default_rng(seed)
    theta = np.asarray(truth, np.float64)[None] + 0.05 * rng.standard_normal((c, k, 3))
    p = rng.standard_normal((c, k, 3))
    mask = np.ones((c, k))
    mask[1, k // 3] = 0.0
    mask[-1, [0, k - 1]] = 0.0
    return dict(spec=spec, prior=prior, img=img, theta=theta, p=p, mask=mask,
                tspec=spec_from_jax(spec), tprior=prior_from_jax(prior))


@pytest.mark.parametrize("form", ["shared", "per_chain"])
def test_b5_reference_matches_the_xla_leapfrog_at_k_700(form):
    """B5's plain version (fused_leapfrog_reference) at 128x128 with K = 700
    (beyond the TPU gate's 667), 2 chains, L = 2, per-chain eps, against
    starcat.integrators.leapfrog over make_potential_and_grad, both in
    float64: theta to 1e-9, p and the gradient to 1e-7 relative to
    1 + |x|, U to 1e-9 relative (sums of 16384 pixels in two orders)."""
    h, w, k, c = 128, 128, 700, 2
    s = _scene(h, w, k, c, 21)
    assert not _b5_gate(h, w, k)
    assert dispatch.trajectory_kernel("hmc", None, s["tspec"], k) == "B5"
    mask = s["mask"] if form == "per_chain" else np.ones((c, k))
    p = s["p"] * mask[..., None]
    eps = np.array([0.004, 0.005])
    inv_mass = np.full((k, 3), 0.8)
    with jax.enable_x64(True):
        pg = j_potential_and_grad(s["spec"], jnp.asarray(s["img"]), s["prior"])

        def one(th, pp, m, e):
            u, g = pg(th, m)
            return j_leapfrog(lambda t: pg(t, m), th, pp, u, g, e, 2, jnp.asarray(inv_mass))

        want = [np.asarray(o) for o in jax.jit(jax.vmap(one))(
            jnp.asarray(s["theta"]), jnp.asarray(p), jnp.asarray(mask), jnp.asarray(eps))]
    tmask = _d(mask if form == "per_chain" else mask[0])
    got = [o.numpy() for o in fused_leapfrog_reference(
        s["tspec"], _d(s["img"]), s["tprior"], _d(s["theta"]), _d(p), _d(eps),
        _d(inv_mass), tmask, 2)]
    assert got[0].dtype == np.float64 and want[0].dtype == np.float64
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    np.testing.assert_array_less(np.abs(got[1] - want[1]), 1e-7 * (1.0 + np.abs(want[1])))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)
    np.testing.assert_array_less(np.abs(got[3] - want[3]), 1e-7 * (1.0 + np.abs(want[3])))
    if form == "per_chain":
        dead = mask == 0
        np.testing.assert_array_equal(got[0][dead], s["theta"][dead])


def test_b4_reference_matches_the_xla_diagonal_rhmc_at_256():
    """B4's plain version (fused_rhmc_diag_reference) at 256x256 with K = 64
    (beyond the TPU gates' 47), 2 chains with per-chain masks, one step of
    two sweeps at beta 0.7, against the XLA route's pieces as rhmc_step
    puts them together: p0 = sqrt(g) xi m from make_diag_metric_fn, the
    generalised leapfrog over make_rhmc_diag_functions on the tempered
    potential, H at both ends, U(theta') and the solver residual, both in
    float64: theta to 1e-9, p to 1e-7 relative to 1 + |p|, the energies to
    1e-9 relative, the residual to 1e-9; dead slots frozen."""
    h, w, k, c, beta = 256, 256, 64, 2, 0.7
    s = _scene(h, w, k, c, 23)
    assert not _b4_gate(h, w, k)
    assert dispatch.trajectory_kernel("smc", "diag", s["tspec"], k) == "B4"
    eps = np.array([0.01, 0.012])
    with jax.enable_x64(True):
        tpg = j_tempered(s["spec"], jnp.asarray(s["img"]), s["prior"])
        dm = j_diag_metric_fn(s["spec"], s["prior"], JITTER)
        pfn = lambda th, m: tpg(th, m, beta)[0]  # noqa: E731
        dmb = lambda th, m: dm(th, m, beta)  # noqa: E731
        ham, dhdt, dhdp = j_rhmc_diag_functions(pfn, dmb)

        def one(th, xi, m, e):
            th0 = th.reshape(-1)
            p0 = jnp.sqrt(dmb(th, m)) * xi.reshape(-1) * jnp.repeat(m, 3)
            res = j_riemannian_leapfrog(lambda t, pp: dhdt(t, pp, m),
                                        lambda t, pp: dhdp(t, pp, m), th0, p0, e, 1, 2)
            return (res.theta.reshape(-1, 3), res.p.reshape(-1, 3), ham(th0, p0, m),
                    ham(res.theta, res.p, m), pfn(res.theta.reshape(-1, 3), m),
                    res.solver_resid)

        want = [np.asarray(o) for o in jax.jit(jax.vmap(one))(
            jnp.asarray(s["theta"]), jnp.asarray(s["p"]), jnp.asarray(s["mask"]),
            jnp.asarray(eps))]
    got = [o.numpy() for o in fused_rhmc_diag_reference(
        s["tspec"], _d(s["img"]), s["tprior"], _d(s["theta"]), _d(s["p"]), _d(eps),
        _d(s["mask"]), beta, 1, 2, JITTER)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
    np.testing.assert_array_less(np.abs(got[1] - want[1]), 1e-7 * (1.0 + np.abs(want[1])))
    for g_, w_ in zip(got[2:5], want[2:5]):
        np.testing.assert_allclose(g_, w_, rtol=1e-9)
    np.testing.assert_allclose(got[5], want[5], rtol=0, atol=1e-9)
    dead = s["mask"] == 0
    np.testing.assert_array_equal(got[0][dead], s["theta"][dead])
    assert not got[1][dead].any()


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_b6c_hamiltonian_and_derivatives_match_the_xla_route_at_k_260(beta):
    """B6c's plain version's pieces at K = 260 (beyond the old K <= 256, D
    = 780) on 24x24: H, dH/dtheta and dH/dp from make_rhmc_functions over
    the tempered potential and the dense metric, against the JAX package's
    XLA make_rhmc_functions, 2 chains with per-chain masks, both in
    float64, with tests/test_torch_rhmc_full_crowded.py's tolerances (H to
    1e-6 relative or 2e-3, dH/dtheta to 1e-4 relative or 2e-3, dH/dp to
    1e-4 relative or 1e-4)."""
    h, w, k, c = 24, 24, 260, 2
    s = _scene(h, w, k, c, 25)
    assert dispatch.trajectory_kernel("rhmc", "full", s["tspec"], k) == "B6c"
    assert not frc.one_tile(k, h, w) and frc.full_panel(k)
    p = 3.0 * s["p"] * s["mask"][..., None]
    with jax.enable_x64(True):
        tpg_j = j_tempered(s["spec"], jnp.asarray(s["img"]), s["prior"])
        jm = j_metric_fn(s["spec"], s["prior"], JITTER)
        fns = j_rhmc_functions(lambda th, m: tpg_j(th, m, beta)[0],
                               lambda th, m: jm(th, m, beta))
        want = [np.asarray(jax.jit(jax.vmap(f))(
            jnp.asarray(s["theta"]).reshape(c, -1), jnp.asarray(p).reshape(c, -1),
            jnp.asarray(s["mask"]))) for f in fns]
    tpg_t = make_tempered_potential_and_grad(s["tspec"], _d(s["img"]), s["tprior"])
    tm = make_metric_fn(s["tspec"], s["tprior"], JITTER)
    ham_t, dhdt_t, dhdp_t = trhmc.make_rhmc_functions(lambda th, m: tpg_t(th, m, beta)[0],
                                                      lambda th, m: tm(th, m, beta))
    args = (_d(s["theta"]), _d(p), _d(s["mask"]))
    np.testing.assert_allclose(ham_t(*args).numpy(), want[0], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(dhdt_t(*args).numpy().reshape(c, -1), want[1], rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(dhdp_t(*args).numpy().reshape(c, -1), want[2], rtol=1e-4,
                               atol=1e-4)


# -- (d) one cfg4-shaped SMC step beyond B4's gate --------------------------------

P, K_MAX = 8, 128
SPEC_J = starcat.SceneSpec(256, 64, 1.5, 20.0)
PRIOR_J = starcat.PriorSpec(5.0, 0.7)


def test_diag_smc_step_beyond_b4s_gate_matches_jax_on_its_draws():
    """One step from the prior population of a 256x64 field at K_max 128
    (B4's TPU gates take K <= 89 there; the JAX package runs the XLA
    diagonal mutation, the port B4's wide path on a card): beta by
    bisection, logZ, resampling, two sweeps with residual-driven births,
    two diagonal-Fisher mutations, the eps controller and the
    log-likelihood refresh, on the JAX keys' own draws.  Bounds as
    tests/test_torch_wide_fields.py's 136-row step: beta to 1e-5
    relative, logZ to 1e-5 relative or 1e-3, the masks exactly, theta to
    1e-4, the log-likelihoods to 1e-5 relative or 2e-3, the mean accept to
    5e-3; eps, which the controller moves by exp(0.3 (accept - target)),
    to the accept's bound carried through it, 1.5e-3 relative (the 136-row
    step holds 1e-4; here 16 float32 energies over 16384 pixels put the
    two accepts 3.7e-4 apart)."""
    truth = starcat.sample_prior(jax.random.key(0), 6, starcat.PriorSpec(6.0, 0.3))
    x, y, f = starcat.constrain(truth, SPEC_J)
    img = starcat.make_mock_image(jax.random.key(1), x, y, f, SPEC_J)
    cfg_j = jsmc.SMCConfig(n_particles=P, mutation="rhmc_diag", n_mutation_steps=2,
                           n_leapfrog=3, fixed_point_iters=3, n_transdim_sweeps=2,
                           step_size0=0.05,
                           transdim=JTransDimConfig(lam_count=2.0, birth_proposal="residual"))
    tspec = spec_from_jax(SPEC_J)
    assert not _b4_gate(256, 64, K_MAX)
    assert dispatch.trajectory_kernel("smc", "diag", tspec, K_MAX) == "B4"
    st0 = jsmc.init_smc(jax.random.key(4), SPEC_J, img, PRIOR_J, K_MAX, cfg_j)
    st1 = jsmc.make_smc_step(SPEC_J, img, PRIOR_J, cfg_j)(st0)
    cfg = smc_config_from_jax(cfg_j)
    assert cfg.mutation == "rhmc_diag"
    tst0 = smc_state_from_numpy(st0.theta, st0.mask, st0.loglik, st0.beta, st0.log_z,
                                st0.eps, st0.n_steps, st0.mean_accept, st0.final_done, "cpu")
    step = smc.make_smc_step(tspec, torch.from_numpy(np.array(img, np.float32)),
                             prior_from_jax(PRIOR_J), K_MAX, cfg)
    tst1 = step(tst0, jax_step_draws(st0.key, cfg_j, K_MAX, SPEC_J.height * SPEC_J.width))
    assert float(tst1.beta) == pytest.approx(float(st1.beta), rel=1e-5)
    assert 0.0 < float(tst1.beta) < 1.0
    assert float(tst1.log_z) == pytest.approx(float(st1.log_z), rel=1e-5, abs=1e-3)
    np.testing.assert_array_equal(tst1.mask.numpy(), np.asarray(st1.mask))
    np.testing.assert_allclose(tst1.theta.numpy(), np.asarray(st1.theta), atol=1e-4)
    np.testing.assert_allclose(tst1.loglik.numpy(), np.asarray(st1.loglik), rtol=1e-5, atol=2e-3)
    assert float(tst1.mean_accept) == pytest.approx(float(st1.mean_accept), abs=5e-3)
    assert float(tst1.eps) == pytest.approx(float(st1.eps), rel=1.5e-3)
    assert 0.0 < float(tst1.mean_accept) <= 1.0
