"""B1/B2's launch geometry as the wrapper sees it: smem_bytes mirrors the
shared-memory layout of csrc/fused_leapfrog.cu term by term, domain_error
takes every scene and catalog that the first B1 design took, each preset
scene gets the column tile, star pad and warps a chain that the source's
Tile<> gives it, and a scene wider than 48 columns is held transposed,
which the plain version shows changes nothing.  The kernel itself runs only
on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from starcat_torch import dispatch
from starcat_torch import fused_leapfrog as fl
from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.configs import CONFIGS
from starcat_torch.potential import PriorSpec
from starcat_torch.scene import SceneSpec


def _spec(h, w):
    return SceneSpec(h, w, 1.5, 10.0)


def _first_design_bytes(k, h, w):
    """The first B1 design's layout (one block of 256 threads a chain): 19 K
    floats of state, 8 + 1 of reductions, the image and the residual field,
    gx (K, W) and gy, gy z (K, H)."""
    return 4 * (19 * k + 8 + 1 + 2 * h * w + k * (w + 2 * h))


@pytest.mark.parametrize("name,tile", [
    ("cfg0_single_star", dict(rows=16, cols=16, transposed=False, column_tile=16, star_pad=4,
                              warps_per_chain=1)),
    ("cfg6_chees", dict(rows=32, cols=32, transposed=False, column_tile=32, star_pad=10,
                        warps_per_chain=2)),
    ("cfg1_rhmc", dict(rows=32, cols=32, transposed=False, column_tile=32, star_pad=10,
                       warps_per_chain=2)),
    ("cfg5_transdim_mcmc", dict(rows=32, cols=32, transposed=False, column_tile=32,
                                star_pad=16, warps_per_chain=2)),
])
def test_each_preset_scene_gets_its_tile(name, tile):
    """The presets' scenes in B1's domain: cfg0 (16x16, K = 1) in the
    16-column tile, a warp a chain; the flagship scene (cfg6's K = 10, and
    cfg5's K_max 16, the trans-d hmc move's) in the 32-column tile, two
    warps a chain."""
    cfg = CONFIGS[name]
    assert fl.launch_tile(cfg.scene.height, cfg.scene.width, cfg.kmax) == tile
    assert dispatch.leapfrog_module(cfg.scene, cfg.kmax)[1] == "B1"


@pytest.mark.parametrize("h,w,k,tile", [
    (48, 48, 16, (48, 48, False, 48, 16, 1)),
    (40, 48, 16, (40, 48, False, 48, 16, 1)),
    (20, 48, 7, (20, 48, False, 48, 8, 1)),
    (24, 96, 16, (96, 24, True, 32, 16, 2)),     # wider than 48: transposed
    (96, 24, 16, (96, 24, False, 32, 16, 2)),
    (1, 2304, 3, (2304, 1, True, 16, 4, 1)),
    (2304, 1, 13, (2304, 1, False, 16, 16, 1)),
    (17, 33, 9, (17, 33, False, 48, 10, 1)),
    (17, 33, 11, (17, 33, False, 48, 12, 1)),
])
def test_tile_of_other_scenes(h, w, k, tile):
    t = fl.launch_tile(h, w, k)
    assert (t["rows"], t["cols"], t["transposed"], t["column_tile"], t["star_pad"],
            t["warps_per_chain"]) == tile


def test_column_tile_star_pad_and_image_stride():
    assert [fl.column_tile(c) for c in (1, 16, 17, 32, 33, 48)] == [16, 16, 32, 32, 48, 48]
    pads = [4] * 4 + [8] * 4 + [10] * 2 + [12] * 2 + [16] * 4
    assert [fl.star_pad(k) for k in range(1, 17)] == pads
    for cols in range(1, 49):
        s = fl.image_stride(cols)
        # the least stride >= cols that is 2 mod 4: rows 8 apart in other banks
        assert s >= cols and s % 4 == 2 and s - 4 < cols
        assert (8 * s) % 32 == 16


def test_shared_memory_follows_the_layout():
    """The image in the kernel's frame (rows x a stride of 2 mod 4, to a
    multiple of 4 floats), each chain's row profiles gyw and gywz (star pad
    x CHUNK rows, split between its warps) and, with two warps a chain,
    each chain's exchange (two buffers of a 50-float slot a warp)."""
    chains, chunk, exch = fl.CHAINS_PER_BLOCK, fl.CHUNK, fl.EXCH
    assert (chains, chunk, exch) == (4, 48, 50)
    # the flagship: 32 rows at a stride of 34, K = 10 (a pad of its own), two warps
    assert fl.smem_bytes(10, 32, 32) == 4 * (32 * 34 + chains * 2 * 10 * chunk
                                             + chains * 2 * 2 * exch) == 22912
    assert fl.smem_bytes(11, 32, 32) == 4 * (32 * 34 + chains * 2 * 12 * chunk
                                             + chains * 2 * 2 * exch)
    # cfg0: 16 rows at 18, K = 1 padded to 4, one warp, no exchange
    assert fl.smem_bytes(1, 16, 16) == 4 * (16 * 18 + chains * 2 * 4 * chunk) == 7296
    # the 48-column tile at the domain's edge
    assert fl.smem_bytes(16, 48, 48) == 4 * (48 * 50 + chains * 2 * 16 * chunk) == 34176
    # a transposed scene: 96 rows of 24 columns at a stride of 26
    assert fl.smem_bytes(16, 24, 96) == fl.smem_bytes(16, 96, 24) == 4 * (
        96 * 26 + chains * 2 * 16 * chunk + chains * 2 * 2 * exch)
    # an odd number of rows at a stride of 2 mod 4 rounds the image up to 4 floats
    assert fl.smem_bytes(5, 9, 13) == 4 * (128 + chains * 2 * 8 * chunk)
    assert 9 * fl.image_stride(13) == 126
    # the largest of the domain: a 2304-row column, K = 16
    worst = max(fl.smem_bytes(16, h, w) for h in range(1, 2305) for w in range(1, 2304 // h + 1))
    assert worst == fl.smem_bytes(16, 2304, 1) == 4 * (2304 * 2 + chains * 2 * 16 * chunk)
    assert worst <= 48 * 1024


@pytest.mark.parametrize("h,w,k", [(48, 48, 16), (32, 32, 16), (40, 48, 16), (24, 96, 16),
                                   (96, 24, 16), (32, 32, 1), (16, 16, 1), (1, 2304, 16),
                                   (2304, 1, 16), (4, 576, 16)])
def test_domain_takes_scenes_that_fit(h, w, k):
    assert fl.domain_error(_spec(h, w), k) is None
    fl.check_domain(_spec(h, w), k)


@pytest.mark.parametrize("h,w,k,match", [
    (49, 48, 16, "H\\*W <= 2304"),
    (48, 48, 17, "K <= 16"),
    (32, 32, 0, "1 <= K"),
    (64, 64, 10, "64x64"),
])
def test_domain_rejects_the_edges_and_names_b5(h, w, k, match):
    with pytest.raises(ValueError, match=match):
        fl.check_domain(_spec(h, w), k)
    assert "B5" in fl.domain_error(_spec(h, w), k)


def test_domain_is_no_narrower_than_the_first_design():
    """Every scene and K that the first B1 took (H W <= 48^2, 1 <= K <= 16,
    its layout within a block's shared memory), the redesign takes too, and
    it takes the tall scenes the first one could not hold (2304x1 at K = 16)."""
    for h in range(1, 2305):
        for w in range(1, 2304 // h + 1):
            if (h * w) % 5 and h * w < 2200:  # a sample of the interior, and all the edge
                continue
            for k in range(1, 17):
                if _first_design_bytes(k, h, w) <= MAX_SMEM_BYTES:
                    assert fl.domain_error(_spec(h, w), k) is None, (h, w, k)
    assert _first_design_bytes(16, 2304, 1) > MAX_SMEM_BYTES
    assert fl.domain_error(_spec(2304, 1), 16) is None


def test_scenes_beyond_the_domain_go_to_b5():
    """What B1 refuses within B5's sides, B5 takes."""
    for h, w, k in ((64, 64, 10), (49, 48, 16), (32, 32, 17), (128, 128, 64)):
        assert fl.domain_error(_spec(h, w), k) is not None
        assert flc.domain_error(_spec(h, w), k) is None
        assert dispatch.leapfrog_module(_spec(h, w), k)[1] == "B5"


@pytest.mark.parametrize("n_steps,grad_in", [(0, False), (3, False), (3, True)])
def test_plain_version_on_the_transposed_scene_matches(n_steps, grad_in):
    """The kernel holds a scene wider than 48 columns transposed, with x and
    y swapped: the plain version gives the same trajectory that way (float64,
    24x96 with K = 5 and a per-chain mask)."""
    rng = np.random.default_rng(3)
    h, w, k, c = 24, 96, 5, 6
    spec = SceneSpec(h, w, 1.5, 10.0)
    prior = PriorSpec(5.0, 0.7)
    image = torch.tensor(rng.poisson(12.0, (h, w)), dtype=torch.float64)
    theta = torch.tensor(rng.normal(0.0, 1.0, (c, k, 3)))
    theta[..., 2] += 5.0
    p = torch.tensor(rng.normal(0.0, 1.0, (c, k, 3)))
    eps = torch.tensor(rng.uniform(0.01, 0.02, c))
    inv_mass = torch.tensor(rng.uniform(0.8, 1.2, (k, 3)))
    mask = torch.tensor((rng.uniform(size=(c, k)) < 0.7).astype(np.float64))
    swap = [1, 0, 2]
    ref = fl.fused_leapfrog_reference
    g = ref(spec, image, prior, theta, p, eps, inv_mass, mask, 0)[3] if grad_in else None
    out = ref(spec, image, prior, theta, p, eps, inv_mass, mask, n_steps, g)
    t_spec = spec._replace(height=w, width=h)
    out_t = ref(t_spec, image.T.contiguous(), prior, theta[..., swap], p[..., swap], eps,
                inv_mass[:, swap], mask, n_steps, None if g is None else g[..., swap])
    assert fl.scene_frame(h, w) == (w, h, True)
    for a, b in zip(out, out_t):
        b = b[..., swap] if b.ndim == 3 else b
        assert torch.allclose(a, b, rtol=1e-11, atol=1e-9), float((a - b).abs().max())
