"""B5's and B3's launch geometry as the wrappers see it: smem_bytes mirrors
the shared-memory layouts of csrc/fused_leapfrog_crowded.cu and
csrc/fused_rhmc_diag.cu term by term, domain_error takes exactly the
scenes and catalogs that fit them (and every one the first designs took,
B5's scenes with a side above 128 pixels on its wide path), and B3's
scenes sit in the row tile that holds them.  The kernels themselves run
only on the card (tests/test_torch_cuda.py)."""
import pytest

from starcat_torch import fused_leapfrog_crowded as flc
from starcat_torch import fused_rhmc_diag as frd
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.scene import SceneSpec


def _spec(h, w):
    return SceneSpec(h, w, 1.5, 10.0)


# -- B5, the crowded-field leapfrog -------------------------------------------

def _b5_first_design_bytes(k, h, w):
    """The first B5 design's layout: the residual field, gx, gyw and gyzw
    and 19 K + 34 floats of state."""
    return 4 * (19 * k + 2 + 32 + h * w + k * (w + 2 * h))


def test_b5_shared_memory_follows_its_gemm_layout():
    """The residual field, T rows by W columns; gx (K + 3 rows of T + 4)
    and gyw (K, T); two floats a warp of block-sum doubles, the column
    halves' partial sums (3 x 4 stars x the pass's star groups: 16 at T =
    128, 8 at 64 and 32), 20 K of state and per-star scalars, 4 of scratch.
    The height enters only through the tile side T."""
    assert flc.smem_bytes(50, 128, 128) == 4 * (128 * 128 + 53 * 132 + 50 * 128 + 32 + 192
                                                + 20 * 50 + 4) == 124032
    assert flc.smem_bytes(37, 96, 128) == flc.smem_bytes(37, 128, 128)
    assert flc.smem_bytes(50, 100, 84) == 4 * (128 * 84 + 53 * 132 + 50 * 128 + 224 + 1004)
    # the 64-pixel tile (128 threads, four warps) and the 32-pixel one (one warp)
    assert flc.smem_bytes(30, 64, 64) == 4 * (64 * 64 + 33 * 68 + 30 * 64 + 8 + 96 + 604)
    assert flc.smem_bytes(30, 64, 40) == 4 * (64 * 40 + 33 * 68 + 30 * 64 + 8 + 96 + 604)
    assert flc.smem_bytes(20, 32, 32) == 4 * (32 * 32 + 23 * 36 + 20 * 32 + 2 + 96 + 404)
    assert flc.smem_bytes(1, 1, 1) == 4 * (32 + 4 * 36 + 32 + 2 + 96 + 24)
    # every K the kernel takes fits at 128x128: 206 KB at K = 128
    assert flc.smem_bytes(128, 128, 128) == 211392 <= MAX_SMEM_BYTES


@pytest.mark.parametrize("h,w,side,threads", [(1, 1, 32, 32), (32, 32, 32, 32),
                                              (33, 32, 64, 128), (20, 64, 64, 128),
                                              (64, 64, 64, 128), (65, 10, 128, 512),
                                              (96, 128, 128, 512), (128, 128, 128, 512)])
def test_b5_tile_is_the_smallest_that_holds_the_scene(h, w, side, threads):
    """A square tile of 32, 64 or 128 pixels a side, 8 x 4 render pixels a
    thread: one warp, four or sixteen a chain."""
    assert flc.tile_side(h, w) == side
    assert flc.tile_threads(side) == threads


@pytest.mark.parametrize("h,w,k", [(128, 128, 128), (128, 128, 50), (128, 128, 64),
                                   (96, 128, 37), (100, 84, 50), (128, 128, 1), (1, 1, 1),
                                   (49, 48, 17), (128, 1, 128)])
def test_b5_domain_takes_scenes_that_fit(h, w, k):
    assert flc.domain_error(_spec(h, w), k) is None
    flc.check_domain(_spec(h, w), k)


@pytest.mark.parametrize("h,w,k,match", [
    (128, 128, 668, None),
    (128, 128, 0, "K >= 1, got K=0"),
    (192, 192, 362, None),
    (352, 128, 180, None),
    (256, 256, 184, None),
])
def test_b5_domain_rejects_the_edges(h, w, k, match):
    """One past each of the TPU gate's edges B5 now runs (match None: its
    wide path, as the JAX package runs XLA there); only K < 1 raises."""
    err = flc.domain_error(_spec(h, w), k)
    if match is None:
        assert err is None and not flc.one_tile(k, h, w)
        flc.check_domain(_spec(h, w), k)
        return
    assert err is not None and "(B5)" in err and match in err
    with pytest.raises(ValueError, match="B5"):
        flc.check_domain(_spec(h, w), k)


def test_b5_domain_is_no_narrower_up_to_128_a_side():
    """Every scene of at most 128 pixels a side and every K that the first
    B5 took, the block GEMMs take too; above 128 a side the one-tile path
    takes none, and the wide path takes those the first design took while
    its field fitted, e.g. 200x100."""
    for h in range(1, 129, 3):
        for w in range(1, 129, 5):
            for k in range(1, 129, 7):
                if _b5_first_design_bytes(k, h, w) <= MAX_SMEM_BYTES:
                    assert flc.domain_error(_spec(h, w), k) is None, (h, w, k)
    assert _b5_first_design_bytes(4, 200, 100) <= MAX_SMEM_BYTES
    assert not flc.one_tile(4, 200, 100) and flc.domain_error(_spec(200, 100), 4) is None


# -- B3, the diagonal-Fisher trajectory on small scenes -----------------------

def _b3_first_design_bytes(k, h, w):
    """The first B3 design's layout: image, 1/lam and a working field, ten
    profile sets and 70 K + 8 floats of state."""
    return 4 * (70 * k + 8 + 3 * h * w + 5 * k * (w + h))


@pytest.mark.parametrize("hw,tile", [
    ((32, 32), (32, 32, 32, False)),
    ((48, 48), (48, 48, 48, False)),
    ((40, 48), (40, 48, 48, False)),
    ((24, 96), (24, 96, 32, False)),
    ((96, 24), (24, 96, 32, True)),   # taller than 48: transposed
    ((16, 12), (16, 12, 16, False)),
    ((17, 135), (17, 135, 32, False)),
    ((1, 2304), (1, 2304, 4, False)),
    ((2304, 1), (1, 2304, 4, True)),
    ((5, 460), (5, 460, 16, False)),
])
def test_b3_scene_tile(hw, tile):
    """(rows, columns, row tile, transposed) as one block holds the scene."""
    assert frd.scene_tile(*hw) == tile


def test_b3_shared_memory_follows_its_layout():
    """1/lam and the working field, TR rows by W columns; gy, gy^2, gy'^2
    (K rows of TR) and gx and the q field's two operands (K rows of W | 1);
    the block sum's doubles (threads / 16 floats) and the column runs'
    partial sums (3 a thread); 61 arrays of 16 floats (nine per-star, the
    live list, the 21 contraction sums and C tensor, ten (K, 3) states, two
    of them the weights of a sweep and of the next) and 12 of scratch."""
    fixed = 61 * 16 + 12
    # the cfg5 / cfg1 scene, K = 16 and K = 10
    assert frd.smem_bytes(16, 32, 32) == 4 * (2 * 32 * 32 + 48 * (32 + 33) + 16 + 768
                                              + fixed) == 27760
    assert frd.smem_bytes(10, 32, 32) == 4 * (2048 + 30 * 65 + 784 + fixed)
    # the 48-row tile at the domain's edge, a non-square scene, a transposed one
    assert frd.smem_bytes(16, 48, 48) == 4 * (2 * 48 * 48 + 48 * (48 + 49) + 784 + fixed)
    assert frd.smem_bytes(12, 40, 48) == 4 * (2 * 48 * 48 + 36 * (48 + 49) + 784 + fixed)
    assert frd.smem_bytes(10, 96, 24) == frd.smem_bytes(10, 24, 96) == 4 * (
        2 * 32 * 96 + 30 * (32 + 97) + 784 + fixed)
    # two chains share an SM at the presets' shape
    assert 2 * (frd.smem_bytes(16, 32, 32) + 1024) <= 228 * 1024


@pytest.mark.parametrize("h,w,tile,cols", [(4, 576, 4, 576), (1, 2304, 4, 2304),
                                           (12, 16, 16, 16), (16, 144, 16, 144),
                                           (17, 32, 32, 32), (33, 48, 48, 48),
                                           (144, 16, 16, 144)])
def test_b3_shared_memory_follows_the_row_tile(h, w, tile, cols):
    """The fields take the row tile's rows, not the scene's, and the x-side
    sets the columns' odd stride, in each of the four tiles (a scene taller
    than 48 rows by its width)."""
    k = 3
    assert frd.smem_bytes(k, h, w) == 4 * (2 * tile * cols + 3 * k * (tile + (cols | 1))
                                           + 16 + 768 + 61 * 16 + 12)


@pytest.mark.parametrize("h,w,k", [(48, 48, 16), (32, 32, 16), (40, 48, 16), (24, 96, 16),
                                   (96, 24, 16), (32, 32, 1), (16, 12, 16), (1, 2304, 1),
                                   (2304, 1, 1), (4, 576, 16)])
def test_b3_domain_takes_scenes_that_fit(h, w, k):
    assert frd.domain_error(_spec(h, w), k) is None
    frd.check_domain(_spec(h, w), k)


@pytest.mark.parametrize("h,w,k,match", [
    (49, 48, 16, "H\\*W <= 2304"),
    (48, 48, 17, "K <= 16"),
    (32, 32, 0, "1 <= K"),
    (64, 64, 10, "64x64"),
    (1, 2304, 16, "shared memory"),  # its x-side sets alone overflow a block
])
def test_b3_domain_rejects_the_edges(h, w, k, match):
    with pytest.raises(ValueError, match=match):
        frd.check_domain(_spec(h, w), k)


def test_b3_domain_is_no_narrower():
    """Every scene and K that the first B3 took (H W <= 48^2, K <= 16, its
    layout within a block's shared memory), the tiled B3 takes too."""
    for h in range(1, 2305):
        for w in range(1, 2304 // h + 1):
            if (h * w) % 7 and h * w < 2200:  # a sample of the interior, and all the edge
                continue
            for k in range(1, 17):
                if _b3_first_design_bytes(k, h, w) <= MAX_SMEM_BYTES:
                    assert frd.domain_error(_spec(h, w), k) is None, (h, w, k)
