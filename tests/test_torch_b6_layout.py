"""B6's launch geometry as the wrapper sees it: smem_bytes mirrors the
shared-memory layout of csrc/fused_rhmc.cu and check_domain takes exactly
the scenes and catalogs that fit it.  The kernel itself runs only on the
card (tests/test_torch_cuda.py)."""
import pytest

from starcat_torch import fused_rhmc as fr
from starcat_torch.build import MAX_SMEM_BYTES
from starcat_torch.scene import SceneSpec


def _spec(h, w):
    return SceneSpec(h, w, 1.5, 10.0)


def test_b6_shared_memory_follows_its_layout():
    """58 floats of state per star, 8 of scratch, the image, 1/lam and the
    working field, six profile sets at the odd star strides H | 1 and W | 1,
    the 18 K^2 pair contractions, G^-1's 3x3 star blocks padded to 12
    floats, and G / L (D + 1 rows), L^-1 and G^-1 at the odd row stride
    (D + 1) | 1."""
    assert [fr.matrix_stride(d) for d in (3, 30, 45, 48)] == [5, 31, 47, 49]
    assert [fr.profile_stride(n) for n in (32, 33, 40, 48)] == [33, 33, 41, 49]
    # the cfg3 / cfg1 scene, K = 16 (D = 48, stride 49; profiles at stride 33)
    assert fr.smem_bytes(16, 32, 32) == 4 * (58 * 16 + 8 + 3 * 1024 + 3 * 16 * 66
                                             + 30 * 256 + 145 * 49) == 87844
    # K = 10 (D = 30, stride 31) and K = 1 (D = 3, stride 5)
    assert fr.smem_bytes(10, 32, 32) == 4 * (580 + 8 + 3072 + 1980 + 3000 + 91 * 31)
    assert fr.smem_bytes(1, 32, 32) == 4 * (58 + 8 + 3072 + 198 + 30 + 10 * 5)
    # a non-square scene counts its own rows and columns
    assert fr.smem_bytes(12, 40, 48) == 4 * (58 * 12 + 8 + 3 * 1920 + 36 * 90
                                             + 30 * 144 + 109 * 37)
    # two 256-thread blocks share an SM at the presets' shape
    assert 2 * (fr.smem_bytes(16, 32, 32) + 1024) <= 228 * 1024


@pytest.mark.parametrize("h,w,k", [(48, 48, 16), (32, 32, 16), (40, 48, 12), (32, 32, 1),
                                   (24, 96, 16)])
def test_b6_domain_takes_scenes_that_fit(h, w, k):
    fr.check_domain(_spec(h, w), k)
    assert fr.smem_bytes(k, h, w) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("h,w,k,match", [
    (49, 48, 16, "H\\*W <= 2304"),
    (48, 48, 17, "K <= 16"),
    (32, 32, 0, "1 <= K"),
    (64, 64, 10, "64x64"),
    (1, 2304, 16, "shared memory"),  # its profile sets alone overflow a block
])
def test_b6_domain_rejects_the_edges(h, w, k, match):
    with pytest.raises(ValueError, match=match) as err:
        fr.check_domain(_spec(h, w), k)
    assert "(B6)" in str(err.value)
