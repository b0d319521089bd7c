"""The benchmark's frozen copies agree with what they were copied from: the
operation counters with chip_smoke.py's, the ESS with the port's
diagnostics.ess, the mock-scene draw with the port's threefry draws."""
from __future__ import annotations

import numpy as np
import pytest

import chip_smoke
from benchmark import ess, opcount, scene_draw
from starcat_torch import configs, diagnostics

# the shapes of PERF.md's kernel table: (chains, stars, height, width, steps, fpi)
SHAPES = [(1024, 10, 32, 32, 20, 0), (256, 16, 32, 32, 6, 4), (4096, 64, 128, 128, 6, 4),
          (1024, 50, 128, 128, 10, 0), (4096, 16, 32, 32, 6, 4), (64, 20, 64, 64, 16, 6)]


@pytest.mark.parametrize("c,k,h,w,n,fpi", SHAPES)
def test_op_counters_match_chip_smoke(c, k, h, w, n, fpi):
    for grad_in in (True, False):
        assert opcount.leapfrog_ops(c, k, h, w, n, grad_in) == chip_smoke.leapfrog_ops(
            c, k, h, w, n, grad_in)
    assert opcount.rhmc_diag_ops(c, k, h, w, n, fpi) == chip_smoke.rhmc_diag_ops(c, k, h, w, n, fpi)
    assert opcount.rhmc_full_ops(c, k, h, w, n, fpi) == chip_smoke.rhmc_full_ops(c, k, h, w, n, fpi)
    assert opcount.rhmc_full_ops_live(c * k, c * k * k, h, w, n, fpi) == pytest.approx(
        chip_smoke.rhmc_full_ops(c, k, h, w, n, fpi), rel=1e-12)
    assert opcount.PEAK_FP32 == chip_smoke.PEAK_FP32


@pytest.mark.parametrize("shape", [(1, 50), (4, 3), (8, 200), (64, 37)])
def test_ess_matches_the_port(shape):
    rng = np.random.default_rng(shape[1])
    x = np.cumsum(rng.normal(size=shape), axis=1) * 0.1 + rng.normal(size=shape)
    assert ess.ess(x) == diagnostics.ess(x)


@pytest.mark.parametrize("name", ["cfg6_chees", "cfg4_crowded"])
def test_scene_draw_matches_the_port(name):
    cfg = configs.CONFIGS[name]
    theta, image = cfg.make_data()
    t2 = scene_draw.sample_prior(scene_draw.key(cfg.truth_seed), cfg.n_stars, cfg.prior)
    x, y, f = scene_draw.constrain(t2, cfg.scene)
    i2 = scene_draw.make_mock_image(scene_draw.key(cfg.data_seed), x, y, f, cfg.scene)
    assert np.array_equal(theta.numpy(), t2.numpy()) and np.array_equal(image.numpy(), i2.numpy())
