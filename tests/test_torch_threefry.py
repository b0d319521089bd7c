"""starcat_torch.threefry, the port of the JAX package's mock-data draws,
against JAX itself on the CPU: the threefry2x32 hash, keys, splits and
bits, ``uniform``, ``normal`` and ``poisson``, the elementwise functions of
XLA's CPU code that the draws go through, the render, and
``RunConfig.make_data`` on scenes that no preset has.  Every comparison is
exact: the port reproduces XLA's float32 code op for op."""
import dataclasses
from pathlib import Path

import jax
import jax.extend.random as jex_random
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat_torch import threefry
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.scene import SceneSpec

torch.set_num_threads(1)

SCENES = Path(__file__).resolve().parents[1] / "starcat_torch" / "data" / "scenes.npz"
SEEDS = [0, 1, 12, 2**31 - 1]
# and seeds past int32, which JAX casts to 32 bits
KEY_SEEDS = SEEDS + [-1, 2**32 + 5]
SHAPES = [(1,), (7,), (10, 2), (128, 128)]


def _words(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_threefry2x32_matches_jax(seed):
    rng = np.random.default_rng(seed % 2**32)
    x1, x2 = (rng.integers(0, 2**32, 1000, dtype=np.uint32) for _ in range(2))
    k = threefry.key(seed)
    want = jex_random.threefry2x32_p.bind(np.uint32(k[0]), np.uint32(k[1]), x1, x2)
    got = threefry.threefry2x32(k, torch.from_numpy(x1.astype(np.int64)),
                                torch.from_numpy(x2.astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_key_matches_jax(seed):
    assert threefry.key(seed) == _words(jax.random.key(seed))


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_split_matches_jax(seed, num):
    want = [_words(k) for k in jax.random.split(jax.random.key(seed), num)]
    assert threefry.split(threefry.key(seed), num) == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_bits_match_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    np.testing.assert_array_equal(threefry.bits(threefry.key(seed), shape).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1e-6, 1.0 - 1e-6)],
                         ids=["default", "sample_prior"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape, bounds):
    want = jax.random.uniform(jax.random.key(seed), shape, minval=bounds[0],
                              maxval=bounds[1])
    got = threefry.uniform(threefry.key(seed), shape, *bounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed, shape):
    """Exact: 0 ulp, no draw differs (erf_inv and its log1p are XLA's)."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = threefry.normal(threefry.key(seed), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(24))
def test_poisson_matches_jax(i):
    """A 48x40 field of lam log-uniform on [0.5, 500] that holds exactly 0
    and 10: both branches, the stand-ins and lam == 0 on one key."""
    rng = np.random.default_rng(i)
    lam = np.exp(rng.uniform(np.log(0.5), np.log(500.0), (48, 40))).astype(np.float32)
    lam.flat[rng.choice(lam.size, 40, replace=False)[:20]] = 0.0
    lam.flat[rng.choice(lam.size, 40, replace=False)[20:]] = 10.0
    assert (lam == 0).any() and (lam == 10).any()
    want = np.asarray(jax.random.poisson(jax.random.key(100 + i), lam))
    got = threefry.poisson(threefry.key(100 + i), torch.from_numpy(lam)).numpy()
    np.testing.assert_array_equal(got, want)


def _wide_sample(lo: float, hi: float) -> np.ndarray:
    rng = np.random.default_rng(7)
    return np.concatenate([rng.uniform(lo, hi, 100_000),
                           rng.uniform(-1.0, 1.0, 30_000)]).astype(np.float32)


XLA_FUNCTIONS = {
    # name: (the port's, JAX's, inputs)
    "exp": (threefry._exp, jnp.exp, _wide_sample(-90.0, 90.0)),
    "log": (threefry._log, jnp.log, np.abs(_wide_sample(-1e4, 1e4))),
    "log1p": (threefry._log1p, jnp.log1p, _wide_sample(-0.999, 50.0)),
    "lgamma": (threefry._lgamma, jax.lax.lgamma, np.abs(_wide_sample(0.5, 2000.0)) + 0.5),
    "erf_inv": (threefry.erf_inv, jax.lax.erf_inv, _wide_sample(-0.9999, 0.9999)),
}


@pytest.mark.parametrize("name", sorted(XLA_FUNCTIONS))
def test_xla_elementwise_function_matches(name):
    port, jax_fn, x = XLA_FUNCTIONS[name]
    np.testing.assert_array_equal(port(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_fn(x)))


@pytest.mark.parametrize("name", ["cfg0_single_star", "cfg6_chees", "cfg4_crowded"])
def test_constrain_and_render_match_jax(name):
    jcfg = JAX_CONFIGS[name]
    theta = jcfg.make_truth()
    xyf_j = starcat.constrain(theta, jcfg.scene)
    xyf_t = threefry.constrain(torch.from_numpy(np.array(theta)), SceneSpec(*jcfg.scene))
    for a, b in zip(xyf_t, xyf_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lam_j = starcat.render_scene(*xyf_j, jnp.ones_like(xyf_j[2]), jcfg.scene)
    lam_t = threefry.render_scene(*xyf_t, SceneSpec(*jcfg.scene))
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))


# scenes no preset holds: new seeds of the flagship, cfg0's field (Knuth's
# branch nearly everywhere), a 48x24 scene, the 64x64 20-star field, a
# wider prior, and the crowded field at new seeds
DRAWN = {
    **{f"flagship_{t}_{d}": ("cfg6_chees", {"truth_seed": t, "data_seed": d})
       for t, d in [(11, 13), (21, 22), (3, 4), (5, 6), (0, 1), (2**31 - 1, 7),
                    (-1, 2**32 + 5)]},
    **{f"cfg0_{t}_{d}": ("cfg0_single_star", {"truth_seed": t, "data_seed": d})
       for t, d in [(1, 2), (3, 4), (5, 6), (7, 9), (11, 13)]},
    "48x24": ("cfg6_chees", {"scene.height": 48, "scene.width": 24, "truth_seed": 2,
                             "data_seed": 3}),
    "64x64_20_stars": ("cfg4_crowded", {"scene.height": 64, "scene.width": 64,
                                        "n_stars": 20, "kmax": 20, "truth_seed": 31,
                                        "data_seed": 32}),
    "wide_prior": ("cfg6_chees", {"prior.logf_mean": 4.0, "prior.logf_sigma": 1.3,
                                  "n_stars": 4, "kmax": 4, "truth_seed": 8}),
    "crowded_5_6": ("cfg4_crowded", {"truth_seed": 5, "data_seed": 6}),
    "background_2": ("cfg0_single_star", {"scene.background": 2.0, "data_seed": 19}),
}


def _jax_config(name, overrides):
    cfg = JAX_CONFIGS[name]
    fields = {}
    for k, v in overrides.items():
        if k.startswith("scene."):
            fields["scene"] = fields.get("scene", cfg.scene)._replace(**{k[6:]: v})
        elif k.startswith("prior."):
            fields["prior"] = fields.get("prior", cfg.prior)._replace(**{k[6:]: v})
        else:
            fields[k] = v
    return dataclasses.replace(cfg, **fields)


@pytest.mark.parametrize("case", sorted(DRAWN))
def test_make_data_draws_jax_scenes(case):
    name, overrides = DRAWN[case]
    theta_t, img_t = apply_overrides(CONFIGS[name], overrides).make_data()
    theta_j, img_j = _jax_config(name, overrides).make_data()
    assert theta_t.dtype == img_t.dtype == torch.float32
    np.testing.assert_array_equal(theta_t.numpy(), np.asarray(theta_j))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))


def test_committed_scenes_are_the_draws():
    """data/scenes.npz, written with the JAX package, holds what the port
    draws: the check chip_smoke.py repeats on a machine without JAX."""
    for entry, name in (("cfg0_single_star", "cfg0_single_star"), ("flagship", "cfg6_chees"),
                        ("crowded", "cfg4_crowded")):
        theta, image = CONFIGS[name].make_data()
        with np.load(SCENES) as data:
            np.testing.assert_array_equal(theta.numpy(), data[f"{entry}/theta"])
            np.testing.assert_array_equal(image.numpy(), data[f"{entry}/image"])

