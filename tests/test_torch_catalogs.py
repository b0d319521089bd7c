"""starcat_torch.catalogs against starcat.catalogs, and the reference's
catalog tests (tests/test_catalogs.py) on the port.

The port keeps its own copy of the reference's NumPy-only module, so on
the same arrays every function must give the reference's result exactly:
the same deterministic subsampling, matching, condensation and curves.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from starcat import catalogs as ref
from starcat.scene import SceneSpec as RefSceneSpec
from starcat_torch import catalogs
from starcat_torch.potential import unconstrain
from starcat_torch.scene import SceneSpec

SPEC = SceneSpec(32, 32, 1.5, 10.0)
REF_SPEC = RefSceneSpec(32, 32, 1.5, 10.0)


def _fake_draws(rng, truth, n_draws, jitter=0.15, spurious_rate=0.0, kmax=8,
                spec=SPEC, n_chains=1):
    """(n_chains, n_draws, kmax, 3) unconstrained draws and per-draw masks
    around a constrained truth (n, 3) catalog (tests/test_catalogs.py's
    construction, on the port's unconstrain)."""
    thetas = np.zeros((n_chains, n_draws, kmax, 3), np.float64)
    masks = np.zeros((n_chains, n_draws, kmax), np.float64)
    for c in range(n_chains):
        for d in range(n_draws):
            rows = [[x + rng.normal(0, jitter), y + rng.normal(0, jitter),
                     f * np.exp(rng.normal(0, 0.05))] for x, y, f in truth]
            if rng.random() < spurious_rate:
                rows.append([rng.uniform(2, spec.width - 2),
                             rng.uniform(2, spec.height - 2), 3.0])
            rows = torch.tensor(rows, dtype=torch.float64)
            th = unconstrain(rows[:, 0], rows[:, 1], rows[:, 2], spec)
            thetas[c, d, : len(rows)] = th.numpy()
            masks[c, d, : len(rows)] = 1.0
    return thetas, masks


TRUTH3 = np.array([[8.0, 8.0, 100.0], [24.0, 10.0, 60.0], [16.0, 25.0, 30.0]])


def _mask_forms(masks):
    """The three mask layouts of extract_catalogs from per-draw masks:
    (K,) shared, (C, K) per chain and (C, N, K) per draw."""
    return {"shared": masks[0, 0], "per_chain": masks[:, 0], "per_draw": masks}


def _same_catalogs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("form", ["shared", "per_chain", "per_draw"])
@pytest.mark.parametrize("max_draws", [512, 64])
def test_extract_catalogs_equals_reference(form, max_draws):
    rng = np.random.default_rng(5)
    thetas, masks = _fake_draws(rng, TRUTH3, n_draws=100, spurious_rate=0.4, n_chains=3)
    m = _mask_forms(masks)[form]
    got = catalogs.extract_catalogs(thetas.astype(np.float32), m, SPEC, max_draws=max_draws)
    want = ref.extract_catalogs(thetas.astype(np.float32), m, REF_SPEC, max_draws=max_draws)
    assert len(got) == min(300, max_draws)
    _same_catalogs(got, want)


@pytest.mark.parametrize("form", ["shared", "per_chain", "per_draw"])
def test_match_condense_curves_equal_reference(form):
    rng = np.random.default_rng(6)
    thetas, masks = _fake_draws(rng, TRUTH3, n_draws=120, spurious_rate=0.5, n_chains=2)
    cats = catalogs.extract_catalogs(thetas, _mask_forms(masks)[form], SPEC)
    for a, b in zip(cats[:-1], cats[1:]):
        for got, want in zip(catalogs.match_catalogs(a, b, 1.0), ref.match_catalogs(a, b, 1.0)):
            assert np.array_equal(got, want)
    for radius, min_prev in [(1.0, 0.1), (0.5, 0.02)]:
        got = [s.as_dict() for s in catalogs.condense(cats, radius, min_prev)]
        want = [s.as_dict() for s in ref.condense(cats, radius, min_prev)]
        assert got == want and got
    for bins in [None, np.array([1.0, 10.0, 50.0, 1000.0])]:
        assert (catalogs.completeness_purity(cats, TRUTH3, 1.0, bins)
                == ref.completeness_purity(cats, TRUTH3, 1.0, bins))


@pytest.mark.parametrize("form", ["shared", "per_chain", "per_draw"])
def test_catalog_report_equals_reference(form):
    rng = np.random.default_rng(7)
    thetas, masks = _fake_draws(rng, TRUTH3, n_draws=300, spurious_rate=0.3, n_chains=2)
    m = _mask_forms(masks)[form]
    truth_theta = unconstrain(*(torch.tensor(TRUTH3[:, j]) for j in range(3)), SPEC).numpy()
    out = SimpleNamespace(thetas=thetas.astype(np.float32), masks=m,
                          config=SimpleNamespace(scene=SPEC))
    ref_out = SimpleNamespace(thetas=out.thetas, masks=m,
                              config=SimpleNamespace(scene=REF_SPEC))
    got = catalogs.catalog_report(out, truth_theta=truth_theta)
    assert got == ref.catalog_report(ref_out, truth_theta=truth_theta)
    assert got["n_draws_used"] == 512 and got["n_condensed_ge_half"] >= 3
    assert catalogs.catalog_report(out) == ref.catalog_report(ref_out)


def test_empty_catalogs_equal_reference():
    thetas = np.zeros((2, 4, 3, 3), np.float32)
    cats = catalogs.extract_catalogs(thetas, np.zeros(3), SPEC)
    assert all(len(c) == 0 for c in cats)
    assert catalogs.condense(cats) == ref.condense(cats) == []
    assert catalogs.completeness_purity(cats, TRUTH3) == ref.completeness_purity(cats, TRUTH3)


# --- tests/test_catalogs.py:49-101 on the port --------------------------------


def test_match_catalogs_one_to_one():
    a = np.array([[5.0, 5.0, 10.0], [20.0, 20.0, 5.0]])
    b = np.array([[5.3, 5.0, 9.0], [5.6, 5.1, 2.0], [28.0, 3.0, 1.0]])
    pairs, un_a, un_b = catalogs.match_catalogs(a, b, radius=1.0)
    # nearest b-star claims the a-star; the second b candidate stays free
    assert pairs.tolist() == [[0, 0]]
    assert un_a.tolist() == [1]
    assert set(un_b.tolist()) == {1, 2}


def test_condense_recovers_truth_and_prevalence():
    rng = np.random.default_rng(0)
    thetas, masks = _fake_draws(rng, TRUTH3, n_draws=200, spurious_rate=0.3)
    cats = catalogs.extract_catalogs(thetas, masks, SPEC)
    cond = catalogs.condense(cats, radius=1.0, min_prevalence=0.1)
    solid = [s for s in cond if s.prevalence >= 0.9]
    assert len(solid) == 3
    # sources come out flux-sorted; positions within the jitter scale
    got = np.array([[s.x, s.y, s.flux] for s in solid])
    order = np.argsort(-TRUTH3[:, 2])
    assert np.allclose(got[:, :2], TRUTH3[order, :2], atol=0.2)
    assert np.allclose(got[:, 2], TRUTH3[order, 2], rtol=0.05)
    # the scattered spurious stars never cluster
    assert all(s.prevalence < 0.5 for s in cond if s.prevalence < 0.9)


def test_completeness_purity_curves():
    rng = np.random.default_rng(1)
    truth = np.array([[8.0, 8.0, 100.0], [24.0, 10.0, 60.0]])
    # both truth stars in every draw plus one spurious star in every draw
    thetas, masks = _fake_draws(rng, truth, n_draws=100, spurious_rate=1.0)
    cats = catalogs.extract_catalogs(thetas, masks, SPEC)
    rep = catalogs.completeness_purity(cats, truth, radius=1.0,
                                       flux_bins=np.array([1.0, 10.0, 1000.0]))
    assert rep["completeness"][1] == pytest.approx(1.0)
    assert rep["purity"][0] == pytest.approx(0.0, abs=0.05)
    assert rep["purity"][1] == pytest.approx(1.0, abs=0.05)
    assert abs(rep["matched_flux_rel_err_mean"]) < 0.05


def test_catalog_report_end_to_end_transdim():
    """A short trans-d MCMC run of the port on a bright, well-separated
    2-star scene: the condensed catalog finds exactly the two sources
    (tests/test_catalogs.py:101, the JAX package's slow-marked case, at its
    size, on the port's plain CPU path with the hmc within-model move)."""
    from starcat_torch.api import sample
    from starcat_torch.configs import CONFIGS, apply_overrides
    from starcat_torch.scene import make_mock_image

    cfg = apply_overrides(CONFIGS["cfg5_transdim_mcmc"],
                          {"n_chains": 8, "n_samples": 60, "n_warmup": 60, "kmax": 6,
                           "tdm.transdim.lam_count": 2.0, "tdm.mutation": "hmc"})
    x, y, f = (torch.tensor(v) for v in ([9.0, 23.0], [9.0, 22.0], [900.0, 700.0]))
    truth = unconstrain(x, y, f, cfg.scene)
    gen = torch.Generator().manual_seed(7)
    img = make_mock_image(gen, x, y, f, cfg.scene)
    out = sample(cfg, "cpu", seed=3, image=img)
    rep = catalogs.catalog_report(out, truth_theta=truth.numpy(), radius=1.5)
    assert rep["n_condensed_ge_half"] == 2
    solid = [s for s in rep["condensed"] if s["prevalence"] >= 0.5][:2]
    got = np.array([[s["x"], s["y"]] for s in solid])
    assert np.allclose(np.sort(got[:, 0]), [9.0, 23.0], atol=1.0)
    assert np.allclose(np.sort(got[:, 1]), [9.0, 22.0], atol=1.0)
    comp = [c for c in rep["completeness_purity"]["completeness"] if c is not None]
    assert min(comp) > 0.6
