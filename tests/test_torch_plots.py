"""starcat_torch.plots and the CLI's ``report``: the figures render and
save (tests/test_plots.py on the port), the posterior-mean scene equals
the reference's render_scene average on the same draws, and ``report``
writes the catalog with or without matplotlib."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from starcat.potential import constrain as ref_constrain
from starcat.scene import SceneSpec as RefSceneSpec
from starcat.scene import render_scene as ref_render_scene
from starcat_torch.__main__ import main
from starcat_torch.plots import posterior_mean_scene
from starcat_torch.scene import SceneSpec

CUT = ["n_samples=60", "n_warmup=60"]


@pytest.fixture(scope="module")
def cfg0_run():
    from starcat_torch.api import sample
    from starcat_torch.configs import apply_overrides, cfg0_single_star

    cfg = apply_overrides(cfg0_single_star, {"head": "hmc", "n_chains": "4",
                                             "n_samples": "60", "n_warmup": "60"})
    _, img = cfg.make_data()
    return cfg, sample(cfg, "cpu", seed=0), img.numpy()


def test_plots_render_and_save(tmp_path, cfg0_run):
    pytest.importorskip("matplotlib")
    from starcat_torch.plots import corner_plot, reconstruction_plot, save_report, trace_plot

    cfg, out, img = cfg0_run
    assert trace_plot(out.thetas).get_axes()
    assert len(corner_plot(out.thetas, cfg.scene).get_axes()) == 9
    assert len(reconstruction_plot(out.thetas, out.masks, cfg.scene, img).get_axes()) >= 3
    paths = save_report(out, img, str(tmp_path / "r"))
    assert len(paths) == 3 and all(os.path.getsize(p) > 1000 for p in paths)


def _ref_mean_scene(thetas, masks_flat, spec, n_draws=64):
    """The reference's reconstruction_plot loop (starcat/plots.py:94-115)."""
    flat = thetas.reshape(-1, thetas.shape[-2], 3)
    idx = np.linspace(0, flat.shape[0] - 1, min(n_draws, flat.shape[0])).astype(int)
    lam = np.zeros((spec.height, spec.width))
    for i in idx:
        x, y, f = ref_constrain(jnp.asarray(flat[i]), spec)
        lam += np.asarray(ref_render_scene(x, y, f, jnp.asarray(masks_flat[i]), spec))
    return lam / len(idx)


@pytest.mark.parametrize("form", ["shared", "per_chain", "per_draw"])
def test_posterior_mean_scene_matches_reference(form):
    rng = np.random.default_rng(3)
    c, n, k = 3, 40, 6
    thetas = np.stack([rng.normal(0.0, 1.2, (c, n, k)), rng.normal(0.0, 1.2, (c, n, k)),
                       rng.normal(5.0, 0.7, (c, n, k))], axis=-1).astype(np.float32)
    per_draw = (rng.random((c, n, k)) < 0.7).astype(np.float32)
    masks, flat_masks = {
        "shared": (per_draw[0, 0], np.broadcast_to(per_draw[0, 0], (c * n, k))),
        "per_chain": (per_draw[:, 0], np.repeat(per_draw[:, 0], n, axis=0)),
        "per_draw": (per_draw, per_draw.reshape(-1, k))}[form]
    got = posterior_mean_scene(thetas, masks, SceneSpec(24, 20, 1.5, 10.0))
    want = _ref_mean_scene(thetas, flat_masks, RefSceneSpec(24, 20, 1.5, 10.0))
    assert got.shape == (24, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _report(tmp_path, capsys):
    prefix = str(tmp_path / "rep")
    main(["report", "--config", "cfg0_single_star", "--device", "cpu",
          "--out-prefix", prefix, *CUT])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) >= {"config", "plots", "summary", "condensed_sources"}
    with open(prefix + "_catalog.json") as fh:
        cat = json.load(fh)
    assert cat["n_draws_used"] == 240
    assert rec["condensed_sources"] == cat["n_condensed_ge_half"] == 1
    assert cat["completeness_purity"]["completeness"]
    return prefix, rec


def test_report_writes_catalog_and_pngs(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    prefix, rec = _report(tmp_path, capsys)
    pngs = [f"{prefix}_{n}.png" for n in ("trace", "corner", "reconstruction")]
    assert rec["plots"] == pngs + [prefix + "_catalog.json"] and "skipped" not in rec
    assert all(os.path.getsize(p) > 1000 for p in pngs)


def test_report_without_matplotlib_writes_catalog(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import raises ImportError
    prefix, rec = _report(tmp_path, capsys)
    assert rec["plots"] == [prefix + "_catalog.json"]
    assert rec["skipped"]["plots"] == [f"{prefix}_{n}.png"
                                       for n in ("trace", "corner", "reconstruction")]
    assert "matplotlib" in rec["skipped"]["reason"]
    assert not any(os.path.exists(p) for p in rec["skipped"]["plots"])
