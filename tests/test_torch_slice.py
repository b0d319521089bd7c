"""The starcat_torch slice end to end on the CPU: the fixed-K heads against
the NumPy oracle, short runs of the cfg2 (NUTS), cfg6 (ChEES) and cfg7
(ADVI) presets, the CLI, the presets' scenes and others drawn without JAX,
kernel selection, and the package's independence from JAX."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle.numpy_sampler import run_oracle
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.potential import constrain as starcat_constrain
from starcat_torch import api, diagnostics
from starcat_torch.configs import CONFIGS, apply_overrides

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _cli(*args, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "starcat_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env=env)


@pytest.fixture(scope="module")
def oracle_draws():
    cfg = CONFIGS["cfg0_single_star"]
    truth, img = cfg.make_data()
    orc = run_oracle(img.numpy(), cfg.scene.psf_sigma, cfg.scene.background,
                     cfg.prior.logf_mean, cfg.prior.logf_sigma, n_stars=1,
                     n_chains=4, n_samples=600, n_warmup=200, step_size=0.05,
                     n_leapfrog=15, seed=1, theta0=truth.numpy())
    return orc["samples"].reshape(4, -1, 1, 3)


@pytest.mark.parametrize("head", ["hmc", "chees"])
def test_head_matches_numpy_oracle(oracle_draws, head):
    cfg = dataclasses.replace(CONFIGS["cfg0_single_star"], head=head, n_chains=16,
                              n_samples=300, n_warmup=200)
    out = api.sample(cfg, "cpu", seed=2)
    assert out.stats["kernel"] == "torch" and out.stats["kernel_launches"] == 0
    assert out.thetas.shape == (16, 300, 1, 3)
    assert 0.5 < out.stats["accept"] < 0.99
    for j, name in enumerate(["ux", "uy", "log_flux"]):
        cmp = diagnostics.compare_moments(out.thetas[:, :, 0, j],
                                          oracle_draws[:, :, 0, j], name)
        assert cmp["z"] < 4.0, cmp


def test_cli_run_prints_its_json_line():
    res = _cli("run", "--config", "cfg0_single_star", "n_chains=4", "n_samples=50",
               "n_warmup=50", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["config"] == "cfg0_single_star" and rec["head"] == "hmc"
    assert rec["stats"]["kernel"] == "torch"
    assert np.isfinite(rec["summary"]["total_flux"]["mean"])


def test_cli_list_names_the_ported_presets():
    res = _cli("list")
    assert res.returncode == 0, res.stderr
    for name in ("cfg0_single_star", "cfg1_rhmc", "cfg2_nuts", "cfg3_transdim_smc",
                 "cfg4_crowded", "cfg5_transdim_mcmc", "cfg6_chees", "cfg7_advi"):
        assert name in res.stdout


def test_cli_default_device_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _cli("run", "--config", "cfg0_single_star", "n_chains=4", "n_samples=5",
               "n_warmup=5")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_short_cfg6_chees_run_on_the_plain_path():
    cfg = apply_overrides(CONFIGS["cfg6_chees"], {
        "n_chains": 8, "n_warmup": 24, "n_samples": 6, "chees.max_leapfrog": 16})
    out = api.sample(cfg, "cpu", seed=0)
    assert out.stats["kernel"] == "torch"
    assert out.thetas.shape == (8, 6, 10, 3)
    assert np.isfinite(out.thetas).all()
    assert np.isfinite(out.stats["traj_length"]) and out.stats["eq_stages"] >= 1
    summ = api.summarize_output(out)
    assert np.isfinite(summ["total_flux"]["mean"])


def test_port_imports_no_jax():
    """Every module of the package, found by walking it, imports neither
    JAX nor the JAX package."""
    code = ("import importlib, json, pkgutil, sys, starcat_torch; "
            "names = [m.name for m in pkgutil.walk_packages(starcat_torch.__path__, "
            "'starcat_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'starcat')]; "
            "print(json.dumps([names, bad])); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    names, _ = json.loads(res.stdout.strip().splitlines()[-1])
    files = {f"starcat_torch.{p.stem}" for p in (ROOT / "starcat_torch").glob("*.py")}
    assert set(names) == files - {"starcat_torch.__init__"}


@pytest.mark.parametrize("name,jax_name", [("cfg0_single_star", "cfg0_single_star"),
                                           ("cfg6_chees", "cfg6_chees"),
                                           ("cfg6_chees", "cfg2_nuts"),
                                           ("cfg2_nuts", "cfg2_nuts"),
                                           ("cfg7_advi", "cfg7_advi"),
                                           ("cfg1_rhmc", "cfg1_rhmc"),
                                           ("cfg3_transdim_smc", "cfg3_transdim_smc"),
                                           ("cfg5_transdim_mcmc", "cfg5_transdim_mcmc")])
def test_committed_scenes_equal_jax_make_data(name, jax_name):
    theta_t, img_t = CONFIGS[name].make_data()
    theta_j, img_j = JAX_CONFIGS[jax_name].make_data()
    np.testing.assert_array_equal(theta_t.numpy(), np.asarray(theta_j))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    assert theta_t.dtype == torch.float32 and img_t.dtype == torch.float32


def test_cli_runs_a_seed_no_preset_has():
    res = _cli("run", "--config", "cfg6_chees", "data_seed=13", "n_chains=4",
               "n_warmup=10", "n_samples=10", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["config"] == "cfg6_chees" and rec["stats"]["kernel"] == "torch"
    assert np.isfinite(rec["summary"]["total_flux"]["mean"])


def test_sample_takes_an_image_of_a_new_size():
    """api.sample on a caller's 24x40 image starts its chains from the
    config's drawn truth, the JAX package's own."""
    cfg = apply_overrides(CONFIGS["cfg6_chees"], {
        "scene.height": 24, "scene.width": 40, "n_stars": 3, "kmax": 3, "n_chains": 4,
        "n_warmup": 10, "n_samples": 5, "truth_seed": 40, "data_seed": 41,
        "chees.max_leapfrog": 16})
    jax_cfg6 = JAX_CONFIGS["cfg6_chees"]
    jcfg = dataclasses.replace(jax_cfg6, scene=jax_cfg6.scene._replace(height=24, width=40),
                               n_stars=3, kmax=3, truth_seed=40, data_seed=41)
    truth_j, img_j = jcfg.make_data()
    image = np.asarray(img_j) + 1.0
    out = api.sample(cfg, "cpu", seed=0, image=image)
    assert out.thetas.shape == (4, 5, 3, 3) and np.isfinite(out.thetas).all()
    truth_t = dict(zip("xyf", (np.asarray(v) for v in starcat_constrain(truth_j, jcfg.scene))))
    for k in "xyf":
        np.testing.assert_allclose(out.stats["truth"][k], truth_t[k], rtol=1e-6)


def test_kernel_selection():
    cfg = CONFIGS["cfg6_chees"]
    cpu = torch.device("cpu")
    assert api.resolve_kernel("auto", cpu, cfg) == "torch"
    assert api.resolve_kernel("torch", cpu, cfg) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        api.resolve_kernel("cuda", cpu, cfg)
    with pytest.raises(ValueError, match="kernel must be"):
        api.resolve_kernel("pallas", cpu, cfg)
    # ChEES's runtime step count runs on B2 inside its domain and on the
    # crowded-field kernel B5 beyond it, as the hmc head does, also beyond
    # B5's TPU gate (K <= 183 at 256x256); only an empty catalog raises,
    # naming B5
    crowded = dataclasses.replace(cfg, scene=cfg.scene._replace(height=128, width=128))
    assert api.resolve_kernel("cuda", torch.device("cuda"), crowded) == "cuda"
    wide = dataclasses.replace(crowded, scene=cfg.scene._replace(height=256, width=256))
    assert api.resolve_kernel("cuda", torch.device("cuda"),
                              dataclasses.replace(wide, kmax=183)) == "cuda"
    assert api.resolve_kernel("cuda", torch.device("cuda"),
                              dataclasses.replace(wide, kmax=184)) == "cuda"
    with pytest.raises(ValueError, match="B5"):
        api.resolve_kernel("cuda", torch.device("cuda"), dataclasses.replace(wide, kmax=0))
    hmc_crowded = dataclasses.replace(crowded, head="hmc")
    assert api.resolve_kernel("cuda", torch.device("cuda"), hmc_crowded) == "cuda"
    # the Riemannian heads run kernel B3, and B4 beyond its domain, also
    # beyond B4's TPU gate (K <= 47 at 256x256); only an empty catalog
    # raises, naming both
    huge = dict(scene=cfg.scene._replace(height=256, width=256), kmax=64)
    for name in ("cfg5_transdim_mcmc", "cfg1_rhmc"):
        big = dataclasses.replace(CONFIGS[name], kmax=64,
                                  rhmc=CONFIGS[name].rhmc._replace(metric="diag"))
        assert api.resolve_kernel("cuda", torch.device("cuda"), big) == "cuda"
        assert api.resolve_kernel("cuda", torch.device("cuda"),
                                  dataclasses.replace(big, **huge)) == "cuda"
        with pytest.raises(ValueError, match="B3.*B4"):
            api.resolve_kernel("cuda", torch.device("cuda"),
                               dataclasses.replace(big, **dict(huge, kmax=0)))
        assert api.resolve_kernel("auto", cpu, CONFIGS[name]) == "torch"
    hmc_td = apply_overrides(CONFIGS["cfg5_transdim_mcmc"], {"tdm.mutation": "hmc"})
    assert api.resolve_kernel("cuda", torch.device("cuda"),
                              dataclasses.replace(hmc_td, kmax=64)) == "cuda"
    assert api.resolve_kernel("cuda", torch.device("cuda"),
                              dataclasses.replace(hmc_td, **dict(huge, kmax=184))) == "cuda"
    with pytest.raises(ValueError, match="B5"):
        api.resolve_kernel("cuda", torch.device("cuda"),
                           dataclasses.replace(hmc_td, **dict(huge, kmax=0)))


def test_unported_head_raises():
    """Every head of the reference is ported: nuts and advi pass the check,
    and a head the reference does not have raises, naming the ported ones."""
    assert api.UNPORTED_HEADS == {}
    for head in ("nuts", "advi"):
        api._check_head(dataclasses.replace(CONFIGS["cfg0_single_star"], head=head))
    cfg = dataclasses.replace(CONFIGS["cfg0_single_star"], head="mala", n_chains=2,
                              n_samples=2, n_warmup=2)
    with pytest.raises(ValueError, match=r"not ported yet \(ROADMAP.md queue A\).*nuts.*advi"):
        api.sample(cfg, "cpu")


def test_short_cfg2_nuts_run_on_the_plain_path():
    cfg = apply_overrides(CONFIGS["cfg2_nuts"], {
        "n_chains": 4, "n_warmup": 12, "n_samples": 6, "thin": 2, "nuts.max_depth": 5})
    out = api.sample(cfg, "cpu", seed=0)
    st = out.stats
    assert st["kernel"] == "torch" and st["trajectory_kernel"] == "torch"
    assert st["kernel_launches"] == 0
    assert out.thetas.shape == (4, 6, 10, 3) and np.isfinite(out.thetas).all()
    assert {"step_size", "accept", "divergences", "wall_seconds"} <= set(st)
    assert 0.0 < st["accept"] <= 1.0 and st["step_size"] > 0
    assert np.isfinite(api.summarize_output(out)["total_flux"]["mean"])


@pytest.mark.parametrize("full_rank", [False, True])
def test_short_cfg7_advi_run_on_the_plain_path(full_rank):
    cfg = apply_overrides(CONFIGS["cfg7_advi"], {"advi.n_steps": 60,
                                                 "advi.full_rank": full_rank})
    out = api.sample(cfg, "cpu", seed=0)
    st = out.stats
    assert st["kernel"] == "torch" and st["kernel_launches"] == 0
    assert st["family"] == ("full_rank" if full_rank else "mean_field")
    assert out.thetas.shape == (api.ADVI_DRAWS, 1, 10, 3) and np.isfinite(out.thetas).all()
    assert np.isfinite(st["elbo"]) and "accept" not in st
    summ = api.summarize_output(out)["total_flux"]
    assert np.isfinite(summ["mean"]) and summ["sd"] > 0


@pytest.mark.parametrize("name", ["cfg2_nuts", "cfg7_advi"])
def test_nuts_and_advi_run_on_the_plain_leapfrog_kernels(name):
    """NUTS leaves and ADVI gradients take B1 on the flagship scene and B5 on
    a crowded one, also beyond B5's TPU gate (K <= 183 at 256x256);
    kernel=cuda for an empty catalog, or off a card, raises."""
    from starcat_torch import dispatch

    cfg = CONFIGS[name]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dispatch.trajectory_kernel(cfg.head, None, cfg.scene, cfg.kmax) == "B1"
    assert api.resolve_kernel("cuda", cuda, cfg) == "cuda"
    assert api.resolve_kernel("auto", cpu, cfg) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        api.resolve_kernel("cuda", cpu, cfg)
    crowded = dataclasses.replace(cfg, scene=cfg.scene._replace(height=128, width=128),
                                  kmax=50)
    assert dispatch.trajectory_kernel(cfg.head, None, crowded.scene, 50) == "B5"
    assert api.resolve_kernel("cuda", cuda, crowded) == "cuda"
    wide = dataclasses.replace(crowded, scene=cfg.scene._replace(height=256, width=256))
    assert api.resolve_kernel("cuda", cuda, wide) == "cuda"
    assert api.resolve_kernel("cuda", cuda, dataclasses.replace(wide, kmax=184)) == "cuda"
    with pytest.raises(ValueError, match="B5"):
        api.resolve_kernel("cuda", cuda, dataclasses.replace(wide, kmax=0))


def test_cli_validate_gates_all_eight_heads():
    res = _cli("validate", "--help")
    assert res.returncode == 0, res.stderr
    assert "hmc,nuts,chees,rhmc,rhmc_diag,smc,advi,transdim" in "".join(res.stdout.split())


def test_overrides_reach_nested_configs():
    cfg = apply_overrides(CONFIGS["cfg6_chees"], {"chees.max_leapfrog": "256",
                                                  "kernel": "torch", "n_chains": "32"})
    assert cfg.chees.max_leapfrog == 256 and cfg.kernel == "torch" and cfg.n_chains == 32
