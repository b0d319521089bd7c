"""The starcat_torch slice end to end on the CPU: both heads against the
NumPy oracle, the CLI, the committed scenes, kernel selection, and the
package's independence from JAX."""
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
    assert "cfg0_single_star" in res.stdout and "cfg6_chees" in res.stdout


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
    code = ("import sys, starcat_torch, starcat_torch.api, starcat_torch.__main__, "
            "starcat_torch.chees, starcat_torch.convert, starcat_torch.fused_leapfrog; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'starcat')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name,jax_name", [("cfg0_single_star", "cfg0_single_star"),
                                           ("cfg6_chees", "cfg6_chees"),
                                           ("cfg6_chees", "cfg2_nuts")])
def test_committed_scenes_equal_jax_make_data(name, jax_name):
    theta_t, img_t = CONFIGS[name].make_data()
    theta_j, img_j = JAX_CONFIGS[jax_name].make_data()
    np.testing.assert_array_equal(theta_t.numpy(), np.asarray(theta_j))
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    assert theta_t.dtype == torch.float32 and img_t.dtype == torch.float32


def test_make_data_refuses_other_seeds():
    cfg = dataclasses.replace(CONFIGS["cfg6_chees"], data_seed=13)
    with pytest.raises(ValueError, match="export_torch_scenes.py"):
        cfg.make_data()


def test_kernel_selection():
    cfg = CONFIGS["cfg6_chees"]
    cpu = torch.device("cpu")
    assert api.resolve_kernel("auto", cpu, cfg) == "torch"
    assert api.resolve_kernel("torch", cpu, cfg) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        api.resolve_kernel("cuda", cpu, cfg)
    with pytest.raises(ValueError, match="kernel must be"):
        api.resolve_kernel("pallas", cpu, cfg)
    crowded = dataclasses.replace(cfg, scene=cfg.scene._replace(height=128, width=128))
    with pytest.raises(ValueError, match="B5"):
        api.resolve_kernel("cuda", torch.device("cuda"), crowded)


def test_unported_head_raises():
    cfg = dataclasses.replace(CONFIGS["cfg0_single_star"], head="nuts", n_chains=2,
                              n_samples=2, n_warmup=2)
    with pytest.raises(ValueError, match="not ported"):
        api.sample(cfg, "cpu")


def test_overrides_reach_nested_configs():
    cfg = apply_overrides(CONFIGS["cfg6_chees"], {"chees.max_leapfrog": "256",
                                                  "kernel": "torch", "n_chains": "32"})
    assert cfg.chees.max_leapfrog == 256 and cfg.kernel == "torch" and cfg.n_chains == 32
