"""The port of bench.py (starcat_torch/bench.py, ``python -m starcat_torch
bench``) on the CPU, where every wrapper runs its kernel's plain version:
each leg at a tiny size, the headline's trajectory loop and the Riemannian
legs' loop against bench.py's own loops over the Pallas kernels (interpret
mode), the CLI's headline line, the guards that stop a leg from timing the
wrong thing, and the scaling harness over two gloo ranks.  The legs run on
the card in chip_smoke.py."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import starcat
from starcat.configs import CONFIGS as JAX_CONFIGS
from starcat.pallas_kernels import make_pallas_leapfrog
from starcat.pallas_rhmc_diag import make_pallas_rhmc_diag_leapfrog
from starcat_torch import bench, fused_leapfrog, fused_rhmc_diag
from starcat_torch.__main__ import main as cli_main
from starcat_torch.configs import CONFIGS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
C, L, N_SCAN, REPEATS = 8, 3, 2, 1

# each leg at the tiny size: (call, chains x steps x trajectories of each
# timed call, in the order the leg times them); the crowded diagonal leg and
# B6 run one Picard sweep, the cut that keeps the file quick
LEGS = {
    "fused_grad_evals": (lambda: bench.bench_fused_grad_evals(C, L, N_SCAN, REPEATS, "cpu"),
                         [C * L * N_SCAN]),
    "plain_grad_evals": (lambda: bench.bench_plain_grad_evals(C, L, N_SCAN, REPEATS, "cpu"),
                         [C * L * N_SCAN]),
    "fused_rhmc_steps": (lambda: bench.bench_fused_rhmc_steps(C, L, 1, REPEATS, N_SCAN, "cpu"),
                         [C * L * N_SCAN]),
    "plain_rhmc_diag_steps": (
        lambda: bench.bench_plain_rhmc_diag_steps(C, L, 2, REPEATS, N_SCAN, "cpu"),
        [C * L * N_SCAN]),
    "fused_rhmc_diag_steps": (
        lambda: bench.bench_fused_rhmc_diag_steps(C, L, 2, REPEATS, N_SCAN, "cpu"),
        [C * L * N_SCAN]),
    "rhmc_diag_crowded": (
        lambda: bench.bench_rhmc_diag_crowded(C, REPEATS, N_SCAN, L, 1, "cpu"),
        [C * L * N_SCAN] * 2),
    "fused_crowded": (lambda: bench.bench_fused_crowded(C, L, N_SCAN, REPEATS, "cpu"),
                      [C * L * N_SCAN]),
    "plain_crowded": (lambda: bench.bench_plain_crowded(C, L, N_SCAN, REPEATS, "cpu"),
                      [C * L * N_SCAN]),
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_trajectory_leg_runs_on_the_cpu(leg, monkeypatch):
    """Each trajectory leg returns positive rates of chains x steps x
    trajectories over its best timed call, and ran its plain version (a
    kernel leg raises if its launch count moved, any leg if its final state
    is not finite)."""
    call, work = LEGS[leg]
    bests, best_of = [], bench._best_of

    def record(*args):
        best, out = best_of(*args)
        bests.append(best)
        return best, out

    monkeypatch.setattr(bench, "_best_of", record)
    got = call()
    # (rate, best s), a rate alone, or the crowded leg's (plain, cuda) rates
    rates = [got] if isinstance(got, float) else list(got[:len(work)])
    assert len(bests) == len(work)
    for rate, best, n in zip(rates, bests, work):
        assert rate > 0 and rate * best == pytest.approx(n)


def test_ess_legs_run_on_the_cpu():
    """NUTS and ChEES ESS/s at 8 chains, 10 warmup + 5 + 5 draws."""
    rate, ess, dt = bench.bench_ess_per_sec(C, 5, 10, "cpu")
    assert rate == pytest.approx(ess / dt) and np.isfinite(ess) and ess > 0
    rate, ess, dt, traj = bench.bench_ess_chees(C, 5, 10, "cpu")
    assert rate == pytest.approx(ess / dt) and ess > 0 and np.isfinite(traj) and traj > 0


def test_numpy_baseline_is_positive():
    assert bench.bench_numpy_baseline(n_evals=50, repeats=1) > 0


def _flagship():
    cfg = JAX_CONFIGS["cfg2_nuts"]
    truth, img = cfg.make_data()
    rng = np.random.default_rng(0)
    theta = (np.asarray(truth)[None]
             + 0.01 * rng.standard_normal((C,) + truth.shape)).astype(np.float32)
    return cfg, np.asarray(img), theta, rng


def test_headline_loop_matches_bench_py_loop():
    """The headline's loop (three L = 5 trajectories, the gradient carried)
    on B1's plain version against bench.py:81-90's lax.scan over the Pallas
    kernel in interpret mode, on the same theta0, p0 and entry gradient;
    tests/test_pallas.py's tolerances."""
    cfg, img, theta, rng = _flagship()
    p = rng.standard_normal(theta.shape).astype(np.float32)
    mask = jnp.ones(cfg.kmax)
    inv_mass = jnp.ones((cfg.kmax, 3))
    pg = starcat.make_potential_and_grad(cfg.scene, jnp.asarray(img), cfg.prior)
    grad = np.asarray(jax.vmap(lambda th: pg(th, mask))(jnp.asarray(theta))[1])
    fused_j = make_pallas_leapfrog(cfg.scene, jnp.asarray(img), cfg.prior, cfg.kmax, 5,
                                   interpret=True)

    def body(carry, _):
        th, pp, g = carry
        th, pp, _, g = fused_j(th, pp, 0.002, inv_mass, mask, grad=g)
        return (th, pp, g), None

    want = jax.lax.scan(body, (jnp.asarray(theta), jnp.asarray(p), jnp.asarray(grad)), None,
                        length=3)[0]
    tcfg = CONFIGS["cfg2_nuts"]
    fused = fused_leapfrog.make_fused_leapfrog(tcfg.scene, torch.from_numpy(img.copy()),
                                               tcfg.prior, tcfg.kmax, 5)
    th, pp, g = bench._leapfrog_loop(fused, torch.from_numpy(theta), torch.from_numpy(p),
                                     torch.from_numpy(grad.copy()), 0.002,
                                     torch.ones(tcfg.kmax, 3), torch.ones(tcfg.kmax), 3)
    np.testing.assert_allclose(th.numpy(), np.asarray(want[0]), atol=3e-4)
    np.testing.assert_allclose(pp.numpy(), np.asarray(want[1]), atol=5e-3)
    rel = np.abs(g.numpy() - np.asarray(want[2])) / (1.0 + np.abs(np.asarray(want[2])))
    assert rel.max() < 5e-3, rel.max()


def test_riemannian_loop_matches_bench_py_loop():
    """_timed_trajectories (warm call and one repeat of one trajectory each,
    theta carried, the same xi) on B3's plain version against
    bench.py:154-161's lax.scan of two trajectories over the Pallas kernel
    in interpret mode; tests/test_pallas_rhmc_diag.py's tolerances."""
    cfg, img, theta, rng = _flagship()
    xi = rng.standard_normal(theta.shape).astype(np.float32)
    n_steps, fpi = 2, 2
    fused_j = make_pallas_rhmc_diag_leapfrog(cfg.scene, jnp.asarray(img), cfg.prior, cfg.kmax,
                                             n_steps, fpi, interpret=True)
    mask = jnp.ones(cfg.kmax)

    def body(carry, _):
        out = fused_j(carry[0], jnp.asarray(xi), 0.02, mask, 1.0)
        return (out[0], out[1]), None

    want = jax.lax.scan(body, (jnp.asarray(theta), jnp.zeros_like(theta)), None, length=2)[0]
    tcfg = CONFIGS["cfg2_nuts"]
    fused = fused_rhmc_diag.make_fused_rhmc_diag(tcfg.scene, torch.from_numpy(img.copy()),
                                                 tcfg.prior, tcfg.kmax, n_steps, fpi)
    rate, best, out = bench._timed_trajectories(fused, torch.from_numpy(theta),
                                                torch.from_numpy(xi), torch.ones(tcfg.kmax),
                                                n_steps, 1, 1, "cpu")
    assert rate * best == pytest.approx(C * n_steps)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want[1]), atol=1e-3)


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "starcat_torch", "bench", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=env)


def test_crowded_start_is_bench_py_start():
    """The crowded mutation leg starts from bench.py:280-281's theta0."""
    jcfg = JAX_CONFIGS["cfg4_crowded"]
    want = (starcat.sample_prior(jax.random.key(5), jcfg.kmax, jcfg.prior)[None]
            + 0.01 * jax.random.normal(jax.random.key(6), (C, jcfg.kmax, 3)))
    got = bench.crowded_theta0(CONFIGS["cfg4_crowded"], C)
    assert got.shape == (C, jcfg.kmax, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cli_prints_the_headline_last():
    res = _cli("--device", "cpu", "--chains", "8", "--leapfrog", "3", "--scan", "2",
               "--repeats", "1")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    head = json.loads(lines[-1])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert head["metric"] == "leapfrog_grad_evals_per_sec_per_chip" and head["unit"] == "evals/s"
    assert head["value"] > 0 and head["vs_baseline"] == round(head["value"] / 7472.0, 2)
    assert "repeats" in lines[-2]


def test_cli_default_device_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _cli("--chains", "8", "--leapfrog", "3", "--scan", "2", "--repeats", "1")
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert not res.stdout.strip()


def test_full_document_refuses_the_tpu_record(tmp_path):
    with pytest.raises(SystemExit, match="BENCH_FULL.json"):
        cli_main(["bench", "--device", "cpu", "--full", "--out",
                  str(tmp_path / "BENCH_FULL.json")])
    assert not (tmp_path / "BENCH_FULL.json").exists()


def test_guards_refuse_a_leg_that_timed_the_wrong_thing():
    """On the card a kernel leg needs exactly its launches and an ESS leg
    some; on the CPU none; a non-finite state fails any leg."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    bench._check_launches("leg", 6, 6, cuda)
    bench._check_launches("leg", 0, 6, cpu)
    for got, dev in ((5, cuda), (0, cuda), (6, cpu)):
        with pytest.raises(RuntimeError, match="did not time its kernel"):
            bench._check_launches("leg", got, 6, dev)
    bench._check_ran("leg", 3, cuda)
    for got, dev in ((0, cuda), (3, cpu)):
        with pytest.raises(RuntimeError, match="kernel launches"):
            bench._check_ran("leg", got, dev)
    with pytest.raises(RuntimeError, match="not finite"):
        bench._check_finite("leg", torch.ones(3), torch.tensor([1.0, float("nan")]))


def test_riemannian_guard_allows_only_failed_chains_to_go_non_finite():
    """A Riemannian leg's chains may be non-finite only where the kernel
    marked the solve failed (resid NaN), and not every chain may fail."""
    nan = float("nan")
    theta = torch.zeros(3, 2, 3)
    theta[1, 0, 0] = nan
    h = torch.zeros(3)
    ok_resid = torch.tensor([0.0, nan, 0.0])
    assert bench._check_trajectories("leg", (theta, theta, h, h, h, ok_resid)) == 1
    with pytest.raises(RuntimeError, match="non-finite chains"):
        bench._check_trajectories("leg", (theta, theta, h, h, h, torch.zeros(3)))
    with pytest.raises(RuntimeError, match="3 of 3 marked failed"):
        bench._check_trajectories("leg", (theta, theta, h, h, h, torch.full((3,), nan)))


def test_bound_rate_is_the_kernel_tables():
    """B1's bound rate on the flagship: 1024 chains x 20 evaluations in the
    0.0188 ms of PERF.md's table."""
    cfg = CONFIGS["cfg2_nuts"]
    rate = bench.b1_bound_evals_per_sec(cfg.scene, cfg.kmax)
    assert 1024 * 20 / rate * 1e3 == pytest.approx(0.0188, abs=5e-5)


def test_scaling_over_two_gloo_ranks():
    """bench_scaling with verify: a row of one rank and a row of two, each
    rank holding its share of the chains, the pooled warmup gathering only
    across two ranks, and the first row's efficiency 1."""
    out = bench.bench_scaling(device_counts=[1, 2], n_chains=8, n_samples=3, n_leapfrog=3,
                              verify=True, device="cpu")
    assert out["metric"] == "hmc_samples_per_sec_scaling"
    assert out["process_group"] == "gloo"
    pts = out["points"]
    assert [p["devices"] for p in pts] == [1, 2]
    for p in pts:
        assert p["chains"] % p["devices"] == 0 and p["samples_per_sec"] > 0
        assert p["efficiency_vs_1dev"] > 0
    assert pts[0]["efficiency_vs_1dev"] == 1.0
