"""starcat_torch's chain-sharded runs (dist.py) on two gloo processes,
held to the one-process run: the ports of the JAX package's mesh tests
(tests/test_smc.py:272-297, tests/test_nuts.py:163-190,
tests/test_transdim_mcmc.py:242-257, tests/test_fault_recovery.py:388-415).

Each test launches tests/torch_dist_worker.py as two ranks with a
``file://`` rendezvous in its tmp_path, bounded by a timeout, and runs the
same case in this process without a mesh.  Every rank returns the gathered
output; the JAX package compares its sharded runs statistically, because
its psums reorder float sums, while the port reduces gathered tensors in
the one-process order, so here the draws, the adapted step size, mass and
T, log Z, the island diagnostics and every metrics record must be equal
bit for bit (one torch thread in every process).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from starcat_torch import api, dist
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.smc import SMCConfig, run_smc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 240


def _launch(case: str, tmp_path, run_here=None):
    """Run ``case`` on WORLD gloo ranks; meanwhile ``run_here()`` in this
    process.  Returns (its result, the ranks' outputs)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = str(tmp_path / case)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"), case, str(r),
         str(WORLD), str(tmp_path / "rendezvous"), out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    try:
        here = run_here() if run_here is not None else None
        logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    ranks = ([dict(np.load(f"{out}.{r}.npz")) for r in range(WORLD)]
             if not case.startswith("crash-") else None)
    return here, ranks


@pytest.mark.parametrize("case", ["hmc", "chees", "rhmc", "nuts", "transdim", "smc"])
def test_sharded_run_equals_one_process(case, tmp_path):
    """hmc, chees (with relocate and its equilibration gate), rhmc (full
    metric, B6's plain version) through api.sample on the cfg0 scene; nuts,
    transdim and smc through their heads on a 12x12 two-star scene, with
    blocks and records.  SMC's 48 particles in 3 islands of 16 split into
    shards of 24, so the middle island straddles the ranks."""
    want, ranks = _launch(case, tmp_path, lambda: worker.run(case))
    for got in ranks:
        assert set(got) == set(want)
        for key in set(want) - {"depth"}:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if case == "nuts":
        # each rank's deepest tree per transition: the ranks stopped at
        # different doublings, and the deeper is the one-process run's
        d0, d1 = (got["depth"] for got in ranks)
        assert len(d0) == worker.N_WARMUP + worker.N_SAMPLES and np.any(d0 != d1)
        np.testing.assert_array_equal(np.maximum(d0, d1), want["depth"])
    if case == "smc":
        assert float(want["beta"]) == 1.0 and len(want["island_diag"]) == 4
    records = json.loads(str(want["records"])) if "records" in want else []
    if case in ("nuts", "transdim"):
        assert sum(e == "sampling_block" for e, _ in records) == 4


@pytest.mark.parametrize("case", ["crash-chees", "crash-smc"])
def test_two_rank_checkpoint_resumes_in_one_process(case, tmp_path):
    """Two ranks run with checkpoints and stop together at the third
    sampling block (ChEES, after its warmup checkpoint) or temperature
    step (SMC); rank 0 wrote the gathered state.  One process resumes the
    file and produces the uninterrupted one-process run's bits."""
    full, _ = _launch(case, tmp_path, lambda: worker.run(case))
    ckpt = str(tmp_path / case) + ".ckpt"
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    saved = torch.load(ckpt, weights_only=True)
    resumed = worker.run(case, checkpoint_path=ckpt, resume=True)
    if case == "crash-smc":
        assert int(saved["state.n_steps"]) == 2 and saved["state.theta"].shape[0] == 48
        for key in ("theta", "mask", "loglik", "beta", "log_z", "eps", "n_steps",
                    "island_diag"):
            np.testing.assert_array_equal(resumed[key], full[key], err_msg=key)
    else:
        assert saved["done"] == 2 * worker.BLOCK and saved["states.theta"].shape[0] == 8
        for key in ("thetas", "accept_prob", "diverged"):
            np.testing.assert_array_equal(resumed[key], full[key][:, 2 * worker.BLOCK:],
                                          err_msg=key)


def test_chains_that_do_not_split_over_the_ranks_raise():
    """C % W != 0 (SMC: P % W) raises before any collective."""
    mesh = dist.Mesh(rank=0, world=2, device=torch.device("cpu"))
    cfg = apply_overrides(CONFIGS["cfg0_single_star"], {"head": "hmc", "n_chains": 3})
    with pytest.raises(ValueError, match="do not split over 2"):
        api.sample(cfg, "cpu", mesh=mesh)
    smc = apply_overrides(CONFIGS["cfg0_single_star"], {"head": "smc", "n_chains": 4,
                                                        "smc.n_particles": 33})
    with pytest.raises(ValueError, match="33 chains/particles"):
        api.sample(smc, "cpu", mesh=mesh)
    spec, prior, img, _ = worker.scene()
    with pytest.raises(ValueError, match="do not split"):
        run_smc(torch.Generator(), spec, img, prior, 2, SMCConfig(n_particles=7), mesh=mesh)


def test_shard_and_mesh_rows():
    """shard keeps a rank's contiguous rows of every tensor of a tree, and
    replicates 0-d tensors and non-tensor leaves; no mesh is the identity."""
    x = torch.arange(24.0).reshape(8, 3)
    tree = (x, torch.tensor(5.0), None, 7, (x[:, 0],))
    for rank in range(4):
        mesh = dist.Mesh(rank, 4, torch.device("cpu"))
        assert mesh.local(8) == slice(2 * rank, 2 * rank + 2)
        got = dist.shard(tree, mesh)
        assert torch.equal(got[0], x[2 * rank:2 * rank + 2])
        assert got[1] is tree[1] and got[2] is None and got[3] == 7
        assert torch.equal(got[4][0], x[2 * rank:2 * rank + 2, 0])
    assert dist.shard(tree, None) is tree and dist.gather(tree, None) is tree
    assert dist.n_global(5, None) == 5 and dist.n_global(5, mesh) == 20


def test_draw_is_full_width_then_sharded():
    """dist.draw calls the draw at every chain's width and keeps this rank's
    rows: each rank's rows equal the one-process draw's, and every rank's
    generator ends in the one-process state."""
    def draws(gen):
        return lambda c: (torch.randn((c, 2), generator=gen),
                          torch.rand((c,), generator=gen))

    gen = torch.Generator().manual_seed(3)
    full = dist.draw(draws(gen), 8, None)
    after = torch.rand((), generator=gen)
    for rank in range(4):
        g = torch.Generator().manual_seed(3)
        got = dist.draw(draws(g), 2, dist.Mesh(rank, 4, torch.device("cpu")))
        assert all(torch.equal(a, b[2 * rank:2 * rank + 2]) for a, b in zip(got, full))
        assert torch.equal(torch.rand((), generator=g), after)


def test_single_process_starts_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        dist.make_mesh()


def test_multihost_smoke_script_on_two_processes(tmp_path):
    """scripts/multihost_smoke_torch.py, launched once per rank: the
    all_reduce, the all_gather and a sharded cfg0 run equal to one
    process's."""
    script = os.path.join(REPO, "scripts", "multihost_smoke_torch.py")
    rdv = f"file://{tmp_path / 'rdv'}"
    procs = [subprocess.Popen([sys.executable, script, "--world-size", str(WORLD),
                               "--rank", str(r), "--init-method", rdv, "--device", "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    recs = [json.loads(out.strip().splitlines()[-1]) for out, _ in logs]
    assert [p.returncode for p in procs] == [0] * WORLD, [e[-2000:] for _, e in logs]
    assert all(r["ok"] and r["all_reduce"] and r["all_gather"] for r in recs)
    assert recs[0]["sharded_equals_one_process"] is True
