"""starcat_torch's checkpoint / resume, held to the JAX package's contract
(tests/test_fault_recovery.py, tests/test_chees.py): a worker SIGKILLed
mid-run leaves a checkpoint from which a replacement process produces the
remaining draws with the same bits as an uninterrupted run; an SMC pass
resumes mid-tempering with the same beta, log Z and particles, and from a
beta = 1 checkpoint runs only its remaining posterior rounds; blocked
sampling gives the same bits as one loop for every MCMC head; a checkpoint
that does not fit the run raises with its path.

Everything runs on the CPU at 12x12 with two stars.  The workers and this
process pin torch to one thread (tests/torch_fault_worker.py), so the
CPU's reductions give the same bits in every process.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_fault_worker as worker
from starcat_torch import api
from starcat_torch import metrics as tmetrics
from starcat_torch.checkpoint import CheckpointError, restore_state, save_state
from starcat_torch.configs import CONFIGS, apply_overrides
from starcat_torch.driver import BlockCheckpoint, ChainState, checkpoint_like
from starcat_torch.hmc import HMCConfig, run_hmc
from starcat_torch.nuts import NUTSConfig, run_nuts
from starcat_torch.potential import make_potential_and_grad
from starcat_torch.rhmc import RHMCConfig, run_rhmc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCMC_HEADS = ("hmc", "nuts", "rhmc_full", "rhmc_diag")


def _worker(mode, head, ckpt, out):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_fault_worker.py"), mode, head,
         ckpt, out], capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("head", worker.HEADS)
def test_sigkill_midrun_then_resume_in_a_replacement_process(tmp_path, head):
    """hmc, chees (with its relocate move) and transdim (rhmc_diag
    mutation, B3's plain version) are killed after two of four blocks'
    checkpoints, SMC after three temperature steps'; a new process resumes
    and its output equals the uninterrupted run's, bit for bit."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "resume.npz")
    full = worker.run(head)

    r = _worker("crash", head, ckpt, str(tmp_path / "unused.npz"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")
    saved = torch.load(ckpt, weights_only=True)
    if head == "smc":
        assert int(saved["state.n_steps"]) == worker.KILL_AT["smc_temperature_step"] - 1
    else:
        assert saved["done"] == 2 * worker.BLOCK

    r = _worker("resume", head, ckpt, out)
    assert r.returncode == 0, r.stderr[-2000:]
    resumed = np.load(out)
    for key in resumed.files:
        want = full[key] if head == "smc" else full[key][:, 2 * worker.BLOCK:]
        np.testing.assert_array_equal(resumed[key], want, err_msg=key)
    if head == "smc":
        assert float(full["beta"]) == 1.0
        assert int(full["n_steps"]) > worker.KILL_AT["smc_temperature_step"]


@pytest.mark.parametrize("head", worker.HEADS)
def test_kill_between_the_tmp_write_and_the_rename_resumes_the_previous_checkpoint(
        tmp_path, head):
    """A process SIGKILLed inside a save, after CKPT.tmp is written and
    synced but before the rename, leaves the previous checkpoint whole at
    CKPT; a new process resumes from it (ignoring the orphaned CKPT.tmp,
    which holds the next block or step) to the uninterrupted run's bits."""
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "resume.npz")
    full = worker.run(head)

    r = _worker("crash-in-save", head, ckpt, str(tmp_path / "unused.npz"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    saved = torch.load(ckpt, weights_only=True)
    orphan = torch.load(ckpt + ".tmp", weights_only=True)
    if head == "smc":
        assert int(saved["state.n_steps"]) == worker.KILL_AT["smc_temperature_step"] - 1
        assert int(orphan["state.n_steps"]) == int(saved["state.n_steps"]) + 1
    else:
        assert saved["done"] == 2 * worker.BLOCK and orphan["done"] == 3 * worker.BLOCK

    r = _worker("resume", head, ckpt, out)
    assert r.returncode == 0, r.stderr[-2000:]
    resumed = np.load(out)
    for key in resumed.files:
        want = full[key] if head == "smc" else full[key][:, 2 * worker.BLOCK:]
        np.testing.assert_array_equal(resumed[key], want, err_msg=key)


class _Steps:
    def __init__(self):
        self.steps = 0

    def log(self, event, **_):
        self.steps += event == "smc_temperature_step"


def test_smc_resume_from_beta_one_runs_only_the_remaining_rounds(tmp_path):
    """The beta = 1 checkpoint counts its posterior rounds (final_done): a
    resume with the same budget runs none and returns the same particles,
    one with a budget raised from 3 to 5 runs exactly 2."""
    from starcat_torch.smc import SMCConfig, run_smc

    spec, prior, img, _ = worker.scene()
    cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=2, n_leapfrog=4,
                    max_steps=40, n_final_rounds=3)
    ckpt = str(tmp_path / "smc_final")

    def go(cfg, log, resume):
        return run_smc(torch.Generator().manual_seed(3), spec, img, prior, 4, cfg,
                       checkpoint_path=ckpt, resume=resume, logger=log)

    c1, c2, c3 = _Steps(), _Steps(), _Steps()
    res1 = go(cfg, c1, False)
    assert float(res1.beta) == 1.0 and int(res1.final_done) == 3
    res2 = go(cfg, c2, True)
    assert c2.steps == 0
    np.testing.assert_array_equal(res2.theta.numpy(), res1.theta.numpy())
    assert float(res2.log_z) == float(res1.log_z)
    res3 = go(cfg._replace(n_final_rounds=5), c3, True)
    assert c3.steps == 2 and int(res3.final_done) == 5


def _mcmc(head, block_size=None, **dur):
    """A short run of an MCMC head on the worker's scene (plain trajectories)."""
    spec, prior, img, truth = worker.scene()
    gen = torch.Generator().manual_seed(3)
    mask = torch.ones(2)
    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    theta0 = truth[None] + 0.01 * torch.randn((4, 2, 3), generator=gen)
    n, nw = worker.N_SAMPLES, worker.N_WARMUP
    if head == "hmc":
        return run_hmc(gen, grad_fn, theta0, mask, n, nw, HMCConfig(step_size=0.05, n_leapfrog=5),
                       block_size=block_size, **dur)
    if head == "nuts":
        return run_nuts(gen, grad_fn, theta0, mask, n, nw,
                        NUTSConfig(step_size=0.05, max_depth=4), block_size=block_size, **dur)
    cfg = RHMCConfig(step_size=0.1, n_leapfrog=3, fixed_point_iters=2,
                     metric=head.removeprefix("rhmc_"))
    return run_rhmc(gen, spec, img, prior, theta0, mask, n, nw, cfg,
                    block_size=block_size, **dur)


class _Crash(Exception):
    pass


class _RaiseAt:
    """A logger that raises at the n-th sampling block's record, before
    that block's checkpoint is written."""

    def __init__(self, n):
        self.n, self.seen = n, 0

    def log(self, event, **_):
        if event == "sampling_block":
            self.seen += 1
            if self.seen >= self.n:
                raise _Crash


@pytest.mark.parametrize("head", MCMC_HEADS)
def test_run_mcmc_resume(tmp_path, head):
    """run_mcmc(resume=True) skips warmup and continues from the block
    checkpoint: a run stopped after two of four blocks resumes to the
    uninterrupted run's last draws, and a resume of a finished run gives no
    draws, the same final state and the same step size."""
    ckpt = str(tmp_path / "ck")
    full, wr_full = _mcmc(head, block_size=worker.BLOCK)
    with pytest.raises(_Crash):
        _mcmc(head, block_size=worker.BLOCK, checkpoint_path=ckpt, logger=_RaiseAt(3))
    rest, wr = _mcmc(head, block_size=worker.BLOCK, checkpoint_path=ckpt, resume=True)
    assert rest.thetas.shape[1] == worker.N_SAMPLES - 2 * worker.BLOCK
    assert wr.phase_accept is None
    np.testing.assert_array_equal(rest.thetas.numpy(), full.thetas[:, 2 * worker.BLOCK:].numpy())
    np.testing.assert_array_equal(rest.accept_prob.numpy(),
                                  full.accept_prob[:, 2 * worker.BLOCK:].numpy())
    assert float(wr.step_size) == float(wr_full.step_size)

    done, wr2 = _mcmc(head, block_size=worker.BLOCK, checkpoint_path=ckpt, resume=True)
    assert done.thetas.shape == (4, 0, 2, 3)
    np.testing.assert_array_equal(done.final_states.theta.numpy(),
                                  full.final_states.theta.numpy())
    assert float(wr2.step_size) == float(wr_full.step_size)


@pytest.mark.parametrize("head", MCMC_HEADS + ("chees", "transdim"))
def test_blocked_sampling_equals_unblocked(head):
    """Blocks of 4 (and of 5, which leave a shorter last block) give the
    same draws, acceptances and final state as one loop."""
    if head in ("chees", "transdim"):
        one, b4 = worker.run(head, block=worker.N_SAMPLES), worker.run(head)
        b5 = worker.run(head, block=5)
        for key in one:
            np.testing.assert_array_equal(b4[key], one[key], err_msg=key)
            np.testing.assert_array_equal(b5[key], one[key], err_msg=key)
        return
    one, wr1 = _mcmc(head)
    for block in (4, 5):
        res, wr = _mcmc(head, block_size=block)
        np.testing.assert_array_equal(res.thetas.numpy(), one.thetas.numpy())
        np.testing.assert_array_equal(res.accept_prob.numpy(), one.accept_prob.numpy())
        np.testing.assert_array_equal(res.diverged.numpy(), one.diverged.numpy())
        np.testing.assert_array_equal(res.final_states.theta.numpy(),
                                      one.final_states.theta.numpy())
        if one.solver_fail is not None:
            np.testing.assert_array_equal(res.solver_fail.numpy(), one.solver_fail.numpy())
        np.testing.assert_array_equal(wr.phase_accept.numpy(), wr1.phase_accept.numpy())


def _like(c=4, k=2):
    th = torch.zeros((c, k, 3))
    return checkpoint_like(ChainState(th, torch.zeros(c), th), torch.Generator())


def test_checkpoint_roundtrip_restores_onto_the_run_generator(tmp_path):
    """The payload loads with weights_only=True; the generator's state is
    set on the object in ``like`` (the run's own), not on a new one."""
    path = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(5)
    th = torch.randn((4, 2, 3), generator=gen)
    ck = BlockCheckpoint(ChainState(th, th.sum((1, 2)), 2 * th), 8, torch.tensor(0.03),
                         torch.full((2, 3), 0.5), gen)
    save_state(path, ck)
    want = torch.rand(6, generator=gen)
    like = _like()
    back = restore_state(path, like, "cpu")
    assert back.generator is like.generator and back.done == 8
    torch.testing.assert_close(torch.rand(6, generator=back.generator), want, rtol=0, atol=0)
    for a, b in zip(back.states, ck.states):
        assert torch.equal(a, b)
    assert torch.equal(back.step_size, ck.step_size) and torch.equal(back.inv_mass, ck.inv_mass)
    assert not os.path.exists(path + ".tmp")


def test_corrupt_or_mismatched_checkpoint_raises_with_its_path(tmp_path):
    """A file that does not load, a checkpoint of another shape or layout,
    and a generator state of another device type each raise naming the
    path (the counterpart of test_corrupt_checkpoint_raises_chained_error)."""
    bad = tmp_path / "corrupt_ck"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(CheckpointError, match="corrupt_ck") as ei:
        restore_state(str(bad), _like(), "cpu")
    assert ei.value.__cause__ is not None

    path = str(tmp_path / "shape_ck")
    save_state(path, _like(c=4))
    with pytest.raises(CheckpointError, match="shape_ck.*states.theta"):
        restore_state(path, _like(c=6), "cpu")
    junk = str(tmp_path / "layout_ck")
    torch.save({"junk": torch.zeros(3)}, junk)
    with pytest.raises(CheckpointError, match="layout_ck.*missing"):
        restore_state(junk, _like(), "cpu")

    # a checkpoint of a CUDA run: its generator state is 16 bytes (seed and
    # Philox offset)
    disk = torch.load(path, weights_only=True)
    disk.update({"generator": torch.zeros(16, dtype=torch.uint8), "generator.device": "cuda"})
    cuda_ck = str(tmp_path / "cuda_ck")
    torch.save(disk, cuda_ck)
    with pytest.raises(CheckpointError, match="cuda_ck.*cuda generator state.*cpu"):
        restore_state(cuda_ck, _like(), "cpu")

    # through the head: a resume with another chain count
    ckpt = str(tmp_path / "hmc_ck")
    _mcmc("hmc", block_size=worker.BLOCK, checkpoint_path=ckpt)
    spec, prior, img, truth = worker.scene()
    pg = make_potential_and_grad(spec, img, prior)
    mask = torch.ones(2)
    with pytest.raises(CheckpointError, match="hmc_ck"):
        run_hmc(torch.Generator(), lambda th: pg(th, mask), truth[None].repeat(6, 1, 1), mask,
                worker.N_SAMPLES, worker.N_WARMUP, block_size=worker.BLOCK,
                checkpoint_path=ckpt, resume=True)


def test_api_sample_resume_returns_only_the_remaining_draws(tmp_path, monkeypatch):
    """api.sample with checkpoint_path samples in blocks of n // 4; a run
    stopped after two blocks' checkpoints resumes with resume=True to the
    remaining draws, equal to the last ones of an unblocked, uncheckpointed
    run, as the JAX package's api.sample returns them."""
    cfg = apply_overrides(CONFIGS["cfg0_single_star"], {
        "head": "hmc", "n_chains": "4", "n_samples": "16", "n_warmup": "12"})
    ckpt, mp = str(tmp_path / "api_ck"), str(tmp_path / "m.jsonl")
    full = api.sample(cfg, "cpu", seed=0)

    log = tmetrics.MetricsLogger.log
    seen = []

    def crash_at_third_block(self, event, **kw):
        log(self, event, **kw)
        seen.append(event)
        if seen.count("sampling_block") == 3:
            raise _Crash

    with monkeypatch.context() as m:
        m.setattr(tmetrics.MetricsLogger, "log", crash_at_third_block)
        with pytest.raises(_Crash):
            api.sample(cfg, "cpu", seed=0, metrics_path=mp, checkpoint_path=ckpt)
    rest = api.sample(cfg, "cpu", seed=0, metrics_path=mp, checkpoint_path=ckpt, resume=True)
    assert rest.thetas.shape == (4, 8, 1, 3)
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 8:])
    assert rest.stats["step_size"] == full.stats["step_size"]
