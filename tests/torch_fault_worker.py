"""Worker for tests/test_torch_fault_recovery.py: one small run of a
starcat_torch head on a 12x12 two-star scene, on the CPU, in a process of
its own.

    python tests/torch_fault_worker.py crash  HEAD CKPT OUT
    python tests/torch_fault_worker.py crash-in-save HEAD CKPT OUT
    python tests/torch_fault_worker.py resume HEAD CKPT OUT
    python tests/torch_fault_worker.py crash-api CONFIG OVERRIDES DEVICE CKPT

``crash`` runs with checkpoints and SIGKILLs itself from the logger: at the
third sampling block's record (the MCMC heads log a block before saving it,
so the checkpoint holds two of four blocks) or at the fourth SMC
temperature step's (three steps saved).  ``crash-in-save`` SIGKILLs
itself inside the save after those, between the write of CKPT.tmp and its
rename over CKPT (KILL_IN_SAVE: ChEES also saves after its warmup), so
CKPT holds the same state as after ``crash``.  ``resume`` continues from the
checkpoint and saves what it produced to OUT (``np.savez``).  The test
runs the uninterrupted run in its own process with :func:`run`; both pin
torch to one thread so the CPU's reductions give the same bits in both.
``crash-api`` does the same through ``api.sample`` for a preset with
key=value OVERRIDES (comma-separated) on DEVICE, its records in
CKPT.jsonl: tests/test_torch_cuda.py kills runs on the card with it.
"""
from __future__ import annotations

import os
import signal
import sys

import numpy as np
import torch

HEADS = ("hmc", "chees", "transdim", "smc")
N_SAMPLES, N_WARMUP, BLOCK = 16, 12, 4
KILL_AT = {"sampling_block": 3, "smc_temperature_step": 4}
# the save whose rename never happens: the third block's (ChEES: after the
# warmup's save), SMC's fourth step's
KILL_IN_SAVE = {"hmc": 3, "chees": 4, "transdim": 3, "smc": 4}


def scene():
    """spec, prior and image of a 12x12 scene with two stars, and its truth."""
    from starcat_torch import PriorSpec, SceneSpec, constrain, make_mock_image, sample_prior

    spec = SceneSpec(12, 12, 1.5, 4.0)
    prior = PriorSpec(4.0, 0.6)
    g = torch.Generator().manual_seed(0)
    truth = sample_prior(g, 2, prior, "cpu")
    x, y, f = constrain(truth, spec)
    return spec, prior, make_mock_image(g, x, y, f, spec), truth


def run(head: str, checkpoint_path=None, resume=False, logger=None, block=BLOCK):
    """One run of ``head``; returns its output as a dict of numpy arrays."""
    from starcat_torch.chees import ChEESConfig, make_chees_relocate, run_chees
    from starcat_torch.hmc import HMCConfig, run_hmc
    from starcat_torch.potential import make_potential_and_grad
    from starcat_torch.smc import SMCConfig, run_smc
    from starcat_torch.transdim import TransDimConfig
    from starcat_torch.transdim_mcmc import TransDimMCMCConfig, run_transdim

    spec, prior, img, truth = scene()
    gen = torch.Generator().manual_seed(3)
    dur = dict(checkpoint_path=checkpoint_path, resume=resume, logger=logger)
    if head == "smc":
        cfg = SMCConfig(n_particles=64, mutation="hmc", n_mutation_steps=2, n_leapfrog=4,
                        max_steps=40, n_transdim_sweeps=1,
                        transdim=TransDimConfig(lam_count=2.0))
        res = run_smc(gen, spec, img, prior, 4, cfg, **dur)
        return {"theta": res.theta.numpy(), "mask": res.mask.numpy(),
                "beta": res.beta.numpy(), "log_z": res.log_z.numpy(),
                "n_steps": res.n_steps.numpy()}
    if head == "transdim":
        cfg = TransDimMCMCConfig(mutation="rhmc_diag", n_leapfrog=3, fixed_point_iters=2,
                                 n_transdim_sweeps=1, transdim=TransDimConfig(lam_count=2.0))
        res, _ = run_transdim(gen, spec, img, prior, 4, 4, N_SAMPLES, N_WARMUP, cfg,
                              block_size=block, **dur)
        return {"thetas": res.thetas.numpy(), "masks": res.masks.numpy()}
    mask = torch.ones(2)
    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    theta0 = truth[None] + 0.01 * torch.randn((4, 2, 3), generator=gen)
    if head == "hmc":
        res, _ = run_hmc(gen, grad_fn, theta0, mask, N_SAMPLES, N_WARMUP,
                         HMCConfig(step_size=0.05, n_leapfrog=5), block_size=block, **dur)
    else:
        cfg = ChEESConfig(step_size=0.05, max_leapfrog=16, max_eq_stages=1)
        res, _ = run_chees(gen, grad_fn, theta0, mask, N_SAMPLES, N_WARMUP, cfg,
                           relocate_fn=make_chees_relocate(spec, img, prior, gen),
                           block_size=block, **dur)
    return {"thetas": res.thetas.numpy(), "accept_prob": res.accept_prob.numpy()}


class Killer:
    """A logger that SIGKILLs its process at the n-th record of an event."""

    def __init__(self, event: str, n: int):
        self.event, self.n, self.seen = event, n, 0

    def log(self, event, **_):
        if event == self.event:
            self.seen += 1
            if self.seen >= self.n:
                os.kill(os.getpid(), signal.SIGKILL)


def crash_api(config: str, overrides: str, device: str, ckpt: str) -> None:
    """``api.sample`` with checkpoints and a metrics stream whose logger
    SIGKILLs the process at KILL_AT's record of the head."""
    from starcat_torch import api
    from starcat_torch import metrics as tm
    from starcat_torch.configs import CONFIGS, apply_overrides

    cfg = apply_overrides(CONFIGS[config], dict(kv.split("=", 1) for kv in overrides.split(",")))
    event = "smc_temperature_step" if cfg.head == "smc" else "sampling_block"
    log, seen = tm.MetricsLogger.log, []

    def log_then_die(self, ev, **kw):
        log(self, ev, **kw)
        seen.append(ev)
        if seen.count(event) == KILL_AT[event]:
            os.kill(os.getpid(), signal.SIGKILL)

    tm.MetricsLogger.log = log_then_die
    api.sample(cfg, device, seed=0, metrics_path=ckpt + ".jsonl", checkpoint_path=ckpt)


def crash_in_save(head: str, ckpt: str) -> None:
    """The run with checkpoints, SIGKILLed inside its KILL_IN_SAVE-th save:
    CKPT.tmp written and synced, the rename over CKPT not done."""
    replace, renames = os.replace, []

    def replace_or_die(src, dst):
        renames.append(src)
        if len(renames) == KILL_IN_SAVE[head]:
            os.kill(os.getpid(), signal.SIGKILL)
        replace(src, dst)

    os.replace = replace_or_die
    run(head, ckpt)


def main(argv) -> None:
    torch.set_num_threads(1)
    if argv[0] == "crash-api":
        crash_api(*argv[1:])
        raise SystemExit("the worker should have been killed")
    mode, head, ckpt, out = argv
    if mode == "crash-in-save":
        crash_in_save(head, ckpt)
        raise SystemExit("the worker should have been killed")
    if mode == "crash":
        event = "smc_temperature_step" if head == "smc" else "sampling_block"
        run(head, ckpt, logger=Killer(event, KILL_AT[event]))
        raise SystemExit("the worker should have been killed")
    np.savez(out, **run(head, ckpt, resume=True))
    print("WORKER_DONE", mode, head)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
