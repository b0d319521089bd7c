"""Worker for tests/test_torch_dist.py: one rank of a chain-sharded
starcat_torch run over torch.distributed (gloo, on the CPU).

    python tests/torch_dist_worker.py CASE RANK WORLD INIT_FILE OUT

Each of WORLD processes joins the group through the ``file://`` rendezvous
INIT_FILE, runs :func:`run` for CASE under the group's mesh and saves what it
returned (the gathered full output, on every rank) to OUT.RANK.npz.  The
test runs the same case in one process with ``mesh=None``; both pin torch
to one thread, so the CPU's reductions give the same bits everywhere.

``crash-*`` cases run with checkpoints and end every rank at the third
sampling block's record (the checkpoint then holds two of four blocks);
the test resumes that checkpoint in one process.  The worker imports no
JAX.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

CASES = ("hmc", "chees", "rhmc", "nuts", "transdim", "smc", "crash-chees", "crash-smc")
N_SAMPLES, N_WARMUP, BLOCK = 16, 12, 4


class Records:
    """A logger that keeps every record (``t`` dropped); with ``stop_at``
    it ends the process at that record of ``sampling_block`` or
    ``smc_temperature_step``, on every rank at the same point."""

    def __init__(self, stop_at: int | None = None):
        self.rows, self.stop_at, self.seen = [], stop_at, 0

    def log(self, event, **kw):
        self.rows.append((event, sorted((k, v if isinstance(v, str) else float(v))
                                        for k, v in kw.items())))
        if self.stop_at is not None and event in ("sampling_block", "smc_temperature_step"):
            self.seen += 1
            if self.seen >= self.stop_at:
                os._exit(0)


def _records(logger: Records) -> np.ndarray:
    return np.array(json.dumps(logger.rows))


def scene():
    """A 12x12 scene with two stars (tests/torch_fault_worker.py's)."""
    from starcat_torch import PriorSpec, SceneSpec, constrain, make_mock_image, sample_prior

    spec, prior = SceneSpec(12, 12, 1.5, 4.0), PriorSpec(4.0, 0.6)
    g = torch.Generator().manual_seed(0)
    truth = sample_prior(g, 2, prior, "cpu")
    return spec, prior, make_mock_image(g, *constrain(truth, spec), spec), truth


def _api(overrides: dict, mesh) -> dict:
    from starcat_torch import api
    from starcat_torch.configs import CONFIGS, apply_overrides

    cfg = apply_overrides(CONFIGS["cfg0_single_star"], overrides)
    out = api.sample(cfg, "cpu", seed=3, mesh=mesh)
    keep = ("accept", "divergences", "step_size", "traj_length", "eq_disagreement",
            "solver_rejections")
    stats = np.array([float(out.stats[k]) for k in keep if out.stats.get(k) is not None])
    return {"thetas": out.thetas, "masks": out.masks, "stats": stats}


def run(case: str, mesh=None, checkpoint_path=None, resume=False, logger=None) -> dict:
    """One run of ``case``, under ``mesh`` when given; its output as numpy."""
    from starcat_torch.chees import ChEESConfig, make_chees_relocate, run_chees
    from starcat_torch.driver import run_mcmc
    from starcat_torch.nuts import NUTSConfig, make_nuts_kernel, plain_leaf
    from starcat_torch.potential import make_potential_and_grad
    from starcat_torch.smc import SMCConfig, run_smc
    from starcat_torch.transdim import TransDimConfig
    from starcat_torch.transdim_mcmc import TransDimMCMCConfig, run_transdim
    from starcat_torch import dist

    if case == "hmc":
        return _api({"head": "hmc", "n_chains": 4, "n_warmup": 30, "n_samples": 20}, mesh)
    if case == "chees":
        return _api({"head": "chees", "n_chains": 4, "n_warmup": 40, "n_samples": 20,
                     "chees.max_leapfrog": 32}, mesh)
    if case == "rhmc":
        return _api({"head": "rhmc", "n_chains": 4, "n_warmup": 16, "n_samples": 8,
                     "rhmc.n_leapfrog": 4, "rhmc.fixed_point_iters": 3}, mesh)

    spec, prior, img, truth = scene()
    gen = torch.Generator().manual_seed(3)
    logger = logger if logger is not None else Records()
    dur = dict(checkpoint_path=checkpoint_path, resume=resume, logger=logger, mesh=mesh)
    if case in ("smc", "crash-smc"):
        # 48 particles in 3 islands of 16 over 2 ranks of 24: the middle
        # island straddles the shards
        cfg = SMCConfig(n_particles=48, mutation="hmc", n_mutation_steps=1, n_leapfrog=3,
                        max_steps=40, n_transdim_sweeps=1, n_islands=3,
                        transdim=TransDimConfig(lam_count=2.0))
        res = run_smc(gen, spec, img, prior, 4, cfg, **dur)
        out = {"theta": res.theta.numpy(), "mask": res.mask.numpy(),
               "loglik": res.loglik.numpy(), "beta": res.beta.numpy(),
               "log_z": res.log_z.numpy(), "eps": res.eps.numpy(),
               "n_steps": res.n_steps.numpy(),
               "island_diag": np.array([res.island_diag[k] for k in sorted(res.island_diag)])}
    elif case == "transdim":
        cfg = TransDimMCMCConfig(step_size=0.05, mutation="hmc", n_leapfrog=5,
                                 n_transdim_sweeps=1, transdim=TransDimConfig(lam_count=2.0))
        res, eps = run_transdim(gen, spec, img, prior, 4, 8, N_SAMPLES, N_WARMUP, cfg,
                                block_size=BLOCK, **dur)
        out = {"thetas": res.thetas.numpy(), "masks": res.masks.numpy(),
               "accept_prob": res.accept_prob.numpy(), "td_accept": res.td_accept.numpy(),
               "eps": eps.numpy()}
    else:
        mask = torch.ones(2)
        pg = make_potential_and_grad(spec, img, prior)
        grad_fn = lambda th: pg(th, mask)  # noqa: E731
        theta0 = dist.shard(truth[None] + 0.01 * torch.randn((8, 2, 3), generator=gen), mesh)
        if case == "nuts":
            # each transition's deepest tree on this rank: the ranks' trees
            # end at different doublings, and the loop must not deadlock
            depth = []
            base = make_nuts_kernel(plain_leaf(grad_fn), mask, NUTSConfig(max_depth=5), gen,
                                    mesh)

            def kernel(st, eps, inv_mass):
                st, info = base(st, eps, inv_mass)
                depth.append(int(info.depth.max()))
                return st, info

            res, wr = run_mcmc(kernel, grad_fn, theta0, N_SAMPLES, N_WARMUP, step_size=0.1,
                               block_size=BLOCK, generator=gen, **dur)
            out = {"depth": np.array(depth), "step_size": wr.step_size.numpy(),
                   "inv_mass": wr.inv_mass.numpy()}
        else:   # chees, crash-chees
            cfg = ChEESConfig(step_size=0.05, max_leapfrog=16, max_eq_stages=1)
            res, ad = run_chees(gen, grad_fn, theta0, mask, N_SAMPLES, N_WARMUP, cfg,
                                relocate_fn=make_chees_relocate(spec, img, prior, gen,
                                                                mesh=mesh),
                                block_size=BLOCK, **dur)
            out = {"traj_length": np.asarray(float(ad["traj_length"]))}
        out.update(thetas=res.thetas.numpy(), accept_prob=res.accept_prob.numpy(),
                   diverged=res.diverged.numpy())
    out["records"] = _records(logger)
    return out


def main(argv) -> None:
    from starcat_torch import dist

    torch.set_num_threads(1)
    case, rank, world, init_file, out = argv
    dist.init_distributed("cpu", init_method=f"file://{init_file}", world_size=int(world),
                          rank=int(rank))
    mesh = dist.make_mesh()
    if case.startswith("crash-"):
        run(case, mesh, checkpoint_path=out + ".ckpt", logger=Records(stop_at=3))
        raise SystemExit("the worker should have ended at the third record")
    res = run(case, mesh)
    np.savez(f"{out}.{rank}.npz", **res)
    torch.distributed.destroy_process_group()
    print("WORKER_DONE", case, rank)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
