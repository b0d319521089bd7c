"""CLI entry point (port of starcat/__main__.py): `python -m starcat_torch`.

Commands:
  list                                                list presets
  run       --config cfg6_chees [--device cuda] [--checkpoint PATH]
            [--metrics PATH] [--resume] [key=value ...]
  validate  [--config cfg0_single_star]
            [--heads hmc,nuts,chees,rhmc,rhmc_diag,smc,advi,transdim]
            [--device cuda]

The presets: cfg0_single_star, cfg1_rhmc, cfg2_nuts, cfg3_transdim_smc,
cfg4_crowded, cfg5_transdim_mcmc, cfg6_chees and cfg7_advi.

``--device`` defaults to cuda, and a run raises when CUDA is not available;
pass ``--device cpu`` to run the plain torch path on the CPU.

``run --metrics PATH`` appends the run's JSONL records (warmup phases,
sampling blocks, SMC temperature steps, ADVI windows, the end of the run)
to PATH; ``--checkpoint PATH`` writes a checkpoint after every sampling
block (SMC: every temperature step), and ``--resume`` continues a killed
run from it, printing the summary of the remaining draws only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parse_overrides(pairs):
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_list(_args):
    from .configs import CONFIGS

    for name, cfg in CONFIGS.items():
        print(f"{name:22s} head={cfg.head:8s} scene={cfg.scene.height}x{cfg.scene.width} "
              f"stars={cfg.n_stars} kmax={cfg.kmax} {cfg.notes}")


def cmd_run(args):
    from .api import sample, summarize_output
    from .configs import CONFIGS, apply_overrides

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown config {args.config!r}; try: {', '.join(CONFIGS)}")
    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head == "oracle":
        cfg = apply_overrides(cfg, {"head": "hmc"})  # oracle preset -> HMC head
    out = sample(cfg, args.device, seed=args.seed, metrics_path=args.metrics,
                 checkpoint_path=args.checkpoint, resume=args.resume)
    record = {
        "config": cfg.name,
        "head": cfg.head,
        "stats": {k: v for k, v in out.stats.items() if k != "truth"},
        "summary": summarize_output(out),
    }
    print(json.dumps(record, default=float))


def cmd_validate(args):
    """Gate each head against the NumPy oracle on the single-star scene:
    the posterior means of ux, uy and log f must agree within z < 4, and
    within z < 6 for advi, whose mean-field family is an approximation
    (its variances are biased low by construction).

    ``rhmc`` runs the reference's default full metric (kernel B6) and
    ``rhmc_diag`` the rhmc head on the diagonal metric (B3).  ``smc`` runs
    as the reference's validate configures it (2048 particles, three HMC
    mutations of 15 steps per temperature); its particles are the draws of
    one series, as are advi's 1000 draws from its fitted q.  ``transdim``
    is gated on the alive-slot marginal: conditional on slot 0 being alive,
    its posterior equals the oracle's fixed-K=1 posterior, so dead draws
    are dropped and each chain is trimmed to the smallest alive count."""
    import numpy as np

    from oracle.numpy_sampler import run_oracle

    from . import diagnostics
    from .api import sample
    from .configs import CONFIGS

    cfg = CONFIGS[args.config]
    truth_theta, img = cfg.make_data()
    orc = run_oracle(
        img.numpy(), cfg.scene.psf_sigma, cfg.scene.background,
        cfg.prior.logf_mean, cfg.prior.logf_sigma,
        n_stars=cfg.n_stars, n_chains=4, n_samples=2000, n_warmup=500,
        step_size=0.05, n_leapfrog=15, seed=1, theta0=truth_theta.numpy(),
    )
    orc_draws = orc["samples"].reshape(4, -1, cfg.n_stars, 3)

    ok = True
    report = {}
    for head in args.heads.split(","):
        metric = "diag" if head == "rhmc_diag" else "full"
        hcfg = dataclasses.replace(
            cfg, head="rhmc" if head == "rhmc_diag" else head, n_chains=16,
            n_samples=1000, n_warmup=400, rhmc=cfg.rhmc._replace(metric=metric),
            smc=cfg.smc._replace(n_particles=2048, mutation="hmc", n_leapfrog=15,
                                 n_mutation_steps=3))
        out = sample(hcfg, args.device, seed=2)
        draws = out.thetas        # (C, N, K, 3); smc: (P, 1, K, 3)
        if draws.shape[1] == 1:
            draws = np.moveaxis(draws, 0, 1)  # particles on the draw axis
        hrep = {}
        if hcfg.head == "rhmc":
            hrep["metric"] = metric
        if head == "transdim":
            alive = out.masks[:, :, 0]                       # (C, N)
            hrep["alive_frac"] = round(float(alive.mean()), 4)
            n_keep = int(alive.sum(1).min())
            if n_keep == 0:
                report[head] = {"validated": False, "kernel": out.stats["kernel"],
                                "reason": "a chain has no alive slot-0 draws",
                                "moments": hrep}
                ok = False
                continue
            draws = np.stack([draws[c][alive[c]][:n_keep] for c in range(draws.shape[0])])
        hok = True
        zmax = 6.0 if head == "advi" else 4.0
        for j, nm in enumerate(["ux", "uy", "log_flux"]):
            cmp = diagnostics.compare_moments(
                draws[:, :, 0, j], orc_draws[:, :, 0, j], nm)
            hrep[nm] = {"z": round(cmp["z"], 2),
                        "head": round(cmp["a"]["mean"], 4),
                        "oracle": round(cmp["b"]["mean"], 4)}
            hok &= cmp["z"] < zmax
        report[head] = {"validated": bool(hok), "kernel": out.stats["kernel"],
                        "moments": hrep}
        ok &= hok
    print(json.dumps({"validated": bool(ok), "config": cfg.name,
                      "heads": report}, default=float))
    sys.exit(0 if ok else 1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="starcat_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list config presets")
    p_list.set_defaults(fn=cmd_list)

    p_run = sub.add_parser("run", help="run a preset")
    p_run.add_argument("--config", required=True)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--device", default="cuda")
    p_run.add_argument("--checkpoint", default=None,
                       help="checkpoint path, written after every block or SMC step")
    p_run.add_argument("--metrics", default=None, help="JSONL metrics sink")
    p_run.add_argument("--resume", action="store_true",
                       help="continue a killed run from --checkpoint")
    p_run.add_argument("overrides", nargs="*", help="key=value overrides")
    p_run.set_defaults(fn=cmd_run)

    p_val = sub.add_parser("validate", help="oracle vs port validation")
    p_val.add_argument("--config", default="cfg0_single_star")
    p_val.add_argument("--heads", default="hmc,nuts,chees,rhmc,rhmc_diag,smc,advi,transdim",
                       help="comma-separated heads to gate against the oracle "
                            "(default: %(default)s)")
    p_val.add_argument("--device", default="cuda")
    p_val.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
