"""CLI entry point (port of starcat/__main__.py): `python -m starcat_torch`.

Commands:
  list                                                list presets
  run       --config cfg6_chees [--device cuda] [key=value ...]
  validate  [--config cfg0_single_star] [--heads hmc,chees] [--device cuda]

``--device`` defaults to cuda, and a run raises when CUDA is not available;
pass ``--device cpu`` to run the plain torch path on the CPU.
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
        print(f"{name:22s} head={cfg.head:6s} scene={cfg.scene.height}x{cfg.scene.width} "
              f"stars={cfg.n_stars} kmax={cfg.kmax} {cfg.notes}")


def cmd_run(args):
    from .api import sample, summarize_output
    from .configs import CONFIGS, apply_overrides

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown config {args.config!r}; try: {', '.join(CONFIGS)}")
    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head == "oracle":
        cfg = apply_overrides(cfg, {"head": "hmc"})  # oracle preset -> HMC head
    out = sample(cfg, args.device, seed=args.seed)
    record = {
        "config": cfg.name,
        "head": cfg.head,
        "stats": {k: v for k, v in out.stats.items() if k != "truth"},
        "summary": summarize_output(out),
    }
    print(json.dumps(record, default=float))


def cmd_validate(args):
    """Gate each head against the NumPy oracle on the single-star scene:
    the posterior means of ux, uy and log f must agree within z < 4."""
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
        hcfg = dataclasses.replace(cfg, head=head, n_chains=16, n_samples=1000,
                                   n_warmup=400)
        out = sample(hcfg, args.device, seed=2)
        hrep = {}
        hok = True
        for j, nm in enumerate(["ux", "uy", "log_flux"]):
            cmp = diagnostics.compare_moments(
                out.thetas[:, :, 0, j], orc_draws[:, :, 0, j], nm)
            hrep[nm] = {"z": round(cmp["z"], 2),
                        "head": round(cmp["a"]["mean"], 4),
                        "oracle": round(cmp["b"]["mean"], 4)}
            hok &= cmp["z"] < 4.0
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
    p_run.add_argument("overrides", nargs="*", help="key=value overrides")
    p_run.set_defaults(fn=cmd_run)

    p_val = sub.add_parser("validate", help="oracle vs port validation")
    p_val.add_argument("--config", default="cfg0_single_star")
    p_val.add_argument("--heads", default="hmc,chees",
                       help="comma-separated heads to gate against the oracle")
    p_val.add_argument("--device", default="cuda")
    p_val.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
