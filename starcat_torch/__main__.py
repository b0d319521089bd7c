"""CLI entry point (port of starcat/__main__.py): `python -m starcat_torch`.

Commands:
  list                                                list presets
  run       --config cfg6_chees [--device cuda] [--checkpoint PATH]
            [--metrics PATH] [--trace DIR] [--resume] [key=value ...]
  report    --config cfg0_single_star [--device cuda] [--seed S]
            [--out-prefix P] [key=value ...]
  validate  [--config cfg0_single_star]
            [--heads hmc,nuts,chees,rhmc,rhmc_diag,smc,advi,transdim]
            [--device cuda]
  bench     [--chains 32768] [--leapfrog 20] [--scan 50] [--repeats 3]
            [--full] [--scaling] [--retime-baseline] [--device cuda]
            [--out build/bench_full_torch.json]

The presets: cfg0_single_star, cfg1_rhmc, cfg2_nuts, cfg3_transdim_smc,
cfg4_crowded, cfg5_transdim_mcmc, cfg6_chees and cfg7_advi.

``--device`` defaults to cuda, and a run raises when CUDA is not available;
pass ``--device cpu`` to run the plain torch path on the CPU.

``run --metrics PATH`` appends the run's JSONL records (warmup phases,
sampling blocks, SMC temperature steps, ADVI windows, the end of the run)
to PATH; ``--checkpoint PATH`` writes a checkpoint after every sampling
block (SMC: every temperature step), and ``--resume`` continues a killed
run from it, printing the summary of the remaining draws only.
``--trace DIR`` runs the job under ``torch.profiler`` (metrics.profile_trace)
and writes its Chrome trace ``trace_<pid>.json`` and the program's spans and
counters ``spans_<pid>.json`` into DIR.

``report`` runs a preset on the device and writes ``P_catalog.json`` (the
condensed catalog and completeness / purity against the mock truth,
catalogs.catalog_report) and, when matplotlib imports, the trace, corner
(single-star runs) and reconstruction PNGs of plots.save_report.  Without
matplotlib the printed JSON names the PNGs it skipped and why; the run and
the catalog are the same either way.

``bench`` is bench.py's benchmark on the port (bench.py): its last line is
the headline ``leapfrog_grad_evals_per_sec_per_chip``; ``--full`` prints
and writes the secondary legs' document, ``--scaling`` the samples/s of the
sharded HMC head over 1, 2, 4, ... ranks.
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
    from .metrics import profile_trace

    cfg = _load_config(args)
    with profile_trace(args.trace):
        out = sample(cfg, args.device, seed=args.seed, metrics_path=args.metrics,
                     checkpoint_path=args.checkpoint, resume=args.resume)
    record = {
        "config": cfg.name,
        "head": cfg.head,
        "stats": {k: v for k, v in out.stats.items() if k != "truth"},
        "summary": summarize_output(out),
    }
    print(json.dumps(record, default=float))


def _load_config(args):
    from .configs import CONFIGS, apply_overrides

    if args.config not in CONFIGS:
        raise SystemExit(f"unknown config {args.config!r}; try: {', '.join(CONFIGS)}")
    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head == "oracle":
        cfg = apply_overrides(cfg, {"head": "hmc"})  # oracle preset -> HMC head
    return cfg


def cmd_report(args):
    """Run a preset, write the catalog JSON and, with matplotlib, the
    trace/corner/reconstruction PNGs; print one JSON line with the
    reference's keys and the run's stats."""
    from .api import sample, summarize_output
    from .catalogs import catalog_report
    from .plots import report_plots, save_report

    cfg = _load_config(args)
    truth, img = cfg.make_data()
    out = sample(cfg, args.device, seed=args.seed, image=img)
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        paths, skipped = [], {"plots": [f"{args.out_prefix}_{n}.png" for n in report_plots(out)],
                              "reason": f"matplotlib does not import: {e}"}
    else:
        paths, skipped = save_report(out, img.numpy(), args.out_prefix), None
    cat = catalog_report(out, truth_theta=truth.numpy())
    cat_path = f"{args.out_prefix}_catalog.json"
    with open(cat_path, "w") as fh:
        json.dump(cat, fh, default=float)
    paths.append(cat_path)
    record = {"config": cfg.name, "plots": paths, "summary": summarize_output(out),
              "condensed_sources": cat["n_condensed_ge_half"],
              "stats": {k: v for k, v in out.stats.items() if k != "truth"}}
    if skipped is not None:
        record["skipped"] = skipped
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


def cmd_bench(args):
    """bench.py's main (bench.py:633): the headline leg, the pinned or
    re-timed NumPy baseline, with --full the secondary legs' document (one
    line before the headline, and written to --out), or with --scaling the
    scaling document alone."""
    from pathlib import Path

    from . import bench

    device = bench.resolve_device(args.device)
    if args.scaling:
        print(json.dumps(bench.bench_scaling(device=device)))
        return
    out = Path(args.out) if args.out else bench.FULL_OUT
    if args.full and out.name == "BENCH_FULL.json":
        raise SystemExit("BENCH_FULL.json is the TPU's record; pass another --out")
    rate, best = bench.bench_fused_grad_evals(args.chains, args.leapfrog, args.scan,
                                              args.repeats, device)
    np_rate = (bench.bench_numpy_baseline() if args.retime_baseline
               else bench.NUMPY_BASELINE_EVALS_PER_SEC)
    if args.full:
        full = bench.full_document(rate, best, args.chains, args.leapfrog, args.scan,
                                   args.repeats, np_rate, device)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(full, indent=1))
        print(json.dumps({"bench_full": full}))
    print(json.dumps(bench.headline(rate, np_rate)))


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
    p_run.add_argument("--trace", default=None, metavar="DIR",
                       help="profile the job: Chrome trace and the program's spans into DIR")
    p_run.add_argument("--resume", action="store_true",
                       help="continue a killed run from --checkpoint")
    p_run.add_argument("overrides", nargs="*", help="key=value overrides")
    p_run.set_defaults(fn=cmd_run)

    p_rep = sub.add_parser("report", help="run a preset, write its catalog and plots")
    p_rep.add_argument("--config", required=True)
    p_rep.add_argument("--seed", type=int, default=0)
    p_rep.add_argument("--device", default="cuda")
    p_rep.add_argument("--out-prefix", default="starcat_report")
    p_rep.add_argument("overrides", nargs="*", help="key=value overrides")
    p_rep.set_defaults(fn=cmd_report)

    p_val = sub.add_parser("validate", help="oracle vs port validation")
    p_val.add_argument("--config", default="cfg0_single_star")
    p_val.add_argument("--heads", default="hmc,nuts,chees,rhmc,rhmc_diag,smc,advi,transdim",
                       help="comma-separated heads to gate against the oracle "
                            "(default: %(default)s)")
    p_val.add_argument("--device", default="cuda")
    p_val.set_defaults(fn=cmd_validate)

    p_bench = sub.add_parser("bench", help="bench.py's benchmark on the port")
    # 32768 chains: the reference's single-chip operating point (bench.py:635-639)
    p_bench.add_argument("--chains", type=int, default=32768)
    p_bench.add_argument("--leapfrog", type=int, default=20)
    p_bench.add_argument("--scan", type=int, default=50)
    p_bench.add_argument("--repeats", type=int, default=3)
    p_bench.add_argument("--full", action="store_true",
                         help="every secondary leg, as one JSON document before the headline")
    p_bench.add_argument("--scaling", action="store_true",
                         help="samples/s over 1..N ranks (one card each) and exit")
    p_bench.add_argument("--retime-baseline", action="store_true",
                         help="re-time the NumPy baseline instead of the pinned rate")
    p_bench.add_argument("--device", default="cuda")
    p_bench.add_argument("--out", default=None,
                         help="--full's document (default build/bench_full_torch.json)")
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
