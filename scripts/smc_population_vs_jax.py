"""The SMC head's law in both packages, on the CPU, at a small crowded-style
scene: cfg4_crowded's settings (residual-driven births, twelve trans-d
sweeps, two diagonal-Fisher mutations of 6 x 4, plateau-stopped posterior
rounds) on a smaller scene (32x32 with 8 stars and K_max 16 unless asked
otherwise), a few hundred particles.  Each package draws from its own
generator, so single runs differ; over several seeds their populations
must agree in law.

    JAX_PLATFORMS=cpu python scripts/smc_population_vs_jax.py run --package jax \
        --seeds 0-11 --out runs_jax.jsonl
    JAX_PLATFORMS=cpu python scripts/smc_population_vs_jax.py run --package torch \
        --seeds 0-11 --out runs_torch.jsonl
    python scripts/smc_population_vs_jax.py compare runs_jax.jsonl runs_torch.jsonl

``compare`` also takes ``scripts/smc_trace.py`` records of the port's
runs, one file per seed, so the port's side of the full cfg4 scene can run
on the GPU (``--size 128 --stars 50 --kmax 64`` is the preset's scene).

``run`` writes one JSON line per seed: the tempering steps, the posterior
rounds, log Z, the final star count and total flux, and beta, log Z and
the mean star count after every step.  ``compare`` prints, for each
statistic, both packages' mean over seeds, its standard error and the
difference in combined standard errors, and beta and log Z step by step.
The JAX package runs the XLA ``rhmc_diag`` mutation (the Pallas kernels'
law without their interpret mode), the port its plain trajectory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _jax_setup(args):
    from starcat.configs import CONFIGS as JAX_CONFIGS
    from starcat.potential import SceneSpec

    base = JAX_CONFIGS["cfg4_crowded"]
    # the preset's expected count per star of the truth
    td = base.smc.transdim._replace(lam_count=base.smc.transdim.lam_count * args.stars
                                    / base.n_stars)
    smc_cfg = base.smc._replace(n_particles=args.particles, mutation="rhmc_diag",
                                plateau_window=args.window, max_final_rounds=args.max_rounds,
                                mutation_chunk=min(args.particles, base.smc.mutation_chunk),
                                transdim=td)
    return dataclasses.replace(base, scene=SceneSpec(args.size, args.size, 1.5, 20.0),
                               n_stars=args.stars, kmax=args.kmax, smc=smc_cfg)


def _run(args) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(args.threads)
    jcfg = _jax_setup(args)
    kmax = jcfg.kmax
    _, img = jcfg.make_data()
    lo, hi = (int(v) for v in args.seeds.split("-"))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for seed in range(lo, hi + 1):
            steps: list[list[float]] = []
            t0 = time.perf_counter()
            if args.package == "jax":
                from starcat import smc as jsmc

                class _Log:
                    def log(self, event, **kw):
                        if event == "smc_temperature_step":
                            steps.append([kw["beta"], kw["log_z"], kw["mean_n"]])

                res = jsmc.run_smc(jax.random.key(seed), jcfg.scene, img, jcfg.prior, kmax,
                                   jcfg.smc, logger=_Log())
                theta, mask = np.asarray(res.theta), np.asarray(res.mask)
                log_z, done = float(res.log_z), int(res.final_done)
                n_steps = int(res.n_steps)
            else:
                from starcat_torch import smc
                from starcat_torch.convert import prior_from_jax, smc_config_from_jax, spec_from_jax

                def on_step(s):
                    steps.append(torch.stack([s.beta.double(), s.log_z.double(),
                                              s.mask.sum(-1).double().mean()]).tolist())

                res = smc.run_smc(torch.Generator().manual_seed(seed), spec_from_jax(jcfg.scene),
                                  torch.from_numpy(np.array(img, dtype=np.float32)),
                                  prior_from_jax(jcfg.prior), kmax,
                                  smc_config_from_jax(jcfg.smc), on_step=on_step)
                theta, mask = res.theta.numpy(), res.mask.numpy()
                log_z, done = float(res.log_z), int(res.final_done)
                n_steps = int(res.n_steps)
            counts = mask.sum(-1)
            fh.write(json.dumps({
                "package": args.package, "seed": seed, "particles": args.particles,
                "scene": [args.size, args.stars, kmax],
                "tempering_steps": n_steps - done, "final_rounds": done, "log_z": log_z,
                "count_mean": float(counts.mean()),
                "count_mode": int(np.bincount(counts.astype(int)).argmax()),
                "total_flux": float((np.exp(theta[..., 2]) * mask).sum(-1).mean()),
                "wall_s": time.perf_counter() - t0, "steps": steps}) + "\n")
            fh.flush()
            print(f"{args.package} seed {seed}: {n_steps - done} steps + {done} rounds, "
                  f"log Z {log_z:.3f}, count {counts.mean():.3f}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


def _compare(args) -> None:
    import numpy as np

    runs = {}
    for path in args.files:
        rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
        if rows and "package" not in rows[0]:
            # a scripts/smc_trace.py record of one port run: steps, then totals
            tot = rows[-1]
            rows = [{"package": "torch", "log_z": tot["log_z"],
                     "tempering_steps": tot["n_steps"] - tot["final_rounds"],
                     "final_rounds": tot["final_rounds"], "count_mean": tot["count_mean"],
                     "total_flux": tot["total_flux"],
                     "steps": [[r["beta"], r["log_z"], r["mean_n"]] for r in rows[:-1]]}]
        for r in rows:
            runs.setdefault(r["package"], []).append(r)
    a, b = runs["jax"], runs["torch"]
    print(f"seeds: jax {len(a)}, torch {len(b)}")
    for key in ("tempering_steps", "final_rounds", "log_z", "count_mean", "total_flux"):
        x = np.array([r[key] for r in a], float)
        y = np.array([r[key] for r in b], float)
        se = np.sqrt(x.var(ddof=1) / x.size + y.var(ddof=1) / y.size)
        print(json.dumps({"stat": key, "jax": [x.mean(), x.std(ddof=1) / np.sqrt(x.size)],
                          "torch": [y.mean(), y.std(ddof=1) / np.sqrt(y.size)],
                          "diff": y.mean() - x.mean(),
                          "z": (y.mean() - x.mean()) / se if se > 0 else 0.0}))
    n = min(min(r["tempering_steps"] for r in a), min(r["tempering_steps"] for r in b))
    for i in range(n):
        row = {"step": i + 1}
        for j, name in enumerate(("beta", "log_z", "mean_n")):
            x = np.array([r["steps"][i][j] for r in a])
            y = np.array([r["steps"][i][j] for r in b])
            se = np.sqrt(x.var(ddof=1) / x.size + y.var(ddof=1) / y.size)
            row[name] = [round(float(x.mean()), 6), round(float(y.mean()), 6),
                         round(float((y.mean() - x.mean()) / se), 3) if se > 0 else 0.0]
        print(json.dumps(row))


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=("jax", "torch"), required=True)
    r.add_argument("--seeds", default="0-11", help="inclusive range, e.g. 0-11")
    r.add_argument("--particles", type=int, default=256)
    r.add_argument("--size", type=int, default=32, help="scene height and width")
    r.add_argument("--stars", type=int, default=8, help="stars in the truth")
    r.add_argument("--kmax", type=int, default=16)
    r.add_argument("--window", type=int, default=10, help="plateau_window")
    r.add_argument("--max-rounds", type=int, default=150, help="max_final_rounds")
    r.add_argument("--threads", type=int, default=2)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs="+")
    args = ap.parse_args()
    (_run if args.cmd == "run" else _compare)(args)


if __name__ == "__main__":
    main()
