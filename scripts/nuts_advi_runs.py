"""The NUTS and ADVI heads on the GPU: full preset runs, the kernel route
beside the plain one, and the records they are gated against.

    python scripts/nuts_advi_runs.py [--nuts-seeds 0 1] [--advi-seeds 0 1 2 3]
                                     [--turns-warmup 50] [--turns-samples 25]
                                     [--out chiprun_out/nuts_advi.jsonl]

1. cfg2_nuts as the preset stands (1024 chains, 500 + 1000, max depth 8)
   on each of --nuts-seeds: wall, B1 launches (the leaves of the deepest
   chain's tree, a transition), accept, step size, divergences, total flux
   and split-R-hat, against the gate (flux within 20 of 2170.1, R-hat <
   1.1, accept in 0.7-0.9);
2. cfg2_nuts shortened to --turns-warmup + --turns-samples at full width,
   kernel=torch and kernel=auto in turns (torch, auto, auto, torch), seed 0;
3. cfg7_advi on each of --advi-seeds (mean-field) and once with
   advi.full_rank=true: wall, launches, total flux and ELBO, the
   mean-field runs against the band of PERF.md §2.

One JSON line a run, on stdout and appended to --out, each with the card's
name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NUTS_GATE = {"flux": (2170.1, 20.0), "rhat": 1.1, "accept": (0.7, 0.9)}
ADVI_BAND = {"total_flux": (1995.7, 2283.5), "elbo": (19021.9, 19056.4)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nuts-seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--advi-seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--turns-warmup", type=int, default=50)
    ap.add_argument("--turns-samples", type=int, default=25)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "nuts_advi.jsonl"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("nuts_advi_runs: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from starcat_torch.api import sample, summarize_output
    from starcat_torch.configs import CONFIGS, apply_overrides

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def run(name, seed, tag, over):
        cfg = apply_overrides(CONFIGS[name], over)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(cfg, "cuda", seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = {k: v for k, v in out.stats.items() if k != "truth"}
        tf = summarize_output(out)["total_flux"]
        rec = {"run": tag, "config": name, "seed": seed, "overrides": over, "card": card,
               "wall_s": wall, "stats": st, "total_flux": tf}
        if cfg.head == "nuts":
            n_trans = cfg.n_warmup + cfg.n_samples * cfg.thin
            rec["launches_per_transition"] = st["kernel_launches"] / n_trans
            mean, tol = NUTS_GATE["flux"]
            lo, hi = NUTS_GATE["accept"]
            rec["gate"] = {"flux": abs(tf["mean"] - mean) <= tol,
                           "rhat": tf["rhat"] < NUTS_GATE["rhat"],
                           "accept": lo <= st["accept"] <= hi}
        elif not cfg.advi.full_rank:   # the band is the mean-field family's
            got = {"total_flux": tf["mean"], "elbo": st["elbo"]}
            rec["band"] = {k: lo <= got[k] <= hi for k, (lo, hi) in ADVI_BAND.items()}
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        with out_path.open("a") as f:
            f.write(line + "\n")

    # build B1 and warm up
    run("cfg2_nuts", 0, "warm", {"n_chains": 64, "n_warmup": 5, "n_samples": 5})
    for seed in args.nuts_seeds:
        run("cfg2_nuts", seed, "preset", {})
    short = {"n_warmup": args.turns_warmup, "n_samples": args.turns_samples}
    for kernel in ("torch", "auto", "auto", "torch"):
        run("cfg2_nuts", 0, f"turns {kernel}", {**short, "kernel": kernel})
    for seed in args.advi_seeds:
        run("cfg7_advi", seed, "preset", {})
    run("cfg7_advi", 0, "full_rank", {"advi.full_rank": True})


if __name__ == "__main__":
    main()
