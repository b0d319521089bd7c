"""cfg6_chees end to end on two trees in turns on one card: an earlier
checkout (a directory, e.g. a `git archive` of the parent commit unpacked
under build/) and this checkout.

    python scripts/b1_cfg6_turns.py --parent DIR [--seeds 0 1 2 3 1 1] [--out PATH]

For each tree it first runs a short cfg6 (50 + 50) to build its kernels
into that tree's build/kernels/, then runs `python -m starcat_torch run
--config cfg6_chees --seed S --device cuda` in that tree for each seed in
turn, the parent first on even turns and the change first on odd ones.
Each run prints its wall (the API's, around the sampler), its posterior
total flux (mean, sd, split-R-hat) against the record's 2184.8 +- 75.8,
ChEES's adapted step size and trajectory length T, and the step counts of
its sampling leg, n_i = clip(ceil(u_i T / eps), 1, max_leapfrog) with u_i
the Halton points the sampler uses (chees._halton2 at n_warmup + i): their
median, quartiles and range.  The last line is one JSON object with every
run, the median wall of each tree and the median adapted step count of
each; --out writes it to a file as well.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF_FLUX = (2184.8, 75.8)  # runs/cfg6_full_r5.json


def halton2(i: int) -> float:
    """chees._halton2: the base-2 radical inverse of i (16 bits)."""
    return sum(((i >> b) & 1) * 0.5 ** (b + 1.0) for b in range(16)) + 2.0 ** -17


def step_counts(stats: dict, n_warmup: int, n_samples: int, max_leapfrog: int) -> list[int]:
    """The sampling leg's step counts, as chees._chees_iteration draws them."""
    t, eps = stats["traj_length"], stats["step_size"]
    return [min(max(math.ceil(halton2(n_warmup + i) * t / eps), 1), max_leapfrog)
            for i in range(n_samples)]


def run(tree: Path, seed: int, overrides=()) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-m", "starcat_torch", "run", "--config",
                           "cfg6_chees", "--seed", str(seed), "--device", "cuda", *overrides],
                          cwd=tree, env=env, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"cfg6 in {tree} (seed {seed}) failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="the earlier checkout")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 1, 1])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("b1_cfg6_turns: CUDA is not available", file=sys.stderr)
        return 1
    from starcat_torch.configs import CONFIGS

    cfg = CONFIGS["cfg6_chees"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    for tag, tree in trees.items():
        warm = run(tree, 0, ("n_warmup=50", "n_samples=50"))
        print(f"{tag} ({tree}): built and warmed up, {warm['stats']['wall_seconds']:.2f} s")
    runs = []
    for turn, seed in enumerate(args.seeds):
        order = ("parent", "change") if turn % 2 == 0 else ("change", "parent")
        for tag in order:
            rec = run(trees[tag], seed)
            st, tf = rec["stats"], rec["summary"]["total_flux"]
            n = step_counts(st, cfg.n_warmup, cfg.n_samples, cfg.chees.max_leapfrog)
            q = statistics.quantiles(n, n=4)
            row = {"tree": tag, "seed": seed, "wall_s": st["wall_seconds"],
                   "kernel": st["trajectory_kernel"], "launches": st["kernel_launches"],
                   "accept": st["accept"], "step_size": st["step_size"],
                   "traj_length": st["traj_length"], "flux_mean": tf["mean"],
                   "flux_sd": tf["sd"], "rhat": tf["rhat"],
                   "steps": {"median": statistics.median(n), "q1": q[0], "q3": q[2],
                             "min": min(n), "max": max(n)}}
            runs.append(row)
            z = abs(tf["mean"] - REF_FLUX[0]) / REF_FLUX[1]
            print(f"{tag} seed {seed}: {row['wall_s']:.2f} s, {row['kernel']} x{row['launches']}, "
                  f"accept {row['accept']:.3f}, eps {row['step_size']:.4g}, T "
                  f"{row['traj_length']:.4g}, sampling-leg steps median {row['steps']['median']} "
                  f"(quartiles {q[0]:.0f}-{q[2]:.0f}, range {min(n)}-{max(n)}); total flux "
                  f"{tf['mean']:.2f} +- {tf['sd']:.2f} ({z:.3f} sd from the record), R-hat "
                  f"{tf['rhat']:.4f}")
    summary = {"card": smi.splitlines()[0], "runs": runs}
    for tag in trees:
        mine = [r for r in runs if r["tree"] == tag]
        summary[f"median_wall_s_{tag}"] = statistics.median(r["wall_s"] for r in mine)
        summary[f"median_steps_{tag}"] = statistics.median(r["steps"]["median"] for r in mine)
    print(json.dumps(summary))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
