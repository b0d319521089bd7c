"""The runs of the wide-field slice on the card, uncut: cfg4's SMC on a
192x192 field at cfg4's star density (112 stars, K_max 125, the preset's
4096 particles, twelve residual-birth sweeps and two 6 x 4 diagonal
mutations a step, on B4), and the crowded ChEES head on the same scene
(1024 chains, K = 112, the preset's 500 + 1000, on B5 through B2's
contract); and on the full metric, B6c's wide path: the same SMC with the
full-metric mutation cut to 8 temperature steps (smc_full), and the rhmc
head on a drawn 128x128 field of 80 stars at K = 80 and the preset's 64
chains, cut from 400 + 1000 to 300 + 300 (rhmc_full), beside the same run
on the diagonal metric, B4 (rhmc_diag).  Beyond the TPU kernels' VMEM
gates, on a 256x256 field at cfg4's density (200 stars; truth_seed 11,
data_seed 12, RunConfig's defaults): W1, cfg4's SMC at K_max 256 and the
preset's widths on B4 (its gate there: K <= 47), cut to W1_STEPS
temperature steps; W2, the crowded ChEES head on W1's field at K = 200
and 1024 chains on B5 (gate: K <= 183), cut to W2_ITERS warmup + draws;
W3, W1 with the full-metric mutation on B6c, cut to W3_STEPS steps; W4,
the rhmc head on a drawn 128x128 field of 300 stars at K = 300 and the
preset's 64 chains on B6c (beyond K = 256, D = 900), cut to W4_ITERS
warmup + draws.  They are the CLI's

    python -m starcat_torch run --config cfg4_crowded scene.height=192 \\
        scene.width=192 n_stars=112 kmax=125 --device cuda
    python -m starcat_torch run --config cfg4_crowded scene.height=192 \\
        scene.width=192 n_stars=112 kmax=112 head=chees n_chains=1024 --device cuda
    python -m starcat_torch run --config cfg4_crowded scene.height=192 \\
        scene.width=192 n_stars=112 kmax=125 smc.mutation=rhmc smc.max_steps=8 --device cuda
    python -m starcat_torch run --config cfg1_rhmc scene.height=128 \\
        scene.width=128 n_stars=80 kmax=80 n_warmup=300 n_samples=300 --device cuda
    (the last also with rhmc.metric=diag)
    python -m starcat_torch run --config cfg4_crowded scene.height=256 \
        scene.width=256 n_stars=200 kmax=256 smc.max_steps=8 --device cuda
    python -m starcat_torch run --config cfg4_crowded scene.height=256 \
        scene.width=256 n_stars=200 kmax=200 head=chees n_chains=1024 \
        n_warmup=40 n_samples=40 --device cuda
    python -m starcat_torch run --config cfg4_crowded scene.height=256 \
        scene.width=256 n_stars=200 kmax=256 smc.mutation=rhmc smc.max_steps=4 --device cuda
    python -m starcat_torch run --config cfg1_rhmc scene.height=128 \
        scene.width=128 n_stars=300 kmax=300 n_warmup=60 n_samples=60 --device cuda

run through api.sample as the CLI runs them (seed 0), with the kernel's
launch count set to 0 just before each run and read just after.

    python scripts/wide_runs.py [--only NAME ...] [--out PATH]

Each run appends one JSON line to --out as soon as it ends and prints it:
the card's name and power limit, the wall, the kernel and its launches,
the head's stats, the total flux (mean, sd, ESS, split R-hat) and star
count against the drawn truth, the peak device memory, the seconds a
temperature step or an iteration (warmup and draws), and for the SMC
runs each temperature step's beta, accept rate, step size, divergences,
solver rejections and seconds.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SCENE = {"scene.height": 192, "scene.width": 192, "n_stars": 112}
RHMC = {"scene.height": 128, "scene.width": 128, "n_stars": 80, "kmax": 80, "n_warmup": 300,
        "n_samples": 300}
BEYOND = {"scene.height": 256, "scene.width": 256, "n_stars": 200}
W1_STEPS, W3_STEPS, W2_ITERS, W4_ITERS = 8, 4, (40, 40), (60, 60)
W1 = {**BEYOND, "kmax": 256, "smc.max_steps": W1_STEPS}
# name: (preset, overrides, kernel)
RUNS = {"smc": ("cfg4_crowded", {**SCENE, "kmax": 125}, "B4"),
        "chees": ("cfg4_crowded", {**SCENE, "kmax": 112, "head": "chees", "n_chains": 1024},
                  "B5"),
        "smc_full": ("cfg4_crowded", {**SCENE, "kmax": 125, "smc.mutation": "rhmc",
                                      "smc.max_steps": 8}, "B6c"),
        "rhmc_full": ("cfg1_rhmc", RHMC, "B6c"),
        "rhmc_diag": ("cfg1_rhmc", {**RHMC, "rhmc.metric": "diag"}, "B4"),
        "w1": ("cfg4_crowded", W1, "B4"),
        "w2": ("cfg4_crowded", {**BEYOND, "kmax": 200, "head": "chees", "n_chains": 1024,
                                "n_warmup": W2_ITERS[0], "n_samples": W2_ITERS[1]}, "B5"),
        "w3": ("cfg4_crowded", {**W1, "smc.mutation": "rhmc", "smc.max_steps": W3_STEPS},
               "B6c"),
        "w4": ("cfg1_rhmc", {"scene.height": 128, "scene.width": 128, "n_stars": 300,
                             "kmax": 300, "n_warmup": W4_ITERS[0], "n_samples": W4_ITERS[1]},
               "B6c")}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(RUNS), nargs="+", help="run these only")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "wide_runs.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_runs: CUDA is not available", file=sys.stderr)
        return 1

    from starcat_torch import api
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch.configs import CONFIGS, apply_overrides

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    torch.zeros((), device=dev)  # the context, before the memory counters are reset
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name, (preset, over, kernel) in RUNS.items():
        if args.only is not None and name not in args.only:
            continue
        cfg = apply_overrides(CONFIGS[preset], over)
        mod = {"B4": frdc, "B5": flc, "B6c": frc}[kernel]
        mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        steps, last = [], [time.perf_counter(), 0, 0]

        def on_step(s):
            """A temperature step's schedule and its mutations' counts."""
            torch.cuda.synchronize()
            now = time.perf_counter()
            div, rej = int(s.divergences), int(s.solver_rejections)
            steps.append({"step": int(s.n_steps), "beta": float(s.beta),
                          "accept": float(s.mean_accept), "step_size": float(s.eps),
                          "divergences": div - last[1], "solver_rejections": rej - last[2],
                          "seconds": now - last[0]})
            last[:] = [now, div, rej]

        t0 = last[0] = time.perf_counter()
        out = api.sample(cfg, dev, seed=0, on_step=on_step if cfg.head == "smc" else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = out.stats
        summ = api.summarize_output(out)
        truth_f = st.pop("truth")["f"]
        rec = {"run": name, "card": card, "preset": preset, "overrides": over,
               "wall_s": wall, "kernel": kernel, "launches": mod.LAUNCHES,
               "stats": {k: v for k, v in st.items() if not isinstance(v, np.ndarray)},
               "summary": summ, "truth": {"n_stars": int(truth_f.shape[0]),
                                          "total_flux": float(np.sum(truth_f))},
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if steps:
            rec["steps"] = steps
            rec["seconds_per_step"] = sum(x["seconds"] for x in steps) / len(steps)
        else:
            rec["seconds_per_iteration"] = wall / (cfg.n_warmup + cfg.n_samples)
        if st["trajectory_kernel"] != kernel or mod.LAUNCHES != st["kernel_launches"]:
            raise AssertionError(f"{name} ran {st['trajectory_kernel']} "
                                 f"x{st['kernel_launches']}, {kernel} x{mod.LAUNCHES}")
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
