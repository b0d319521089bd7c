"""The two runs of the wide-field slice on the card, uncut: cfg4's SMC on a
192x192 field at cfg4's star density (112 stars, K_max 125, the preset's
4096 particles, twelve residual-birth sweeps and two 6 x 4 diagonal
mutations a step, on B4), and the crowded ChEES head on the same scene
(1024 chains, K = 112, the preset's 500 + 1000, on B5 through B2's
contract).  They are the CLI's

    python -m starcat_torch run --config cfg4_crowded scene.height=192 \\
        scene.width=192 n_stars=112 kmax=125 --device cuda
    python -m starcat_torch run --config cfg4_crowded scene.height=192 \\
        scene.width=192 n_stars=112 kmax=112 head=chees n_chains=1024 --device cuda

run through api.sample as the CLI runs them (seed 0), with the kernel's
launch count set to 0 just before each run and read just after.

    python scripts/wide_runs.py [--only smc|chees] [--out chiprun_out/wide_runs.jsonl]

Each run appends one JSON line to --out as soon as it ends and prints it:
the card's name and power limit, the wall, the kernel and its launches,
the head's stats, the total flux (mean, sd, ESS, split R-hat) and star
count against the drawn truth, and the peak device memory.  Needs a CUDA
card and nvcc.
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
RUNS = {"smc": ({**SCENE, "kmax": 125}, "B4"),
        "chees": ({**SCENE, "kmax": 112, "head": "chees", "n_chains": 1024}, "B5")}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(RUNS), help="run one of the two")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "wide_runs.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_runs: CUDA is not available", file=sys.stderr)
        return 1

    from starcat_torch import api
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch.configs import CONFIGS, apply_overrides

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    torch.zeros((), device=dev)  # the context, before the memory counters are reset
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name, (over, kernel) in RUNS.items():
        if args.only not in (None, name):
            continue
        cfg = apply_overrides(CONFIGS["cfg4_crowded"], over)
        mod = frdc if kernel == "B4" else flc
        mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = out.stats
        summ = api.summarize_output(out)
        truth_f = st.pop("truth")["f"]
        rec = {"run": name, "card": card, "overrides": over, "wall_s": wall,
               "kernel": kernel, "launches": mod.LAUNCHES,
               "stats": {k: v for k, v in st.items() if not isinstance(v, np.ndarray)},
               "summary": summ, "truth": {"n_stars": int(truth_f.shape[0]),
                                          "total_flux": float(np.sum(truth_f))},
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
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
