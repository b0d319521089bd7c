"""Per-step trace of an SMC preset run through starcat_torch on the GPU.

    python scripts/smc_trace.py --config cfg4_crowded [--seed 0]
                                [--out chiprun_out/trace.jsonl] [key=value ...]

Runs the preset through ``api.sample`` and writes one JSON line per
temperature step: step, beta, log Z, mean star count, mean acceptance,
step size, cumulative divergences and solver rejections, and the wall
seconds since the start; then a last line with the run's totals and the
peak device memory.  Comparable line by line with the JAX package's
``runs/*_metrics.jsonl`` records.  Needs a CUDA device unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cfg4_crowded")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/smc_trace.jsonl")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from starcat_torch import api
    from starcat_torch.__main__ import _parse_overrides
    from starcat_torch.configs import CONFIGS, apply_overrides

    cfg = apply_overrides(CONFIGS[args.config], _parse_overrides(args.overrides))
    if cfg.head != "smc":
        raise SystemExit(f"{cfg.name} is not an smc preset")
    dev = torch.device(args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with out.open("w") as fh:
        def on_step(s):
            row = torch.stack([s.n_steps.double(), s.beta.double(), s.log_z.double(),
                               s.mask.sum(-1).double().mean(), s.mean_accept.double(),
                               s.eps.double(), s.divergences.double(),
                               s.solver_rejections.double()]).tolist()
            keys = ("step", "beta", "log_z", "mean_n", "accept", "step_size",
                    "divergences", "solver_rejections")
            fh.write(json.dumps({**dict(zip(keys, row)),
                                 "wall_s": time.perf_counter() - t0}) + "\n")

        res = api.sample(cfg, dev, seed=args.seed, on_step=on_step)
        st, summ = res.stats, api.summarize_output(res)
        summary = {
            "config": cfg.name, "seed": args.seed, "kernel": st["kernel"],
            "trajectory_kernel": st["trajectory_kernel"], "device": st["device"],
            "kernel_launches": st["kernel_launches"],
            "wall_s": st["wall_seconds"], "n_steps": st["n_temp_steps"],
            "final_rounds": st["final_rounds"], "beta": st["beta"], "log_z": st["log_z"],
            "count_mean": summ["star_count"]["mean"], "count_mode": summ["star_count"]["mode"],
            "total_flux": summ["total_flux"]["mean"],
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None)}
        fh.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
