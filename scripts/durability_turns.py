"""What checkpoints and the metrics stream cost the flagship ChEES run, and
that blocked sampling left its draws as they were, on one GPU.

    python scripts/durability_turns.py --parent <an unpacked earlier checkout under build/>
        [--seeds 0 1] [--reps 2] [--validate]

1. ``python -m starcat_torch run --config cfg6_chees --seed 0 --device cuda``
   in the parent's tree, then in this one: the two total-flux summaries
   must be equal (the preset's 1000 draws now sample in blocks of 250).
2. The full cfg6 preset through ``api.sample`` in this process, with and
   without a checkpoint and a metrics stream, in turns (without, with,
   with, without for each seed): each run's wall, the total flux and its
   split R-hat, and with checkpoints the time of every save
   (``chip_smoke.timed_saves``) and the checkpoint's size; the
   draws of the two must be the same bits.
3. With ``--validate``: ``validate --device cuda`` in the parent's tree and
   in this one; the per-head results must be equal.

Prints one JSON line a run and writes them to chiprun_out/durability_turns.jsonl.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "chiprun_out" / "durability_turns.jsonl"


def emit(rec: dict) -> None:
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    with OUT.open("a") as fh:
        fh.write(line + "\n")


def cli(tree: Path, *args: str) -> tuple[int, str, float]:
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "starcat_torch", *args], cwd=tree,
                       capture_output=True, text=True)
    if r.returncode not in (0, 1):
        raise RuntimeError(f"{tree}: {args} returned {r.returncode}:\n{r.stderr[-3000:]}")
    return r.returncode, r.stdout.strip().splitlines()[-1], time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--validate", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from chip_smoke import timed_saves
    from starcat_torch import api, chees, driver, smc, transdim_mcmc
    from starcat_torch.configs import CONFIGS

    if not torch.cuda.is_available():
        print("durability_turns: CUDA is not available", file=sys.stderr)
        return 1
    OUT.parent.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__})
    parent = Path(args.parent).resolve()
    ok = True

    summaries = {}
    for name, tree in (("parent", parent), ("change", REPO)):
        rc, line, wall = cli(tree, "run", "--config", "cfg6_chees", "--seed", "0",
                             "--device", "cuda")
        rec = json.loads(line)
        summaries[name] = rec["summary"]["total_flux"]
        emit({"leg": "cli cfg6 seed 0", "tree": name, "process_wall": wall,
              "wall_seconds": rec["stats"]["wall_seconds"], "total_flux": rec["summary"]["total_flux"]})
    same = summaries["parent"] == summaries["change"]
    ok &= same
    emit({"leg": "cli cfg6 seed 0", "same_summary": same})

    cfg = CONFIGS["cfg6_chees"]
    dev = torch.device("cuda")
    walls: dict[str, list[float]] = {"without": [], "with": []}
    all_saves: list[float] = []
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        for seed in args.seeds:
            draws = {}
            for rep in range(args.reps):
                order = ("without", "with") if rep % 2 == 0 else ("with", "without")
                for kind in order:
                    kw = {}
                    if kind == "with":
                        ck, mp = Path(tmp) / f"s{seed}r{rep}.ck", Path(tmp) / f"s{seed}r{rep}.jsonl"
                        kw = dict(checkpoint_path=str(ck), metrics_path=str(mp))
                        times, undo = timed_saves((driver, chees, transdim_mcmc, smc))
                    out = api.sample(cfg, dev, seed=seed, **kw)
                    if kind == "with":
                        undo()
                        all_saves += times
                    tf = api.summarize_output(out)["total_flux"]
                    walls[kind].append(out.stats["wall_seconds"])
                    rec = {"leg": "cfg6 full", "seed": seed, "rep": rep, "kind": kind,
                           "wall_seconds": out.stats["wall_seconds"],
                           "kernel_launches": out.stats["kernel_launches"],
                           "total_flux_mean": tf["mean"], "total_flux_sd": tf["sd"],
                           "rhat": tf["rhat"], "traj_length": out.stats["traj_length"]}
                    if kind == "with":
                        rec.update(saves=len(times), save_ms=times,
                                   checkpoint_bytes=ck.stat().st_size,
                                   records=len(mp.read_text().splitlines()))
                    emit(rec)
                    prev = draws.setdefault(kind, out.thetas)
                    if not np.array_equal(prev, out.thetas):
                        ok = False
                        emit({"leg": "cfg6 full", "seed": seed, "error": f"{kind} changed between reps"})
            same = np.array_equal(draws["with"], draws["without"])
            ok &= same
            emit({"leg": "cfg6 full", "seed": seed, "same_draws_with_and_without": same})
    emit({"leg": "cfg6 full", "median_wall_without": statistics.median(walls["without"]),
          "median_wall_with": statistics.median(walls["with"]),
          "median_save_ms": statistics.median(all_saves), "max_save_ms": max(all_saves),
          "n_saves": len(all_saves)})

    if args.validate:
        results = {}
        for name, tree in (("parent", parent), ("change", REPO)):
            rc, line, wall = cli(tree, "validate", "--device", "cuda")
            results[name] = json.loads(line)
            emit({"leg": "validate", "tree": name, "rc": rc, "process_wall": wall,
                  "result": results[name]})
        same = results["parent"] == results["change"]
        ok &= same
        emit({"leg": "validate", "same_results": same})
    emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
