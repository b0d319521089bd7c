"""Time one trajectory of B6c's wide path at large catalogs on one card and
fit its growth in D = 3 K.

    python scripts/b6c_large_k.py [--k 700 1400 2800] [--out PATH]

At each K: a drawn 128x128 field of K stars (chip_smoke._wide_scene), one
chain near its truth with every slot live (chip_smoke.b4_inputs at a
twelfth of its step), one trajectory of n_steps 1 and fixed_point_iters 1
through fused_rhmc_crowded.make_fused_rhmc, timed with CUDA events after a
launch at K = 65 has loaded the build.  Prints the card's name and power
limit, a line per K (ms, whether the outputs are finite, ms per D^3), the
least-squares fit of log ms against log D (its exponent) and the pure D^3
fit through the largest K, each extrapolated to K = 10923 and to the
largest K whose one-block slice the card's free memory holds
(fused_rhmc_crowded.largest_kmax).  A JSON line a K and one for the fit go
to --out (default chiprun_out/b6c_large_k.jsonl); the last line printed is
the fit's.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[700, 1400, 2800])
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "b6c_large_k.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6c_large_k: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda:0")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def trajectory(k):
        cfg, truth, image = chip_smoke._wide_scene(CONFIGS, 128, 128, k)
        theta, xi, eps, mask = chip_smoke.b4_inputs(truth, 1, k, dev, 170, False)
        fused = frc.make_fused_rhmc(cfg.scene, image.to(dev), cfg.prior, k, 1, 1)
        return lambda: fused(theta, xi, eps / 12.0, mask, 1.0)

    trajectory(65)()  # loads the build
    torch.cuda.synchronize()
    rows = []
    for k in args.k:
        run = trajectory(k)
        frc.reset_launch_counts()
        out = []
        ms = chip_smoke._time_ms(lambda: out.append(run()), 1, warmup=0)
        if frc.LAUNCHES != 1:
            raise AssertionError(f"K={k}: {frc.LAUNCHES} B6c launches, not 1")
        finite = {nm: bool(torch.isfinite(x).all())
                  for nm, x in zip(("theta", "p", "h0", "h1", "u1", "resid"), out[-1])}
        d = 3 * k
        row = {"card": smi, "k": k, "d": d, "ms": ms, "ms_per_d3": ms / d**3, "finite": finite,
               "slice_gib": frc.workspace_bytes(k, 128, 128, 1) / 2**30,
               "mode": {"full_panel": frc.full_panel(k),
                        "vectors_in_shared": frc.vectors_in_shared(k)}}
        rows.append(row)
        lines.append(row)
        print(f"K={k} (D = {d}, 128x128, 1 chain, 1 x 1): {ms:.1f} ms, {ms / d**3:.4g} ms per "
              f"D^3, finite {finite}")
        del run, out
        torch.cuda.empty_cache()
    # log ms = a + b log D by least squares, and ms = c D^3 through the largest
    xs = [math.log(r["d"]) for r in rows]
    ys = [math.log(r["ms"]) for r in rows]
    n = len(rows)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum((x - mx) ** 2 for x in xs)
         if n > 1 else 3.0)
    a = my - b * mx
    c3 = rows[-1]["ms_per_d3"]
    free = torch.cuda.mem_get_info(dev)[0]
    k_max = frc.largest_kmax(128, 128, free)
    fit = {"card": smi, "exponent": b, "free_bytes": free, "k_max": k_max, "extrapolated_s": {}}
    for k in (10923, k_max):
        d = 3 * k
        fit["extrapolated_s"][str(k)] = {"power_fit": math.exp(a + b * math.log(d)) / 1e3,
                                         "d3_fit": c3 * d**3 / 1e3}
    lines.append(fit)
    with args.out.open("a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print(f"fit: ms ~ D^{b:.3f}; extrapolated (s): " + ", ".join(
        f"K={k}: {v['power_fit']:.0f} (power fit), {v['d3_fit']:.0f} (D^3 through K="
        f"{rows[-1]['k']})" for k, v in fit["extrapolated_s"].items())
        + f"; the largest K whose slice {free / 2**30:.2f} GiB free holds: {k_max}")
    print(json.dumps(fit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
