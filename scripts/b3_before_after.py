"""Time two builds of the diagonal-Fisher Riemannian kernel (B3) in turns on
one card: an earlier source given by path, and the checkout's (or a second
one given by path).

    python scripts/b3_before_after.py --old PATH/fused_rhmc_diag.cu [--new PATH]

Both take B3's C interface (csrc/fused_rhmc_diag.cu, entry
starcat_fused_rhmc_diag).  At chip_smoke.py's two timed B3 shapes (cfg5: 256
chains, K = 16, 32x32, 6 steps x 4 sweeps, per-chain masks with 6..16 live
stars; cfg1 diag: 128 chains, K = 10, 16 x 6, shared mask; beta 1) it prints
the card's name and power limit, each build's ptxas report, the launch
layout of a build that reports one (threads per block, blocks per SM and
the SMs the grid fills, from starcat_fused_rhmc_diag_layout), how far the
two kernels' outputs are apart on the chains whose fixed points converged
tightly in both and whether the new one gives the same bits on a rerun,
then the time of one trajectory with CUDA events in the order old, new,
new, old, with the mean of each kernel, the ratio and the share of
chip_smoke's bound.  The last line is one JSON object with the times.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

LAYOUT = "starcat_fused_rhmc_diag_layout"
ENTRY = "starcat_fused_rhmc_diag"
# (name, chains, K, n_steps, fixed_point_iters, per-chain mask): chip_smoke's
SHAPES = (("cfg5", 256, 16, 6, 4, True), ("cfg1 diag", 128, 10, 16, 6, False))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier B3 source")
    ap.add_argument("--new", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_rhmc_diag.cu",
                    help="the later B3 source (default: the checkout's)")
    ap.add_argument("--reps", type=int, default=20, help="trajectories per timed turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b3_before_after: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b4_before_after import build_source, launch
    from starcat_torch import build
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    libs = {}
    for tag, path in (("old", args.old), ("new", args.new)):
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        libs[tag], report = build_source(path, f"b3_{tag}_{digest}", entry=ENTRY)
        print(f"{tag}: {path}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {tag}: {line.strip()}")

    dev = torch.device("cuda:0")
    cfg = CONFIGS["cfg5_transdim_mcmc"]
    truth, image = cfg.make_data()
    img = image.to(dev)
    h, w = cfg.scene.height, cfg.scene.width
    scalars = build.riemannian_scalars(cfg.scene, cfg.prior, 1e-3)
    result = {"card": smi.splitlines()[0], "old": str(args.old), "new": str(args.new),
              "shapes": {}}
    for name, c, k, n_steps, fpi, per_chain in SHAPES:
        theta, xi, eps, mask = chip_smoke._rhmc_inputs(truth, c, k, dev, 0, per_chain)
        run = {tag: (lambda lib=lib: launch(lib, img, k, n_steps, fpi, scalars, theta, xi,
                                            eps, mask, 1.0, entry=ENTRY))
               for tag, lib in libs.items()}
        # an earlier source without the layout entry reports none
        lay = {tag: build.query_layout(lib, LAYOUT, c, k, h, w) if hasattr(lib, LAYOUT)
               else None for tag, lib in libs.items()}
        a, b = run["old"](), run["new"]()
        tight = (a[5] < chip_smoke.TIGHT) & (b[5] < chip_smoke.TIGHT)
        apart = {nm: float(chip_smoke._per_chain((x - y).abs())[tight].max())
                 for nm, x, y in zip(("theta", "p", "h0", "h1", "u1"), a, b)}
        again = run["new"]()
        repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                     for x, y in zip(b, again))
        print(f"{name} ({c} chains, K={k}, {n_steps} x {fpi}): layout {json.dumps(lay)}; "
              f"old vs new on the {int(tight.sum())} of {c} chains converged tightly in both: "
              f"{json.dumps(apart)}; new run twice bitwise equal: {repeat}")
        times = []
        for tag in ("old", "new", "new", "old"):
            ms = chip_smoke._time_ms(run[tag], args.reps, warmup=2)
            times.append((tag, ms))
            print(f"  {tag}: {ms:.4f} ms per trajectory")
        mean = {tag: sum(t for g, t in times if g == tag) / 2 for tag in ("old", "new")}
        bound = chip_smoke.bound_ms(chip_smoke.rhmc_diag_ops(c, k, h, w, n_steps, fpi),
                                    chip_smoke.rhmc_bytes(c, k, h, w, per_chain))[0]
        print(f"  mean old {mean['old']:.4f} ms, new {mean['new']:.4f} ms, old / new "
              f"{mean['old'] / mean['new']:.3f}; bound {bound:.4f} ms (new "
              f"{100 * bound / mean['new']:.1f}%, old {100 * bound / mean['old']:.1f}%)")
        result["shapes"][name] = {"turns": times, "mean_ms": mean, "bound_ms": bound,
                                  "layout": lay, "apart": apart, "tight": int(tight.sum()),
                                  "bitwise_repeat": repeat}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
