"""Time two builds of the small-scene leapfrog kernel (B1/B2) in turns on one
card, beside the crowded-field kernel B5 on the same inputs: an earlier B1
source given by path, and the checkout's (or a second one given by path).

    python scripts/b1_before_after.py --old PATH/fused_leapfrog.cu [--new PATH]
                                      [--median-steps N] [--reps 20]

Both take B1's C interface (csrc/fused_leapfrog.cu, entry
starcat_fused_leapfrog).  At the flagship shape (1024 chains, K = 10, 32x32,
shared mask, entry gradient in) with L = 20 and with L = --median-steps
(cfg6_chees's median adapted step count), and at the other preset shapes
in B1's domain -- cfg0 (4 chains, K = 1, 16x16, L = 15), the trans-d hmc
move (256 chains, K = 16, 32x32, per-chain masks, L = 6) and 48x48 at K =
16 (1024 chains, L = 20) -- it prints the card's name and power limit,
each build's ptxas report, how far the two builds' outputs are apart and
from B5's, whether the new one gives the same bits on a rerun, then the
kernel time of one trajectory in the order old, new, B5, B5, new, old
(from torch.profiler: at the small shapes the host's time per launch
exceeds the kernel's, so CUDA events would time the host), with each
kernel's mean, the ratios and the share of chip_smoke's bound.  The last
line is one JSON object with the times.
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

ENTRY = "starcat_fused_leapfrog"


def shapes(dev, median_steps: int):
    """(name, scene, image, prior, K, L, theta, p, eps, inv_mass, mask, entry
    gradient) at the flagship shape (L = 20 and, if given, cfg6's median
    adapted count) and the other preset shapes in B1's domain, from
    chip_smoke's inputs."""
    import chip_smoke
    import torch

    from starcat_torch import fused_leapfrog as fl
    from starcat_torch.configs import CONFIGS

    out = []

    def add(name, cfg, spec, img, theta, p, eps, mask, n):
        k = theta.shape[1]
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        p = p * (mask if mask.ndim == 2 else mask.expand(theta.shape[0], k))[..., None]
        g0 = fl.fused_leapfrog_reference(spec, img, cfg.prior, theta, p, eps, inv_mass, mask,
                                         0, None)[3]
        out.append((name, spec, img, cfg.prior, k, n, theta, p, eps, inv_mass, mask, g0))

    cfg6 = CONFIGS["cfg6_chees"]
    truth, image = cfg6.make_data()
    theta, p, eps = chip_smoke._crowded_inputs(truth, 1024, cfg6.kmax, dev, 31)
    ones = torch.ones(cfg6.kmax, device=dev)
    add("flagship L=20", cfg6, cfg6.scene, image.to(dev), theta, p, 0.002 * eps, ones, 20)
    if median_steps > 0:
        add(f"flagship L={median_steps}", cfg6, cfg6.scene, image.to(dev), theta, p,
            0.002 * eps, ones, median_steps)
    cfg0 = CONFIGS["cfg0_single_star"]
    t0, i0 = cfg0.make_data()
    theta, p, eps = chip_smoke._crowded_inputs(t0, 4, 1, dev, 91)
    add("cfg0", cfg0, cfg0.scene, i0.to(dev), theta, p, 0.002 * eps, torch.ones(1, device=dev),
        15)
    cfg5 = CONFIGS["cfg5_transdim_mcmc"]
    t5, i5 = cfg5.make_data()
    theta, xi, _, mask = chip_smoke._rhmc_inputs(t5, 256, 16, dev, 92, True)
    add("trans-d hmc", cfg5, cfg5.scene, i5.to(dev), theta, xi,
        torch.full((256,), 0.002, device=dev), mask, 6)
    spec, img, theta, xi, _, _ = chip_smoke._cut_inputs(48, 48, 16, 1024, dev, 90)
    add("48x48 K=16", cfg6, spec, img, theta, xi, torch.full((1024,), 0.002, device=dev),
        torch.ones(16, device=dev), 20)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier B1 source")
    ap.add_argument("--new", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_leapfrog.cu",
                    help="the later B1 source (default: the checkout's)")
    ap.add_argument("--median-steps", type=int, default=1024,
                    help="cfg6_chees's median adapted step count (0: skip that shape); "
                         "scripts/b1_cfg6_turns.py measured 1024, the cap, on an H100")
    ap.add_argument("--reps", type=int, default=20, help="trajectories per timed turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_before_after: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b5_before_after import build_leapfrog, launch
    from starcat_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    libs = {}
    for tag, path in (("old", args.old), ("new", args.new)):
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        libs[tag], report = build_leapfrog(path, f"b1_{tag}_{digest}", ENTRY)
        print(f"{tag}: {path}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {tag}: {line.strip()}")
    b5 = build.leapfrog_library("fused_leapfrog_crowded")

    dev = torch.device("cuda:0")
    result = {"card": smi.splitlines()[0], "old": str(args.old), "new": str(args.new),
              "shapes": {}}
    for name, spec, img, prior, k, L, theta, p, eps, inv_mass, mask, g0 in shapes(
            dev, args.median_steps):
        scalars = build.leapfrog_scalars(spec, prior)
        run = {tag: (lambda lib=lib: launch(lib, img, k, scalars, theta, p, eps, inv_mass,
                                            mask, L, g0, entry=ENTRY))
               for tag, lib in libs.items()}
        run["b5"] = lambda: launch(b5, img, k, scalars, theta, p, eps, inv_mass, mask, L, g0,
                                   entry="starcat_fused_leapfrog_crowded")
        a, b, c5 = run["old"](), run["new"](), run["b5"]()
        names = ("theta", "p", "u", "grad")
        apart = {nm: float((x - y).abs().max()) for nm, x, y in zip(names, a, b)}
        apart_b5 = {nm: float((x - y).abs().max()) for nm, x, y in zip(names, c5, b)}
        again = run["new"]()
        repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                     for x, y in zip(b, again))
        c = theta.shape[0]
        print(f"{name} ({c} chains, K={k}, {spec.height}x{spec.width}, L={L}): old vs new "
              f"{json.dumps(apart)}; B5 vs new {json.dumps(apart_b5)}; new run twice "
              f"bitwise equal: {repeat}")
        times = []
        for tag in ("old", "new", "b5", "b5", "new", "old"):
            ms = chip_smoke._kernel_ms(run[tag], args.reps, "leapfrog")
            times.append((tag, ms))
            print(f"  {tag}: {ms:.4f} ms of kernel time per trajectory")
        mean = {tag: sum(t for g, t in times if g == tag) / 2 for tag in ("old", "new", "b5")}
        bound = chip_smoke.bound_ms(
            chip_smoke.leapfrog_ops(c, k, spec.height, spec.width, L, True),
            chip_smoke.leapfrog_bytes(c, k, spec.height, spec.width, True))[0]
        print(f"  mean old {mean['old']:.4f} ms, new {mean['new']:.4f} ms, B5 "
              f"{mean['b5']:.4f} ms; old / new {mean['old'] / mean['new']:.3f}, B5 / new "
              f"{mean['b5'] / mean['new']:.3f}; bound {bound:.4f} ms (new "
              f"{100 * bound / mean['new']:.1f}%, old {100 * bound / mean['old']:.1f}%)")
        result["shapes"][name] = {"turns": times, "mean_ms": mean, "bound_ms": bound,
                                  "apart": apart, "apart_b5": apart_b5,
                                  "bitwise_repeat": repeat}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
