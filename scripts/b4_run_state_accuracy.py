"""How far B4 and its float32 plain version lie from the float64 plain
version at an SMC run's own last state, step by step: the readings behind
ROADMAP C6 and chip_smoke's hold of B4 at W1's state.

    python scripts/b4_run_state_accuracy.py [--device cuda|cpu] [--tiny]

Runs W1 as chip_smoke's phase 21b runs it (cfg4's SMC on a drawn 256x256
field of 200 stars at K_max 256, 4096 particles, 2 temperature steps, B4's
wide path); --tiny instead runs a 24x24 field of 4 stars at 32 particles
(for the CPU, where the wrapper runs the plain version, so the kernel's
columns are the plain version's).  From the run's last state (its step
jittered per particle and its temperature, standard-normal xi, the first
128 particles: chip_smoke._run_state) it runs the kernel, the float32
plain version and the float64 one for 1, 2, 3 and 6 steps of 4 sweeps and
prints, on the particles whose fixed points all three bring below 1e-3,
the median and largest theta distance from float64 of the kernel and of
the float32 plain version, and the particles where the kernel lies
farthest beyond the plain version; then, at 0 steps, the momentum's
(p = sqrt(g) xi) and h0's distance from float64.  One JSON line last.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from starcat_torch import api  # noqa: E402
from starcat_torch import fused_rhmc_diag as frd  # noqa: E402
from starcat_torch import fused_rhmc_diag_crowded as frdc  # noqa: E402
from starcat_torch.configs import CONFIGS, apply_overrides  # noqa: E402

TINY = {"scene.height": 24, "scene.width": 24, "n_stars": 4, "kmax": 8,
        "smc.n_particles": 32, "smc.n_transdim_sweeps": 2, "smc.max_steps": 2}
TIGHT = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a small field, for the CPU")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("b4_run_state_accuracy: CUDA is not available", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0])
    cfg = apply_overrides(CONFIGS["cfg4_crowded"], TINY if args.tiny else cs.W1)
    out = api.sample(cfg, dev, seed=0)
    st = out.stats
    image = cfg.make_data()[1].to(dev)
    theta, xi, eps, mask = cs._run_state(out, dev, 160, 128)
    beta, spec, prior, k = st["beta"], cfg.scene, cfg.prior, cfg.kmax
    print(f"{spec.height}x{spec.width} K_max {k}, {theta.shape[0]} of "
          f"{out.thetas.shape[0]} particles at beta {beta:.6f}, step {st['step_size']:.5f}")

    def plain(n, dtype):
        return cs._plain_chunked(frd.fused_rhmc_diag_reference, spec, image.to(dtype), prior,
                                 theta.to(dtype), xi.to(dtype), eps.to(dtype), mask.to(dtype),
                                 beta, n, 4)

    def dist(a, z):
        return cs._per_chain((a.double() - z.double()).abs())

    result = {"beta": beta, "step": st["step_size"], "particles": int(theta.shape[0]),
              "steps": {}}
    for n in (1, 2, 3, 6):
        kern = frdc.make_fused_rhmc_diag(spec, image, prior, k, n, 4)(
            theta, xi, eps, mask, torch.tensor(beta, device=dev))
        p32, p64 = plain(n, torch.float32), plain(n, torch.float64)
        tight = (kern[5] < TIGHT) & (p32[5] < TIGHT) & (p64[5] < TIGHT)
        dk, dp = dist(kern[0], p64[0])[tight], dist(p32[0], p64[0])[tight]
        idx = tight.nonzero()[:, 0]
        worst = torch.argsort(dk - dp, descending=True)[:4]
        rec = {"tight": int(tight.sum()),
               "kernel": {"median": float(dk.median()), "max": float(dk.max())},
               "plain": {"median": float(dp.median()), "max": float(dp.max())},
               "worst": [{"particle": int(idx[i]), "kernel": float(dk[i]),
                          "plain": float(dp[i]), "live": int(mask[idx[i]].sum())}
                         for i in worst.tolist()]}
        result["steps"][n] = rec
        print(f"{n} x 4: on {rec['tight']} tight particles theta from float64, kernel median "
              f"{rec['kernel']['median']:.3e} max {rec['kernel']['max']:.3e}, plain median "
              f"{rec['plain']['median']:.3e} max {rec['plain']['max']:.3e}; farthest beyond "
              f"the plain version {json.dumps(rec['worst'])}", flush=True)
    kern = frdc.make_fused_rhmc_diag(spec, image, prior, k, 0, 4)(
        theta, xi, eps, mask, torch.tensor(beta, device=dev))
    p32, p64 = plain(0, torch.float32), plain(0, torch.float64)

    def rel(a, z):
        return float(((a.double() - z).abs() / (1.0 + z.abs())).max())

    result["at_theta0"] = {"p_rel": {"kernel": rel(kern[1], p64[1]), "plain": rel(p32[1], p64[1])},
                           "h0": {"kernel": float((kern[2].double() - p64[2]).abs().max()),
                                  "plain": float((p32[2].double() - p64[2]).abs().max())}}
    print(f"0 steps: {json.dumps(result['at_theta0'])}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
