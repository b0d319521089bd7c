"""How far B5 and its plain version lie from float64 at a ChEES run's own
last state, and how far the plain version itself moves when theta moves
one float32 spacing: the readings behind chip_smoke's _arbitrate_b5.

    python scripts/b5_run_state_accuracy.py [--device cuda|cpu] [--tiny | --w2]

Runs the crowded ChEES head as chip_smoke's phase 19b runs it (WIDE_RUN2:
1024 chains, K = 112 on the 192x192 field, B5's wide path) and the same on
cfg4's 128x128 field at K = 50 (B5's one-tile path); --tiny instead runs a
32x32 field of 6 stars at 64 chains (for the CPU), and --w2 instead W2
of chip_smoke's phase 21b (1024 chains, K = 200 on the 256x256 field, its
momentum drawn from the same seed as the phase's hold).  At each run's last
state (its adapted step and inverse mass, momentum drawn as the run draws
it, the entry gradient in) it prints, at L = 0 the gradient's and U's
distance from float64 for the kernel and the plain version; at L = 10, 32
and the run's longest trajectory, for the kernel, the plain version, the
plain version 32 chains a call and the plain version from theta one
float32 spacing up: on how many chains each lies within chip_smoke's TOL
of float64 in every output, and, taking each float32 plain program in turn
as the judge of which chains are well-conditioned (those where it lies
within TOL), on how many of those chains each other program lies farther
from float64 than the judge plus TOL.  On a CPU tensor the wrapper runs
the plain version, so there the kernel's columns are the plain version's.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from starcat_torch import api  # noqa: E402
from starcat_torch import fused_leapfrog as fl  # noqa: E402
from starcat_torch import fused_leapfrog_crowded as flc  # noqa: E402
from starcat_torch.configs import CONFIGS, apply_overrides  # noqa: E402

# each output, and whether its distance is relative to 1 + |float64|
REL = {"theta": False, "p": True, "u": False, "grad": True}
JUDGES = ("plain", "plain chunked 32", "plain theta+1ulp")


def dists(x, z):
    """Each output's distance from float64's (z), the largest a chain."""
    r = {}
    for nm, a, b in zip(REL, x, z):
        d = (a.double() - b).abs()
        d = d / (1.0 + b.abs()) if REL[nm] else d
        r[nm] = d if d.ndim == 1 else d.reshape(d.shape[0], -1).amax(1)
    return r


def quantiles(x, qs, dev):
    q = torch.quantile(x.float(), torch.tensor(qs, device=dev))
    return [float(f"{float(v):.3e}") for v in q]


def diag(label, out, dev, seed=105):
    """The readings at one run's last state (module docstring)."""
    cfg, st = out.config, out.stats
    image = cfg.make_data()[1].to(dev)

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev).contiguous()

    theta, mask, inv_mass = on_dev(out.thetas[:, -1]), on_dev(out.masks), on_dev(out.inv_mass)
    c, k = theta.shape[:2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = torch.randn(theta.shape, generator=gen, device=dev) / torch.sqrt(inv_mass)
    p = (p * mask[..., None]).contiguous()
    step = st["step_size"]
    eps = torch.full((c,), step, device=dev)
    longest = min(max(math.ceil(st["traj_length"] / step), 1), cfg.chees.max_leapfrog)
    spec, prior = cfg.scene, cfg.prior
    fused = flc.make_fused_leapfrog_dyn(spec, image, prior, k)
    up = torch.nextafter(theta, torch.full_like(theta, math.inf)).contiguous()

    def plain(th, n, g, dtype, chunk=c):
        outs = [fl.fused_leapfrog_reference(
            spec, image.to(dtype), prior, th[i:i + chunk].to(dtype), p[i:i + chunk].to(dtype),
            eps[i:i + chunk].to(dtype), inv_mass.to(dtype), mask.to(dtype), n,
            None if g is None else g[i:i + chunk]) for i in range(0, c, chunk)]
        return [torch.cat(z) for z in zip(*outs)]

    print(f"== {label}: {c} chains, K={k}, {spec.height}x{spec.width}, step {step:.5f}, T "
          f"{st['traj_length']:.3f}, longest trajectory {longest}, inverse mass "
          f"{float(inv_mass.min()):.3e}..{float(inv_mass.max()):.3e}, |p| up to "
          f"{float(p.abs().max()):.1f}", flush=True)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    k0, p0 = fused(theta, p, eps, inv_mass, mask, zero, None), plain(theta, 0, None, torch.float32)
    f0 = plain(theta, 0, None, torch.float64)
    c0 = plain(theta, 0, None, torch.float32, 32)
    for nm, x in (("kernel", k0), ("plain", p0), ("plain chunked 32", c0)):
        d = dists(x, f0)
        print(f"L=0 {nm}: gradient relative max {float(d['grad'].max()):.3e} median "
              f"{float(d['grad'].median()):.3e}; U max {float(d['u'].max()):.3e} median "
              f"{float(d['u'].median()):.3e}", flush=True)
    dk0, dp0 = dists(k0, f0), dists(p0, f0)
    ratio = quantiles(dk0["grad"] / (dp0["grad"] + 1e-12), [0.5, 0.9, 0.99, 1.0], dev)
    print(f"L=0: chains whose kernel gradient lies more than 4x the plain version's (+1e-6) "
          f"from float64: {int((dk0['grad'] > 4 * dp0['grad'] + 1e-6).sum())}; the ratio's "
          f"quantiles 50/90/99/100%: {ratio}", flush=True)
    g0, g0_up = p0[3], plain(up, 0, None, torch.float32)[3]
    tol = dict(theta=cs.TOL["theta"], p=cs.TOL["p"], u=cs.TOL["u"] + cs._spacings(f0[2], 8),
               grad=cs.TOL["grad_rel"])
    for n in (10, 32, longest):
        n_dev = torch.full((1,), n, dtype=torch.int32, device=dev)
        progs = {"kernel": fused(theta, p, eps, inv_mass, mask, n_dev, g0),
                 "plain": plain(theta, n, g0, torch.float32),
                 "plain chunked 32": plain(theta, n, g0, torch.float32, 32),
                 "plain theta+1ulp": plain(up, n, g0_up, torch.float32)}
        f64 = plain(theta, n, None, torch.float64)
        fin = torch.isfinite(f64[2])
        for x in progs.values():
            fin &= torch.isfinite(x[2])
        dist = {nm: dists(x, f64) for nm, x in progs.items()}
        near = {nm: torch.stack([dist[nm][q] <= tol[q] for q in REL]).all(0) & fin
                for nm in progs}
        print(f"L={n}: finite in all {int(fin.sum())}; within TOL of float64 in every output: "
              f"{json.dumps({nm: int(w.sum()) for nm, w in near.items()})}", flush=True)
        for judge in JUDGES:
            well, res = near[judge], {}
            for nm in progs:
                if nm != judge:
                    bad = torch.zeros_like(well)
                    for q in REL:
                        bad |= well & (dist[nm][q] > dist[judge][q] + tol[q])
                    res[nm] = int(bad.sum())
            print(f"  well-conditioned by {judge} ({int(well.sum())}): chains where another "
                  f"lies beyond it + TOL: {json.dumps(res)}", flush=True)
        for q in ("theta", "p"):
            qs = {nm: quantiles(dist[nm][q][fin], [0.5, 0.9], dev) for nm in progs}
            print(f"  {q} from float64 over the finite chains, 50%/90%: {json.dumps(qs)}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a 32x32 field of 6 stars, 64 chains")
    ap.add_argument("--w2", action="store_true", help="chip_smoke's W2: 256x256, K = 200")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("b5_run_state_accuracy: CUDA is not available", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    chees = {k: v for k, v in cs.WIDE_RUN2.items()
             if not k.startswith("scene") and k not in ("n_stars", "kmax")}
    runs = (("wide run 2", cs.WIDE_RUN2), ("one-tile cfg4 128x128 K=50", {**chees, "kmax": 50}))
    seed = 105
    if args.w2:
        runs, seed = (("W2 256x256 K=200", cs.W2),), cs.W2_HOLD_SEED
    if args.tiny:
        runs = (("tiny 32x32 K=6", {**chees, "scene.height": 32, "scene.width": 32,
                                     "n_stars": 6, "kmax": 6, "n_chains": 64, "n_warmup": 40,
                                     "n_samples": 20, "chees.max_leapfrog": 16}),)
    for label, over in runs:
        cfg = apply_overrides(CONFIGS["cfg4_crowded"], over)
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        print(f"{label}: run {time.perf_counter() - t0:.2f} s, {out.stats['trajectory_kernel']}, "
              f"accept {out.stats['accept']:.4f}", flush=True)
        diag(label, out, dev, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
