"""Smoke test of the PyTorch/CUDA port (starcat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the fused
   leapfrog kernel from csrc/ with nvcc;
2. holds the kernel against its plain torch version on the card at the
   flagship shape (1024 chains, K = 10, 32x32): both call contracts,
   n_steps in {0, 1, 5} with and without an entry gradient, per-chain eps,
   a per-chain mask with a dead slot, and the gradient against float64;
   then times one L = 20 trajectory of each;
3. drives the main path at full width through the public API: the
   cfg6_chees preset (ChEES, B2's contract) and the same scene under the
   HMC head (B1's contract), and checks that both ran through the kernel,
   that the draws are finite and that the posterior total flux agrees with
   the reference's record for this image.

Every failure raises.  Exits nonzero, printing no result, without CUDA or
outside a checkout.  The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# posterior total flux of cfg6_chees on this image, from the JAX package's
# full-length record (runs/cfg6_full_r5.json): mean 2184.8, sd 75.8
REF_TOTAL_FLUX = (2184.8, 75.8)
TOL = {"theta": 3e-4, "p": 5e-3, "u": 0.3, "grad_rel": 5e-3, "grad_f64": 0.017}


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _compare(case: str, out, ref) -> float:
    """Kernel output against the plain version; returns the theta error."""
    th, p, u, g = out
    th_r, p_r, u_r, g_r = ref
    errs = {
        "theta": _max_err(th, th_r),
        "p": _max_err(p, p_r),
        "u": _max_err(u, u_r),
        "grad_rel": float(((g - g_r).abs() / (1.0 + g_r.abs())).max()),
    }
    for name, err in errs.items():
        if not err <= TOL[name]:
            raise AssertionError(f"{case}: {name} error {err} > {TOL[name]}")
    return errs["theta"]


def _time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernel(fl, cfg, dev):
    """Phase 2: kernel against plain on the card; returns the JSON rows."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior, k = cfg.scene, cfg.prior, cfg.kmax
    c = 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    theta = truth.to(dev)[None] + 0.02 * torch.randn((c, k, 3), generator=gen, device=dev)
    p = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.002 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    inv_mass = torch.full((k, 3), 0.9, device=dev)
    mask = torch.ones(k, device=dev)
    ref = lambda th, pp, e, m, n, g: fl.fused_leapfrog_reference(  # noqa: E731
        spec, img, prior, th, pp, e, inv_mass, m, n, g)
    _, _, _, g0 = ref(theta, p, eps, mask, 0, None)
    dyn = fl.make_fused_leapfrog_dyn(spec, img, prior, k)
    err = {"static": 0.0, "dyn": 0.0}
    for n in (0, 1, 5):
        static = fl.make_fused_leapfrog(spec, img, prior, k, n)
        for grad in (None, g0):
            tag = f"n={n} grad={'in' if grad is not None else 'none'}"
            want = ref(theta, p, eps, mask, n, grad)
            err["static"] = max(err["static"], _compare(
                f"static {tag}", static(theta, p, eps, inv_mass, mask, grad=grad), want))
            err["dyn"] = max(err["dyn"], _compare(
                f"dyn {tag}", dyn(theta, p, eps, inv_mass, mask,
                                  torch.full((1,), n, dtype=torch.int32, device=dev), grad),
                want))

    # per-chain mask: slot 3 dead on every odd chain, its momentum zeroed
    mask_c = torch.ones((c, k), device=dev)
    mask_c[1::2, 3] = 0.0
    p_m = p * mask_c[..., None]
    static5 = fl.make_fused_leapfrog(spec, img, prior, k, 5)
    out = static5(theta, p_m, eps, inv_mass, mask_c)
    err["static"] = max(err["static"], _compare(
        "per-chain mask", out, ref(theta, p_m, eps, mask_c, 5, None)))
    if not torch.equal(out[0][1::2, 3], theta[1::2, 3]):
        raise AssertionError("a dead slot moved")
    if not bool((out[3][1::2, 3] == 0).all()):
        raise AssertionError("a dead slot has a nonzero gradient")

    # the gradient against float64
    _, _, _, g64 = fl.fused_leapfrog_reference(
        spec, img.double(), prior, theta.double(), p.double(), eps.double(),
        inv_mass.double(), mask.double(), 0, None)
    _, _, _, gk = fl.make_fused_leapfrog(spec, img, prior, k, 0)(theta, p, eps, inv_mass, mask)
    grad_f64 = float((gk.double() - g64).abs().max())
    if not grad_f64 <= TOL["grad_f64"]:
        raise AssertionError(f"kernel grad vs float64: {grad_f64} > {TOL['grad_f64']}")
    torch.cuda.synchronize()
    print(f"kernel vs plain (C={c}, K={k}, {spec.height}x{spec.width}): "
          f"max theta err static {err['static']:.3g}, dyn {err['dyn']:.3g}; "
          f"grad vs float64 {grad_f64:.3g}; tolerances {json.dumps(TOL)}")

    # time one L = 20 trajectory, entry gradient supplied
    L = 20
    static20 = fl.make_fused_leapfrog(spec, img, prior, k, L)
    n20 = torch.full((1,), L, dtype=torch.int32, device=dev)
    ms = {
        "static": _time_ms(lambda: static20(theta, p, eps, inv_mass, mask, grad=g0), 50),
        "dyn": _time_ms(lambda: dyn(theta, p, eps, inv_mass, mask, n20, g0), 50),
        "plain": _time_ms(lambda: ref(theta, p, eps, mask, L, g0), 10),
    }
    for name, t in ms.items():
        print(f"L={L} trajectory, {name}: {t:.4f} ms, "
              f"{c * L / (t * 1e-3):.4g} grad-evals/s")
    return err, ms


def run_slice(api, cfg, dev):
    """Phase 3: the main path at full width through the public API."""
    import dataclasses

    import numpy as np

    runs = {
        "chees": dataclasses.replace(cfg, n_warmup=100, n_samples=50),
        "hmc": dataclasses.replace(cfg, head="hmc", n_warmup=100, n_samples=50),
    }
    for head, rcfg in runs.items():
        out = api.sample(rcfg, dev, seed=1)
        summ = api.summarize_output(out)
        st = out.stats
        tf = summ["total_flux"]
        print(f"slice {head}: {rcfg.n_chains} chains, {rcfg.n_warmup} warmup + "
              f"{rcfg.n_samples} draws in {st['wall_seconds']:.3f} s, kernel "
              f"{st['kernel']} x{st['kernel_launches']}, accept {st['accept']:.3f}, "
              f"step {st['step_size']:.4g}"
              + (f", T {st['traj_length']:.4g}" if "traj_length" in st else "")
              + f"; total flux {tf['mean']:.2f} ± {tf['sd']:.2f} "
              f"(ESS {tf['ess']:.0f}, R-hat {tf['rhat']:.4f})")
        if st["kernel"] != "cuda_fused" or st["kernel_launches"] <= 0:
            raise AssertionError(f"{head} did not run through the CUDA kernel: {st}")
        want = (rcfg.n_chains, rcfg.n_samples, rcfg.kmax, 3)
        if out.thetas.shape != want or not np.isfinite(out.thetas).all():
            raise AssertionError(f"{head}: draws of shape {out.thetas.shape}, "
                                 f"finite {np.isfinite(out.thetas).all()}")
        if not 0.5 <= st["accept"] <= 0.95:
            raise AssertionError(f"{head}: mean accept {st['accept']}")
        mean, sd = REF_TOTAL_FLUX
        if not abs(tf["mean"] - mean) <= sd:
            raise AssertionError(f"{head}: total flux {tf['mean']} vs the "
                                 f"reference posterior {mean} ± {sd}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from starcat_torch import api, fused_leapfrog as fl
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    lib, report, seconds = fl.build_kernel()
    print(f"kernel build: {seconds:.2f} s -> {lib.name}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda:0")
    cfg = CONFIGS["cfg6_chees"]
    err, ms = check_kernel(fl, cfg, dev)

    fl.reset_launch_counts()
    t0 = time.perf_counter()
    run_slice(api, cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"static": fl.STATIC_LAUNCHES, "dyn": fl.DYN_LAUNCHES}
    print(f"main path: {wall:.3f} s wall; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel contract was never launched: {launches}")

    src = "starcat_torch/csrc/fused_leapfrog.cu"
    rows = [
        {"name": "fused_leapfrog (B1 contract, static L)", "route": "cuda",
         "source": src, "replaces": "starcat/pallas_kernels.py:441",
         "launches": launches["static"], "max_abs_err": err["static"],
         "ms": ms["static"], "plain_ms": ms["plain"]},
        {"name": "fused_leapfrog_dyn (B2 contract, runtime n_steps)",
         "route": "cuda", "source": src,
         "replaces": "starcat/pallas_kernels.py:317",
         "launches": launches["dyn"], "max_abs_err": err["dyn"],
         "ms": ms["dyn"], "plain_ms": ms["plain"]},
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
