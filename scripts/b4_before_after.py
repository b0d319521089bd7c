"""Time two builds of the crowded-field diagonal-Fisher kernel (B4) in turns
on one card: an earlier source given by path, and the one in the checkout.

    python scripts/b4_before_after.py --old PATH/fused_rhmc_diag_crowded.cu [--wide]

Both take B4's C interface (csrc/fused_rhmc_diag_crowded.cu).  At
chip_smoke.py's cfg4 shape (4096 particles, K = 64, 128x128, 6 steps x 4
sweeps, per-particle masks with 30..64 stars alive, beta 1), or with --wide
at the wide path's 192x192 slice (4096 particles, K = 125 with 30..125
alive, chip_smoke.py phase 19a's timed launch, a workspace slice a chain
for both builds) it prints the card's name and power limit, each build's
ptxas report, whether the two kernels' outputs hold the same bits, how far
they are apart on the chains whose fixed points converged tightly in
both, and then the time of one trajectory with CUDA events in the order
old, new, new, old, with the mean of each kernel and the ratio.  The last
line is one JSON object with the times.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


B4_ENTRY = "starcat_fused_rhmc_diag_crowded"


def build_source(source: Path, name: str, entry: str = B4_ENTRY) -> tuple[ctypes.CDLL, str]:
    """nvcc on a Riemannian kernel's source outside csrc/ (B4's by default;
    B3, B4 and B6 share one C interface), with the checkout's flags, into
    build/kernels/variants/<name>.so (kept, with the compiler's report, for
    a later call with the same name); returns the library, with the
    entry's argument types set, and the compiler's report."""
    from starcat_torch import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"{name}.so"
    log = lib_path.with_suffix(".log")
    if lib_path.exists() and log.exists():  # the name carries the source's digest
        report = log.read_text()
    else:
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                               str(source)], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        report = proc.stderr
        log.write_text(report)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, entry)
    # B4's entry takes its wide path's workspace and grid before the stream
    # since its wide path came in; launch passes none (the one-tile path)
    lib.takes_workspace = entry == B4_ENTRY and "void* work, int grid" in source.read_text()
    fn.argtypes = ([vp] * 4 + [ci] + [vp] * 8 + [ci] * 6 + [cf] * 7
                   + ([vp, ci] if lib.takes_workspace else []) + [vp])
    fn.restype = ci
    return lib, report


def launch(lib, image, kmax, n_steps, fpi, scalars, theta, xi, eps, mask, beta,
           entry: str = B4_ENTRY, work=None):
    """One launch of such a build, as build.launch_riemannian launches the
    checkout's (the inputs are the ones chip_smoke makes, already checked
    there); ``work``, a B4 build's wide-path workspace of a slice a chain,
    or None for its one-tile path."""
    import torch

    c = theta.shape[0]
    theta_out, p_out = torch.empty_like(theta), torch.empty_like(theta)
    outs = torch.empty((4, c), dtype=torch.float32, device=theta.device)
    beta_dev = torch.full((1,), float(beta), dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = getattr(lib, entry)(
        theta.data_ptr(), xi.data_ptr(), eps.data_ptr(), mask.data_ptr(), kmax if mask.ndim == 2
        else 0, beta_dev.data_ptr(), image.data_ptr(), theta_out.data_ptr(), p_out.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(), c, kmax,
        image.shape[0], image.shape[1], n_steps, fpi, *scalars,
        *(((None, 0) if work is None else (work.data_ptr(), c))
          if getattr(lib, "takes_workspace", False) else ()), stream)
    if rc != 0:
        raise RuntimeError(f"the {entry} build failed to launch ({rc})")
    return theta_out, p_out, outs[0], outs[1], outs[2], outs[3]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier B4 source")
    ap.add_argument("--reps", type=int, default=3, help="trajectories per timed turn")
    ap.add_argument("--wide", action="store_true", help="the wide path's 192x192 slice")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b4_before_after: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from starcat_torch import build
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    digest = hashlib.sha256(args.old.read_bytes()).hexdigest()[:16]
    lib_old, report_old = build_source(args.old, f"b4_old_{digest}")
    _, report_new, _ = build.build_kernel("fused_rhmc_diag_crowded")
    for tag, report in (("old", report_old), ("new", report_new)):
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {tag}: {line.strip()}")

    dev = torch.device("cuda:0")
    cfg4 = CONFIGS["cfg4_crowded"]
    n_steps, fpi = cfg4.smc.n_leapfrog, cfg4.smc.fixed_point_iters
    if args.wide:
        cfg, truth, image = chip_smoke._wide_scene(CONFIGS, 192, 192)
        k, seed = 125, 103
    else:
        cfg, k, seed = cfg4, 64, 48
        truth, image = cfg4.make_data()
    img, side = image.to(dev), cfg.scene.height
    theta, xi, eps, mask = chip_smoke.b4_inputs(truth, cfg4.smc.n_particles, k, dev, seed, True)
    scalars = build.riemannian_scalars(cfg.scene, cfg.prior, 1e-3)
    new = frdc.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, k, n_steps, fpi)
    work = (torch.empty(theta.shape[0] * frdc.workspace_floats(k, side, side), device=dev)
            if args.wide else None)
    run = {"old": lambda: launch(lib_old, img, k, n_steps, fpi, scalars, theta, xi, eps,
                                 mask, 1.0, work=work),
           "new": lambda: new(theta, xi, eps, mask, 1.0)}

    a, b = run["old"](), run["new"]()
    same = chip_smoke._same_bits(a, b)
    print(f"old vs new: the same bits on every chain: {same}")
    tight = (a[5] < chip_smoke.TIGHT) & (b[5] < chip_smoke.TIGHT)
    apart = {nm: float(chip_smoke._per_chain((x - y).abs())[tight].max())
             for nm, x, y in zip(("theta", "p", "h0", "h1", "u1"), a, b)}
    print(f"old vs new on the {int(tight.sum())} of {theta.shape[0]} chains converged "
          f"tightly in both: {json.dumps(apart)}")

    times = []
    for tag in ("old", "new", "new", "old"):
        ms = chip_smoke._time_ms(run[tag], args.reps, warmup=1)
        times.append((tag, ms))
        print(f"{tag}: {ms:.4f} ms per trajectory")
    mean = {tag: sum(t for g, t in times if g == tag) / 2 for tag in ("old", "new")}
    live = int(mask.sum())
    bound = chip_smoke.bound_ms(chip_smoke.rhmc_diag_ops(1, live, side, side, n_steps, fpi),
                                chip_smoke.rhmc_bytes(theta.shape[0], k, side, side, True))[0]
    print(f"mean old {mean['old']:.4f} ms, new {mean['new']:.4f} ms, old / new "
          f"{mean['old'] / mean['new']:.3f}; bound of the {live} live stars {bound:.4f} ms "
          f"(new {100 * bound / mean['new']:.1f}%, old {100 * bound / mean['old']:.1f}%)")
    print(json.dumps({"card": smi.splitlines()[0], "shape": f"{side}x{side} K={k}",
                      "turns": times, "mean_ms": mean,
                      "live_stars": live, "bound_ms": bound, "same_bits": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
