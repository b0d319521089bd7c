"""Time the trans-d sweep kernel (csrc/fused_transdim_sweep.cu) beside its
plain version, in turns, on one card.

    python scripts/sweep_before_after.py [--old PATH] [--reps N]

Builds the checkout's source and prints its ptxas report; runs
chip_smoke.py's phase 6b, which holds the kernel against the plain version
(transdim.poisson_sweep_reference, plain PyTorch on the card) at each of
its shapes; then, at each shape (chip_smoke.SWEEP_SHAPES, on
chip_smoke.sweep_inputs' inputs and draws),
times one sweep with CUDA events over --reps calls in the order plain,
kernel, kernel, plain, and prints both means, their ratio, the kernel's
bound (chip_smoke.sweep_ops / sweep_bytes) and the build's layout.  With --old, an
earlier build of the source is timed beside the new one too (old, new,
new, old), and whether the two give the same bits.  The card's name and
power limit come first; the last line is one JSON object, also appended to
chiprun_out/sweep_before_after.jsonl.  Needs a CUDA card and nvcc.
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


def build_variant(path: Path, tag: str):
    """nvcc on an earlier sweep source with the checkout's flags, into
    build/kernels/variants/; returns the typed library and the report."""
    from starcat_torch import build
    from starcat_torch import fused_transdim_sweep as fts

    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"sweep_{tag}_{digest}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    return fts.type_library(ctypes.CDLL(str(lib_path))), proc.stderr


def _ptxas(report: str) -> list[str]:
    return [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="an earlier fused_transdim_sweep.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from starcat_torch import build
    from starcat_torch import fused_transdim_sweep as fts
    from starcat_torch import transdim as td
    from starcat_torch.configs import CONFIGS

    if not torch.cuda.is_available():
        print("sweep_before_after: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda:0")
    _, report, _ = build.build_kernel("fused_transdim_sweep")
    new = fts.library()
    print("new build:", *_ptxas(report), sep="\n  ")
    old = None
    if args.old is not None:
        old, old_report = build_variant(args.old, "old")
        print("old build:", *_ptxas(old_report), sep="\n  ")
    result = {"device": smi[0], "shapes": {}}
    err, _ = chip_smoke.check_sweep_kernel(fts, CONFIGS, dev)
    result["check_theta_err"] = err

    for name, preset, over, c, beta in chip_smoke.SWEEP_SHAPES:
        cfg = chip_smoke.sweep_config(CONFIGS, preset, over)
        img, theta, mask, tll, b, tcfg, draws = chip_smoke.sweep_inputs(cfg, c, dev, 60, beta)
        spec, prior = cfg.scene, cfg.prior
        b_dev = fts.check_inputs(theta, mask, tll, b, img, draws, spec, tcfg)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def kernel(lib):
            return lambda: fts.run(lib, stream, theta, mask, tll, b_dev, img, draws, spec, prior,
                                   tcfg)

        def plain():
            return td.poisson_sweep_reference(theta, mask, tll, b, prior, spec, img, tcfg, draws)

        turns = [("plain", plain), ("new", kernel(new)), ("new", kernel(new)), ("plain", plain)]
        if old is not None:
            turns = [("old", kernel(old))] + turns + [("old", kernel(old))]
        times: dict = {}
        for who, fn in turns:
            times.setdefault(who, []).append(chip_smoke._time_ms(fn, args.reps))
        h, w, k = spec.height, spec.width, cfg.kmax
        out = kernel(new)()
        births = int(((out[3].move_type == 0) & (mask.sum(-1) < k)).sum())
        bound = chip_smoke.bound_ms(
            chip_smoke.sweep_ops(h, w, mask),
            chip_smoke.sweep_bytes(c, k, h, w, births if tcfg.birth_proposal == "residual" else 0))
        row = {"chains": c, "K": k, "field": f"{h}x{w}", "births": tcfg.birth_proposal,
               "beta": beta, "live": int(mask.sum()), "ms": times,
               "kernel_ms": sum(times["new"]) / len(times["new"]),
               "plain_ms": sum(times["plain"]) / len(times["plain"]),
               "bound_ms": bound[0], "bound_by": bound[1],
               "layout": fts.launch_layout(c, k, h, w)}
        row["plain_over_kernel"] = row["plain_ms"] / row["kernel_ms"]
        row["bound_share"] = bound[0] / row["kernel_ms"]
        if old is not None:
            row["old_ms"] = sum(times["old"]) / len(times["old"])
            was = kernel(old)()
            row["same_bits_as_old"] = all(
                torch.equal(a.view(torch.int32), o.view(torch.int32)) if a.is_floating_point()
                else torch.equal(a, o) for a, o in zip(out[:3] + tuple(out[3]),
                                                      was[:3] + tuple(was[3])))
        result["shapes"][name] = row
        print(f"{name}: plain {row['plain_ms']:.4f} ms, kernel {row['kernel_ms']:.4f} ms "
              f"({row['plain_over_kernel']:.1f}x), bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{100 * row['bound_share']:.1f}% of the kernel's time)"
              + (f", old {row['old_ms']:.4f} ms, same bits {row['same_bits_as_old']}"
                 if old is not None else "") + f"; turns {json.dumps(times)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "sweep_before_after.jsonl", "a") as fh:
        fh.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
