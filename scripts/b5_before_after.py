"""Time two builds of the crowded-field leapfrog kernel (B5) in turns on one
card: an earlier source given by path, and the checkout's (or a second one
given by path).

    python scripts/b5_before_after.py --old PATH/fused_leapfrog_crowded.cu [--new PATH]
    python scripts/b5_before_after.py --force-wide [--new PATH]

With --force-wide the "old" build is the source's own, whose launches at
these shapes take its one-tile path, and the "new" build a copy of the same
source whose one_tile() returns false, so that every launch takes the wide
path: the two paths timed in turns on the same inputs.

Both take B5's C interface (csrc/fused_leapfrog_crowded.cu, entry
starcat_fused_leapfrog_crowded).  At chip_smoke.py's two timed B5 shapes
(crowded: 1024 chains, K = 50, 128x128, L = 10; flagship: 1024 chains,
K = 10, 32x32, L = 20) and at two that only B5 serves (the crowded field's
64x64 corner at K = 30, L = 10; the flagship scene at K = 20, L = 20;
shared mask, entry gradient in, 1024 chains) it prints the card's
name and power limit, each build's ptxas report, how far the two kernels'
outputs are apart, whether they hold the same bits, and whether the new
one gives the same bits on a rerun,
then the time of one trajectory with CUDA events in the order old, new,
new, old, with the mean of each kernel, the ratio and the share of
chip_smoke's bound.  The last line is one JSON object with the times.
Needs a CUDA card and nvcc.

:func:`build_leapfrog` and :func:`launch` serve any build with that C
interface (scripts/b5_pass_clocks.py's probed copies too).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

ENTRY = "starcat_fused_leapfrog_crowded"


def type_leapfrog(lib, entry: str = ENTRY):
    """Give a build's leapfrog entry its argument types (build.py's
    leapfrog_library's, B1's and B5's C interface)."""
    import ctypes

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, entry)
    fn.argtypes = [vp] * 6 + [ci] + [vp] * 6 + [ci] * 4 + [cf] * 6 + [vp]
    fn.restype = ci
    return lib


def build_leapfrog(source: Path, name: str, entry: str = ENTRY):
    """nvcc on a leapfrog kernel source outside csrc/ with the checkout's
    flags (scripts/b4_before_after.build_source); returns the library and
    the compiler's report."""
    from b4_before_after import build_source

    lib, report = build_source(source, name, entry=entry)
    return type_leapfrog(lib, entry), report


def launch(lib, image, kmax, scalars, theta, p, eps, inv_mass, mask, n_steps: int, grad,
           entry: str = ENTRY):
    """One launch of such a build, as build.launch_leapfrog launches the
    checkout's (the inputs are the ones chip_smoke makes, checked there)."""
    import torch

    c = theta.shape[0]
    dev = theta.device
    theta_out, p_out, grad_out = (torch.empty_like(theta) for _ in range(3))
    u_out = torch.empty((c,), dtype=torch.float32, device=dev)
    eps_c = torch.as_tensor(eps, dtype=torch.float32, device=dev).reshape(-1).expand(c)
    eps_c = eps_c.contiguous()
    n_dev = torch.full((1,), int(n_steps), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, entry)(
        theta.data_ptr(), p.data_ptr(), None if grad is None else grad.data_ptr(),
        eps_c.data_ptr(), inv_mass.data_ptr(), mask.data_ptr(), kmax if mask.ndim == 2 else 0,
        image.data_ptr(), n_dev.data_ptr(), theta_out.data_ptr(), p_out.data_ptr(),
        u_out.data_ptr(), grad_out.data_ptr(), c, kmax, image.shape[0], image.shape[1],
        *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"the {entry} build failed to launch ({rc})")
    return theta_out, p_out, u_out, grad_out


def wide_copy(source: Path) -> Path:
    """A copy of a B5 source whose one_tile() returns false, written into the
    build directory: its every launch takes the wide path."""
    from starcat_torch import build

    text, n = re.subn(r"(inline bool one_tile\(int K, int H, int W\) \{\s*return )[^;]*;",
                      r"\1false;", source.read_text(), count=1)
    if n != 1:
        raise ValueError(f"{source} has no one_tile() to force")
    out = build.BUILD_DIR / "variants" / "fused_leapfrog_crowded_wide_forced.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def _crop(spec, truth, image, side: int):
    """The top-left side x side corner of a scene: its image and the true
    stars inside it, their logits taken to the corner's width."""
    import torch

    x = spec.width * torch.sigmoid(truth[:, 0])
    y = spec.height * torch.sigmoid(truth[:, 1])
    keep = (x < side) & (y < side)
    cut = torch.stack([torch.logit(x[keep] / side), torch.logit(y[keep] / side),
                       truth[keep, 2]], dim=1)
    return spec._replace(height=side, width=side), cut, image[:side, :side].contiguous()


def shapes(dev):
    """(name, scene, image, prior, K, L, theta, p, eps, inv_mass, mask,
    entry gradient) at chip_smoke's two timed B5 shapes, its inputs, at
    two scenes that only B5 serves (beyond B1's K <= 16): the crowded
    field's 64x64 corner at K = 30 and the flagship scene at K = 20, and at
    the wide path's 192x192 slice (1024 chains, K = 112, chip_smoke.py
    phase 19a's timed launch)."""
    import chip_smoke
    import torch

    from starcat_torch import fused_leapfrog as fl
    from starcat_torch.configs import CONFIGS

    out = []
    cfg, truth, image = chip_smoke._wide_scene(CONFIGS, 192, 192)
    theta, p, eps = chip_smoke._crowded_inputs(truth, 1024, 112, dev, 102)
    eps = 0.002 * eps
    img, k = image.to(dev), 112
    inv_mass, mask = torch.full((k, 3), 0.9, device=dev), torch.ones(k, device=dev)
    g0 = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass, mask,
                                     0, None)[3]
    wide = ("192x192 K=112", cfg.scene, img, cfg.prior, k, 10, theta, p, eps, inv_mass, mask,
            g0)
    for name, cfg_name, k, L, seed, side in (
            ("crowded", "cfg4_crowded", 50, 10, 30, None),
            ("flagship", "cfg6_chees", 10, 20, 31, None),
            ("64x64 K=30", "cfg4_crowded", 30, 10, 32, 64),
            ("flagship K=20", "cfg6_chees", 20, 20, 33, None)):
        cfg = CONFIGS[cfg_name]
        truth, image = cfg.make_data()
        spec = cfg.scene
        if side is not None:
            spec, truth, image = _crop(spec, truth, image, side)
        img = image.to(dev)
        theta, p, eps = chip_smoke._crowded_inputs(truth, 1024, k, dev, seed)
        eps = 0.002 * eps
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        mask = torch.ones(k, device=dev)
        g0 = fl.fused_leapfrog_reference(spec, img, cfg.prior, theta, p, eps, inv_mass,
                                         mask, 0, None)[3]
        out.append((name, spec, img, cfg.prior, k, L, theta, p, eps, inv_mass, mask, g0))
    return out + [wide]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="the earlier B5 source")
    ap.add_argument("--force-wide", action="store_true",
                    help="time the --new source's one-tile path (as old) against its wide "
                         "path forced (as new) instead of --old")
    ap.add_argument("--new", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_leapfrog_crowded.cu",
                    help="the later B5 source (default: the checkout's)")
    ap.add_argument("--reps", type=int, default=10, help="trajectories per timed turn")
    args = ap.parse_args()
    if (args.old is None) == (not args.force_wide):
        ap.error("give --old or --force-wide")
    if not torch.cuda.is_available():
        print("b5_before_after: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from starcat_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    libs = {}
    if args.force_wide:
        args.old, args.new = args.new, wide_copy(args.new)
    for tag, path in (("old", args.old), ("new", args.new)):
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        libs[tag], report = build_leapfrog(path, f"b5_{tag}_{digest}")
        print(f"{tag}: {path}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {tag}: {line.strip()}")

    dev = torch.device("cuda:0")
    result = {"card": smi.splitlines()[0], "old": str(args.old), "new": str(args.new),
              "shapes": {}}
    for name, spec, img, prior, k, L, theta, p, eps, inv_mass, mask, g0 in shapes(dev):
        scalars = build.leapfrog_scalars(spec, prior)
        run = {tag: (lambda lib=lib: launch(lib, img, k, scalars, theta, p, eps, inv_mass,
                                            mask, L, g0))
               for tag, lib in libs.items()}
        a, b = run["old"](), run["new"]()
        apart = {nm: float((x - y).abs().max())
                 for nm, x, y in zip(("theta", "p", "u", "grad"), a, b)}
        same = chip_smoke._same_bits(a, b)
        repeat = chip_smoke._same_bits(b, run["new"]())
        c = theta.shape[0]
        print(f"{name} ({c} chains, K={k}, {spec.height}x{spec.width}, L={L}): old vs new "
              f"{json.dumps(apart)}, the same bits: {same}; new run twice bitwise equal: "
              f"{repeat}")
        times = []
        for tag in ("old", "new", "new", "old"):
            ms = chip_smoke._time_ms(run[tag], args.reps, warmup=2)
            times.append((tag, ms))
            print(f"  {tag}: {ms:.4f} ms per trajectory")
        mean = {tag: sum(t for g, t in times if g == tag) / 2 for tag in ("old", "new")}
        bound = chip_smoke.bound_ms(
            chip_smoke.leapfrog_ops(c, k, spec.height, spec.width, L, True),
            chip_smoke.leapfrog_bytes(c, k, spec.height, spec.width, True))[0]
        print(f"  mean old {mean['old']:.4f} ms, new {mean['new']:.4f} ms, old / new "
              f"{mean['old'] / mean['new']:.3f}; bound {bound:.4f} ms (new "
              f"{100 * bound / mean['new']:.1f}%, old {100 * bound / mean['old']:.1f}%)")
        result["shapes"][name] = {"turns": times, "mean_ms": mean, "bound_ms": bound,
                                  "apart": apart, "same_bits": same,
                                  "bitwise_repeat": repeat}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
