"""Time two builds of the crowded-field full-Fisher kernel (B6c) in turns on
one card: an earlier source given by path, and the checkout's (or a second
one given by path).

    python scripts/b6c_before_after.py --old PATH/fused_rhmc_crowded.cu [--new PATH] [--wide]
        [--only NAME ...]

Both take B6c's C interface (csrc/fused_rhmc_crowded.cu: B6's entry with a
workspace and its grid; a build's workspace per block comes from its own
starcat_fused_rhmc_crowded_sizes, after a header whose first int, the chain
counter of builds that take chains from one, is zeroed before each launch).
Each build's kernels' machine code (cuobjdump -sass) is compared function
by function: identical, or how many lines differ (--sass-lines: the first
differing lines).  At three shapes (cfg4's: 4096 particles, K = 64 with
30..64 live, 128x128, 6 steps x 4 sweeps, B4's step over 3, as
chip_smoke.py phase 18a times it; the rhmc leg's: 64 chains, K = 20, the
drawn 64x64 field, 16 x 6, shared mask; cfg5's rhmc move: 256 chains,
K_max 24, per-chain masks, 64x64, 6 x 4), or with --wide at the wide
path's (:func:`shapes`), it prints the card's name and power limit, each
build's ptxas report and launch layout, how far the two kernels' outputs
are apart on the chains whose fixed points converged tightly in both
(absolute, and against chip_smoke.py phase 18's kernel-versus-plain bars,
the chains beyond a bar held against the float64 plain version), whether
the new build gives the same bits on a rerun and the old build's bits on
every chain, and then the time of one trajectory with CUDA events in the
order old, new, new, old, with the mean of each kernel, the ratio and the
share of the bound (chip_smoke.rhmc_full_sparse_ops: the work these inputs
need), of every pixel of every pair (rhmc_full_crowded_ops) and of B6's
count (rhmc_full_ops), the kernel's first bound.
The last line is one JSON object.
Needs a CUDA card and nvcc.
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
sys.path.insert(0, str(ROOT / "scripts"))

ENTRY = "starcat_fused_rhmc_crowded"
LAYOUT = "starcat_fused_rhmc_crowded_layout"
HEADER = 4  # floats before the blocks' slices (fused_rhmc_crowded.HEADER_FLOATS)


def build_b6c(path: Path, tag: str):
    """A B6c source built outside csrc/ (b4_before_after.build_source), its
    entry typed with the workspace and the grid; the compiler's report."""
    from b4_before_after import build_source

    digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
    lib, report = build_source(path, f"b6c_{tag}_{digest}", entry=ENTRY)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    getattr(lib, ENTRY).argtypes = [vp] * 4 + [ci] + [vp] * 8 + [ci] * 6 + [cf] * 7 + [vp, ci, vp]
    # a build that exports its wide path's mode writes the workspace's size
    # in 64 bits, an earlier one in an int
    lib.size_type = ctypes.c_int64 if hasattr(lib, "starcat_fused_rhmc_crowded_wide_mode") else ci
    lib.starcat_fused_rhmc_crowded_sizes.argtypes = ([ci] * 3
                                                     + [ctypes.POINTER(ci),
                                                        ctypes.POINTER(lib.size_type)])
    return lib, report


def sass_by_function(lib_path: Path) -> dict:
    """A build's SASS (cuobjdump -sass, from the toolkit beside nvcc) by
    kernel function name, the anonymous namespace's per-build hash taken
    out of names and lines."""
    import re

    from starcat_torch import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line.strip())
    return out


def launcher(lib, image, k, n_steps, fpi, scalars, theta, xi, eps, mask, beta=1.0):
    """A function that runs one trajectory of such a build and returns
    (theta', p', h0, h1, u1, resid), and the build's layout."""
    import torch

    from starcat_torch import build

    dev, c = theta.device, theta.shape[0]
    h, w = image.shape
    smem, floats = ctypes.c_int(), lib.size_type()
    if lib.starcat_fused_rhmc_crowded_sizes(k, h, w, ctypes.byref(smem), ctypes.byref(floats)):
        raise RuntimeError("starcat_fused_rhmc_crowded_sizes failed")
    lay = build.query_layout(lib, LAYOUT, c, k, h, w)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(c, lay["blocks_per_sm"] * sms)
    work = torch.zeros(HEADER + grid * floats.value, dtype=torch.float32, device=dev)
    beta_dev = torch.full((1,), float(beta), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        theta_out, p_out = torch.empty_like(theta), torch.empty_like(theta)
        outs = torch.empty((4, c), dtype=torch.float32, device=dev)
        work[:HEADER].zero_()
        rc = getattr(lib, ENTRY)(
            theta.data_ptr(), xi.data_ptr(), eps.data_ptr(), mask.data_ptr(),
            k if mask.ndim == 2 else 0, beta_dev.data_ptr(), image.data_ptr(),
            theta_out.data_ptr(), p_out.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), outs[3].data_ptr(), c, k, h, w, n_steps, fpi, *scalars,
            work.data_ptr(), grid, stream)
        if rc != 0:
            raise RuntimeError(f"a B6c build failed to launch ({rc})")
        return theta_out, p_out, outs[0], outs[1], outs[2], outs[3]

    return run, dict(lay, grid=grid, smem_bytes=smem.value,
                     workspace_mb=4 * (HEADER + grid * floats.value) / 1e6)


def shapes(dev, wide_path=False, only=None):
    """(name, scene, prior, image, K, n_steps, fpi, inputs) of the three
    shapes, or with ``wide_path`` the wide path's: the 192x192 slice at
    cfg4's density (1024 and 4096 particles, K = 125 with 30..125 live, 6 x
    4, a sixth of B4's step, as chip_smoke.py phase 20a holds it), R2's
    shape (the rhmc head's drawn 128x128 field, 64 chains, K = 80, 16 x 6,
    shared mask), W4's (64 chains, K = 300 on a drawn 128x128 field of 300
    stars, 16 x 6, all live, a twelfth of b4_inputs' step, as phase 21a
    times it) and every entry of chip_smoke.B6C_BEYOND at its chains, masks,
    step, trajectory and beta (inputs then carry beta fifth); the wide
    shapes drawn only where ``only`` (names) holds them."""
    import chip_smoke
    from starcat_torch.configs import CONFIGS, apply_overrides

    if wide_path:
        def slice192(c):
            cfg, truth, image = chip_smoke._wide_scene(CONFIGS, 192, 192)
            theta, xi, eps, mask = chip_smoke.b4_inputs(truth, c, 125, dev, 103, True)
            return cfg.scene, cfg.prior, image.to(dev), 125, 6, 4, (theta, xi, eps / 6.0, mask)

        def r2():
            rh = apply_overrides(CONFIGS["cfg1_rhmc"], chip_smoke.B6C_R2)
            truth, image = rh.make_data()
            theta, xi, eps, mask = chip_smoke._rhmc_inputs(truth, 64, 80, dev, 60, False)
            return (rh.scene, rh.prior, image.to(dev), 80, rh.rhmc.n_leapfrog,
                    rh.rhmc.fixed_point_iters, (theta, xi, eps / 3.0, mask))

        def w4():
            cfg, truth, image = chip_smoke._wide_scene(CONFIGS, 128, 128, 300)
            theta, xi, eps, mask = chip_smoke.b4_inputs(truth, 64, 300, dev, 152, False)
            return cfg.scene, cfg.prior, image.to(dev), 300, 16, 6, (theta, xi, eps / 12.0, mask)

        def beyond(i):
            h, w, k, c, per_chain, frac, n_steps, fpi, n = chip_smoke.B6C_BEYOND[i]
            cfg, truth, image = chip_smoke._wide_scene(CONFIGS, h, w, n)
            theta, xi, eps, mask = chip_smoke.b4_inputs(truth, c, k, dev, 140 + i, per_chain)
            return (cfg.scene, cfg.prior, image.to(dev), k, n_steps, fpi,
                    (theta, xi, eps / frac, mask, 1.0 if per_chain else 0.7))

        makers = [("192x192", lambda: slice192(1024)), ("192x192 4096", lambda: slice192(4096)),
                  ("128x128 K=80", r2), ("W4 K=300", w4)]
        makers += [(f"beyond {e[0]}x{e[1]} K={e[2]}", lambda i=i: beyond(i))
                   for i, e in enumerate(chip_smoke.B6C_BEYOND)]
        return [(name, *make()) for name, make in makers if only is None or name in only]

    cfg4 = CONFIGS["cfg4_crowded"]
    c_truth, c_image = cfg4.make_data()
    wide = apply_overrides(CONFIGS["cfg1_rhmc"], chip_smoke.B6C_RHMC)
    w_truth, w_image = wide.make_data()
    cfg5 = apply_overrides(CONFIGS["cfg5_transdim_mcmc"], chip_smoke.B6C_CFG5)
    theta, xi, eps, mask = chip_smoke.b4_inputs(c_truth, 4096, 64, dev, 70, True)
    out = [("cfg4", cfg4.scene, cfg4.prior, c_image.to(dev), 64, cfg4.smc.n_leapfrog,
            cfg4.smc.fixed_point_iters, (theta, xi, eps / 3.0, mask))]
    theta, xi, eps, mask = chip_smoke._rhmc_inputs(w_truth, 64, 20, dev, 60, False)
    out.append(("rhmc leg", wide.scene, wide.prior, w_image.to(dev), 20, wide.rhmc.n_leapfrog,
                wide.rhmc.fixed_point_iters, (theta, xi, eps / 3.0, mask)))
    theta, xi, eps, mask = chip_smoke._rhmc_inputs(w_truth, 256, 24, dev, 61, True)
    out.append(("cfg5 rhmc", cfg5.scene, cfg5.prior, w_image.to(dev), 24, cfg5.tdm.n_leapfrog,
                cfg5.tdm.fixed_point_iters, (theta, xi, eps / 3.0, mask)))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="the earlier B6c source")
    ap.add_argument("--new", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_rhmc_crowded.cu",
                    help="the later B6c source (default: the checkout's)")
    ap.add_argument("--reps", type=int, default=1, help="trajectories per timed turn")
    ap.add_argument("--only", nargs="+", default=None, help="run only the shapes of these names")
    ap.add_argument("--wide", action="store_true", help="the wide path's shapes")
    ap.add_argument("--sass-lines", type=int, default=0,
                    help="differing SASS lines to print for each function that differs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6c_before_after: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from starcat_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    libs, sass = {}, {}
    for tag, path in (("old", args.old), ("new", args.new)):
        libs[tag], report = build_b6c(path, tag)
        print(f"{tag}: {path}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
                print(f"ptxas {tag}: {line.strip()}")
        sass[tag] = sass_by_function(Path(libs[tag]._name))
    for name in sorted(set(sass["old"]) | set(sass["new"])):
        a, b = sass["old"].get(name), sass["new"].get(name)
        if a is None or b is None:
            print(f"sass {name}: only in the {'new' if a is None else 'old'} build")
        elif a == b:
            print(f"sass {name}: identical ({len(a)} lines)")
        else:
            pairs = [(x, y) for x, y in zip(a, b) if x != y]
            print(f"sass {name}: differs ({len(pairs) + abs(len(a) - len(b))} of {len(a)} / "
                  f"{len(b)} lines)")
            for x, y in pairs[:args.sass_lines]:
                print(f"  old {x}\n  new {y}")

    dev = torch.device("cuda:0")
    result = {"card": smi.splitlines()[0], "old": str(args.old), "new": str(args.new),
              "shapes": {}}
    for name, spec, prior, img, k, n_steps, fpi, inputs in shapes(dev, args.wide, args.only):
        theta, xi, eps, mask, *rest = inputs
        beta = rest[0] if rest else 1.0
        if args.only is not None and name not in args.only:
            continue
        c = theta.shape[0]
        scalars = build.riemannian_scalars(spec, prior, 1e-3)
        run, lay = {}, {}
        for tag, lib in libs.items():
            run[tag], lay[tag] = launcher(lib, img, k, n_steps, fpi, scalars, theta, xi, eps, mask,
                                          beta)
        a = run["old"]()
        b = run["new"]()
        again = run["new"]()
        torch.cuda.synchronize()
        same = chip_smoke._same_bits(a, b)
        tight = (a[5] < chip_smoke.TIGHT) & (b[5] < chip_smoke.TIGHT)
        apart = {nm: float(chip_smoke._per_chain((x - y).abs())[tight].max())
                 if bool(tight.any()) else None
                 for nm, x, y in zip(("theta", "p", "h0", "h1", "u1"), a, b)}
        # the same distances against phase 18's kernel-versus-plain bars:
        # theta RTOL, p relative to 1 + |p|, the energies in _h_tol (eight
        # float32 spacings on fields of 128 rows or more, four on the others)
        spacings = 8 if spec.height >= 128 else 4
        within = {}
        for nm, x, y in zip(("theta", "p", "h0", "h1", "u1"), a, b):
            if not bool(tight.any()):
                break
            d = (x - y).abs()
            if nm == "p":
                d = d / (1.0 + y.abs())
            d = chip_smoke._per_chain(d)[tight]
            tol = (chip_smoke.RTOL[nm] if nm in ("theta", "p")
                   else chip_smoke._h_tol(y[tight], spacings))
            within[nm] = {"max": float(d.max()) if d.numel() else None, "tol": float(tol),
                          "beyond": int((d > tol).sum())}
        # the chains beyond a bar, held against the float64 plain version
        # (phase 18's arbiter): each kernel's distance from it
        beyond = torch.zeros_like(tight)
        for nm, x, y in zip(("theta", "p", "h0", "h1", "u1"), a, b):
            if not bool(tight.any()):
                break
            d = (x - y).abs()
            if nm == "p":
                d = d / (1.0 + y.abs())
            d = chip_smoke._per_chain(d)
            beyond |= tight & (d > within[nm]["tol"])
        arbiter = None
        if bool(beyond.any()):
            from starcat_torch.fused_rhmc import fused_rhmc_reference

            idx = beyond.nonzero()[:16, 0]
            m = mask[idx] if mask.ndim == 2 else mask
            ref64 = fused_rhmc_reference(spec, img.double(), prior, theta[idx].double(),
                                         xi[idx].double(), eps[idx].double(), m.double(), beta,
                                         n_steps, fpi)

            def to64(out, nm, z):
                d = (out[idx].double() - z).abs()
                return chip_smoke._per_chain(d / (1.0 + z.abs()) if nm == "p" else d).tolist()

            arbiter = {"chains": idx.tolist(), "float64_resid": ref64[5].tolist()}
            for nm, x, y, z in zip(("theta", "p", "h0", "h1", "u1"), a, b, ref64):
                arbiter[nm] = {"old": to64(x, nm, z), "new": to64(y, nm, z)}
            print(f"  the {int(beyond.sum())} chains beyond a bar against float64 (p relative): "
                  f"{json.dumps(arbiter)}")
        verdicts = int(((a[5] < chip_smoke.SOLVER_TOL) != (b[5] < chip_smoke.SOLVER_TOL)).sum())
        repeat = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                     for x, y in zip(b, again))
        live = int(mask.sum()) if mask.ndim == 2 else c * k
        print(f"{name} ({c} chains, K={k}, {live} live stars, {spec.height}x{spec.width}, "
              f"{n_steps} x {fpi}, beta {beta}): layout {json.dumps(lay)}; old vs new on the "
              f"{int(tight.sum())} of {c} chains converged tightly in both: {json.dumps(apart)}; "
              f"against the kernel-versus-plain bars (p relative): {json.dumps(within)}; "
              f"solver verdicts differing {verdicts}; new run twice bitwise equal: {repeat}; "
              f"old and new the same bits on every chain: {same}")
        times = []
        for tag in ("old", "new", "new", "old"):
            ms = chip_smoke._time_ms(run[tag], args.reps, warmup=1 if c < 1024 else 0)
            times.append((tag, ms))
            print(f"  {tag}: {ms:.4f} ms per trajectory")
        mean = {tag: sum(t for g, t in times if g == tag) / 2 for tag in ("old", "new")}
        counts = mask.sum(1).tolist() if mask.ndim == 2 else [k] * c
        nbytes = chip_smoke.rhmc_bytes(c, k, spec.height, spec.width, mask.ndim == 2)
        bound = chip_smoke.bound_ms(chip_smoke.rhmc_full_sparse_ops(
            theta, mask, spec, n_steps, fpi), nbytes)[0]
        bound_dense = chip_smoke.bound_ms(sum(chip_smoke.rhmc_full_crowded_ops(
            1, int(n), spec.height, spec.width, n_steps, fpi) for n in counts), nbytes)[0]
        bound_b6 = chip_smoke.bound_ms(sum(chip_smoke.rhmc_full_ops(
            1, int(n), spec.height, spec.width, n_steps, fpi) for n in counts), nbytes)[0]

        def share(b):
            return f"new {100 * b / mean['new']:.1f}%, old {100 * b / mean['old']:.1f}%"

        print(f"  mean old {mean['old']:.4f} ms, new {mean['new']:.4f} ms, old / new "
              f"{mean['old'] / mean['new']:.3f}; bound {bound:.4f} ms ({share(bound)}); every "
              f"pixel of every pair {bound_dense:.4f} ms ({share(bound_dense)}); B6's count "
              f"{bound_b6:.4f} ms ({share(bound_b6)})")
        result["shapes"][name] = {"chains": c, "k": k, "live": live, "beta": beta, "turns": times,
                                  "mean_ms": mean, "ratio": mean["old"] / mean["new"],
                                  "bound_ms": bound, "bound_ms_dense": bound_dense,
                                  "bound_ms_b6_count": bound_b6,
                                  "layout": lay, "apart": apart, "within": within,
                                  "arbiter": arbiter,
                                  "tight": int(tight.sum()),
                                  "verdicts_differing": verdicts, "bitwise_repeat": repeat,
                                  "same_bits": same}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
