"""Where one B6c trajectory spends its time, pass by pass, on the card.

    python scripts/b6c_pass_clocks.py [--source PATH/fused_rhmc_crowded.cu] [--wide]

Builds a copy of a B6c source (the checkout's csrc/fused_rhmc_crowded.cu by
default) with scripts/b6_pass_clocks.py's probes: thread 0 of every block
adds the SM cycles since the previous probe to the pass that just ended
(B6c's passes have B6's names), and what runs between two passes to
"rest"; the clocks restart at each chain's first rebuild.  The copy runs
one trajectory at each of chip_smoke.py phase 18's two shapes (cfg4's:
4096 particles, K = 64 with 30..64 live, 128x128, 6 x 4; the drawn 64x64
field: 64 chains, K = 20, 16 x 6, shared mask); the script prints the
card, each trajectory's time with CUDA events and each pass's share of the
summed block cycles, and ends with one JSON line.  With --wide it runs
the wide path's shapes instead (chip_smoke.py phase 20's: the 192x192
slice at cfg4's density, 1024 particles, K = 125 with 30..125 live, 6 x 4;
the rhmc head's drawn 128x128 field, 64 chains, K = 80, 16 x 6, shared
mask), each pass's probes in both kernels.  The shipped kernel is not
changed.  Needs a CUDA card and nvcc.
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


def build_probed(text: str, name: str):
    """nvcc on the probed copy with the checkout's flags; the library with
    B6c's entry typed (B6's interface, then the workspace and the grid)."""
    from starcat_torch import build

    cu = build.BUILD_DIR / "variants" / f"{name}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    lib_path = cu.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, ENTRY)
    fn.argtypes = [vp] * 4 + [ci] + [vp] * 8 + [ci] * 6 + [cf] * 7 + [vp, ci, vp]
    fn.restype = ci
    lib.b6_read_clocks.argtypes = [vp]
    lib.starcat_fused_rhmc_crowded_sizes.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
    return lib, proc.stderr


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_rhmc_crowded.cu")
    ap.add_argument("--wide", action="store_true", help="the wide path's shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6c_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b6_pass_clocks import N_IDS, PASSES, instrumented_source
    from starcat_torch import build
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch.configs import CONFIGS, apply_overrides

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    text, sites = instrumented_source(args.source.read_text())
    lib, report = build_probed(text, "b6c_pass_clocks_"
                               + hashlib.sha256(text.encode()).hexdigest()[:16])
    print(f"{args.source}: call sites {json.dumps(sites)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas (probed copy): {line.strip()}")

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg4 = CONFIGS["cfg4_crowded"]
    wide = apply_overrides(CONFIGS["cfg1_rhmc"], chip_smoke.B6C_RHMC)
    result = {"card": smi.splitlines()[0], "source": str(args.source), "shapes": {}}
    shapes = (("cfg4", cfg4, 4096, 64, 6, 4), ("64x64", wide, 64, 20, 16, 6))
    if args.wide:
        shapes = (("192x192", chip_smoke._wide_scene(CONFIGS, 192, 192)[0], 1024, 125, 6, 4),
                  ("128x128 K=80", apply_overrides(CONFIGS["cfg1_rhmc"], chip_smoke.B6C_R2),
                   64, 80, 16, 6))
    for name, cfg, c, k, n_steps, fpi in shapes:
        truth, image = cfg.make_data()
        img = image.to(dev)
        spec = cfg.scene
        if cfg.head == "smc":
            theta, xi, eps, mask = chip_smoke.b4_inputs(truth, c, k, dev, 70, True)
        else:
            theta, xi, eps, mask = chip_smoke._rhmc_inputs(truth, c, k, dev, 60, False)
        eps = eps / 3.0
        scalars = build.riemannian_scalars(spec, cfg.prior, 1e-3)
        lay = build.query_layout(lib, "starcat_fused_rhmc_crowded_layout", c, k, spec.height,
                                 spec.width)
        grid = min(c, lay["blocks_per_sm"] * sms)
        # the source's own workspace a block, after the header whose first
        # int, the chain counter of a source that takes chains from one, is
        # zeroed before each launch
        smem, floats = ctypes.c_int(), ctypes.c_int()
        if lib.starcat_fused_rhmc_crowded_sizes(k, spec.height, spec.width, ctypes.byref(smem),
                                                ctypes.byref(floats)):
            raise RuntimeError("starcat_fused_rhmc_crowded_sizes failed")
        work = torch.zeros(frc.HEADER_FLOATS + grid * floats.value, dtype=torch.float32,
                           device=dev)
        outs = torch.empty((2, c, k, 3), device=dev)
        scal = torch.empty((4, c), device=dev)
        beta = torch.ones(1, device=dev)

        def run():
            work[:frc.HEADER_FLOATS].zero_()
            rc = getattr(lib, ENTRY)(
                theta.data_ptr(), xi.data_ptr(), eps.data_ptr(), mask.data_ptr(),
                k if mask.ndim == 2 else 0, beta.data_ptr(), img.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), scal[0].data_ptr(), scal[1].data_ptr(),
                scal[2].data_ptr(), scal[3].data_ptr(), c, k, spec.height, spec.width, n_steps,
                fpi, *scalars, work.data_ptr(), grid,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the probed copy failed to launch ({rc})")

        run()
        torch.cuda.synchronize()
        if lib.b6_zero_clocks() != 0:
            raise RuntimeError("could not zero the clocks")
        ms = chip_smoke._time_ms(run, 1, warmup=0)
        clocks = (ctypes.c_ulonglong * N_IDS)()
        if lib.b6_read_clocks(ctypes.addressof(clocks)) != 0:
            raise RuntimeError("could not read the clocks")
        total = sum(clocks)
        names = [nm for nm, _ in PASSES] + ["rest"]
        shares = {nm: clocks[i] / total for i, nm in enumerate(names)}
        print(f"{name}: {c} chains, K={k}, {int(mask.sum()) if mask.ndim == 2 else c * k} "
              f"live stars, {n_steps} x {fpi}: {ms:.4f} ms (instrumented); "
              f"{total / c:.5g} SM cycles a chain")
        for i, nm in enumerate(names):
            if nm != "rest" and sites[nm] == 0:
                continue
            print(f"  {nm}: {100 * shares[nm]:.1f}%  ({clocks[i] / c:.5g} cycles a chain)")
        result["shapes"][name] = {"ms": ms, "cycles_per_chain": total / c, "share": shares}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
