"""Where one B4 trajectory spends its time, pass by pass, on the card.

    python scripts/b4_pass_clocks.py [--chains 4096]

Builds a copy of csrc/fused_rhmc_diag_crowded.cu with a clock64() probe
after each pass (under build/kernels/variants/, with
scripts/b4_before_after.py's helpers): thread 0 of every block adds the SM
cycles since the previous probe to the pass that just ended, so a pass's
share includes the per-star code that ran before it.  The copy runs once at
chip_smoke.py's cfg4 shape (per-particle masks, 30..64 live stars, 6 x 4,
beta 1); the script prints the card, the trajectory's time with CUDA events
and each pass's share of the summed block cycles, and ends with one JSON
line.  The shipped kernel is not changed.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PASSES = ("profiles", "render", "rho contraction", "bilinears", "q field",
          "q contraction", "metric solve", "tail")

PROBE = r'''
__device__ unsigned long long b4_clocks[8];
__device__ __forceinline__ void probe(int id) {
  __shared__ long long last;
  if (threadIdx.x == 0) {
    const long long t = clock64();
    if (id >= 0) atomicAdd(&b4_clocks[id], static_cast<unsigned long long>(t - last));
    last = t;
  }
}
'''

READ = r'''
extern "C" int b4_read_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, b4_clocks, sizeof(b4_clocks)));
}
extern "C" int b4_zero_clocks() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(b4_clocks, z, sizeof(z)));
}
'''

# (text in the source, probe id placed after it)
SITES = (
    ("  profiles(P, s, D, s.th_b);\n", 0),
    ("  const double ll = render(P, s, D, beta, true);\n", 1),
    ("  contract<kField>(P, s, D);  // rho -> dot\n", 2),
    ("  contract<kBuild>(P, s, D);  // 1/lam -> d1..d9\n", 3),
    ("  q_field(P, s, D);  // synchronises before it reads s.ca\n", 4),
    ("  contract<kField>(P, s, D);\n  if (tid < 3 * K) {\n", 5),
    ("  profiles(P, s, D, th);\n", 0),
    ("  render(P, s, D, beta, false);\n", 1),
    ("  contract<kSolve>(P, s, D);\n", 6),
)


def instrumented_source() -> str:
    src = (ROOT / "starcat_torch" / "csrc" / "fused_rhmc_diag_crowded.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + PROBE, 1)
    for text, pid in SITES:
        if src.count(text) != 1:
            raise RuntimeError(f"probe site not found once: {text!r}")
        if text.endswith("{\n"):  # a probe before the block that follows
            head = text[:text.index("\n") + 1]
            src = src.replace(text, head + f"  probe({pid});\n" + text[len(head):])
        else:
            src = src.replace(text, text + f"  probe({pid});\n")
    start = "  build_structs(P, s, D, beta);\n  if (tid < d3) s.p_b"
    end = "  if (tid < d3) {\n    P.theta_out"
    for text in (start, end):
        if src.count(text) != 1:
            raise RuntimeError(f"probe site not found once: {text!r}")
    src = src.replace(start, "  probe(-1);\n" + start)
    src = src.replace(end, "  __syncthreads();\n  probe(7);\n" + end)
    return src + READ


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b4_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b4_before_after import build_source, launch
    from starcat_torch import build
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    cu = build.BUILD_DIR / "variants" / "b4_pass_clocks.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(instrumented_source())
    lib, _ = build_source(cu, "b4_pass_clocks")
    lib.b4_read_clocks.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda:0")
    cfg4 = CONFIGS["cfg4_crowded"]
    truth, image = cfg4.make_data()
    img = image.to(dev)
    n_steps, fpi = cfg4.smc.n_leapfrog, cfg4.smc.fixed_point_iters
    c = args.chains
    theta, xi, eps, mask = chip_smoke.b4_inputs(truth, c, 64, dev, 48, True)
    scalars = build.riemannian_scalars(cfg4.scene, cfg4.prior, 1e-3)

    def run():
        launch(lib, img, 64, n_steps, fpi, scalars, theta, xi, eps, mask, 1.0)

    run()
    torch.cuda.synchronize()
    if lib.b4_zero_clocks() != 0:
        raise RuntimeError("could not zero the clocks")
    ms = chip_smoke._time_ms(run, 1, warmup=0)
    clocks = (ctypes.c_ulonglong * 8)()
    if lib.b4_read_clocks(ctypes.addressof(clocks)) != 0:
        raise RuntimeError("could not read the clocks")
    total = sum(clocks)
    shares = {name: clocks[i] / total for i, name in enumerate(PASSES)}
    print(f"{c} particles, {int(mask.sum())} live stars, {n_steps} x {fpi}: {ms:.4f} ms "
          f"(instrumented); {total / c:.4g} SM cycles per block")
    for name, share in shares.items():
        print(f"  {name}: {100 * share:.1f}%  ({clocks[PASSES.index(name)] / c:.4g} cycles "
              "per block)")
    print(json.dumps({"card": smi.splitlines()[0], "ms": ms, "cycles_per_block": total / c,
                      "share": shares}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
