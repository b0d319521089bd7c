"""Where one B5 trajectory spends its time, pass by pass, on the card.

    python scripts/b5_pass_clocks.py [--source PATH/fused_leapfrog_crowded.cu]

Builds a copy of a B5 source (the checkout's csrc/fused_leapfrog_crowded.cu
by default) with a clock64() probe around every pass of a gradient
evaluation (under build/kernels/variants/, with scripts/b3_pass_clocks.py's
instrument and scripts/b5_before_after.py's build_leapfrog): thread 0 of
every block adds the SM cycles since the previous probe to the pass that
just ended.  A pass is a one-line call statement of its function in PASSES
or, in the first source (one function for the whole evaluation), the text
that begins and ends it.  What the evaluation runs between passes counts as
"per-star phases", the leapfrog's momentum and position updates as "rest".
The copy runs one trajectory at chip_smoke.py's timed B5 shape (1024
chains, K = 50, 128x128, L = 10, shared mask, entry gradient in); the
script prints the card, the trajectory's time with CUDA events and each
pass's share of the summed block cycles, and ends with one JSON line.  The
shipped kernel is not changed.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

PASSES = (("profiles", ("profiles",)), ("render", ("render",)),
          ("contraction", ("contract",)), ("chain rule and priors", ("chain_rule",)))
# the first source's single grad_eval: (text that begins a pass, text that
# ends it, pass)
LEGACY = (
    ("  if (tid < K) {\n    const float m = s.mask[tid];\n",
     "    s.gyzw[i] = g * z;\n  }\n  __syncthreads();\n", "profiles"),
    ("  double ll = 0.0;\n  for (int pix = tid; pix < H * W; pix += kThreads) {\n",
     "  if (with_u) ll = block_sum_d(ll, s.red);  // synchronises\n  else __syncthreads();\n",
     "render"),
    ("  // one warp per star: each lane sums kCols columns down the rows, then\n",
     "      s.dl[3 * k + 2] = cy * inv_sig;\n    }\n  }\n  __syncthreads();\n", "contraction"),
    ("  // chain rule to (ux, uy, s) and the priors, one thread per star\n",
     "    if (tid == 0) s.u[0] = static_cast<float>(-(ll + lp));\n  }\n  __syncthreads();\n",
     "chain rule and priors"),
)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_leapfrog_crowded.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b5_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    from b3_pass_clocks import build_probed, read_clocks
    from b5_before_after import ENTRY, launch, shapes, type_leapfrog
    from starcat_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    lib, sites, names, report = build_probed(args.source, "b5", ENTRY, PASSES, ("grad_eval",),
                                             (), LEGACY)
    type_leapfrog(lib)
    print(f"{args.source}: sites {json.dumps(sites)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas (probed copy): {line.strip()}")

    dev = torch.device("cuda:0")
    name, spec, img, prior, k, L, theta, p, eps, inv_mass, mask, g0 = shapes(dev)[0]
    scalars = build.leapfrog_scalars(spec, prior)
    c = theta.shape[0]

    def run():
        launch(lib, img, k, scalars, theta, p, eps, inv_mass, mask, L, g0)

    res = read_clocks(lib, run, names, sites, c,
                      f"{name}: {c} chains, K={k}, {spec.height}x{spec.width}, L={L}")
    print(json.dumps({"card": smi.splitlines()[0], "source": str(args.source), name: res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
