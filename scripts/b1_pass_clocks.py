"""Where one B1 trajectory spends its time, pass by pass, on the card.

    python scripts/b1_pass_clocks.py [--source PATH/fused_leapfrog.cu] [--old PATH]

Builds a copy of a B1 source (the checkout's csrc/fused_leapfrog.cu by
default, and an earlier one given with --old) with a clock64() probe
around every pass of a gradient evaluation (under build/kernels/variants/,
with scripts/b3_pass_clocks.py's instrument and scripts/b5_before_after.py's
build_leapfrog): thread 0 of every block adds the SM cycles since the
previous probe to the pass that just ended, so a block's count follows its
first chain.  A pass is a one-line call statement of its functions in
PASSES or, in the first source (one function for the whole evaluation),
the text that begins and ends it: the profiles, the pixel work (the first
source's render and contraction, the fused row sweep of the later one),
the reduction over the warp (the later source's) and the chain rule and
priors.  What the evaluation runs between passes counts as "per-star
phases", the leapfrog's updates as "rest".  Each copy runs one trajectory at
the flagship shape (1024 chains, K = 10, 32x32, L = 20, shared mask, entry
gradient in); the script prints the card, the trajectory's time with CUDA
events and each pass's share of the summed cycles, with the cycles per
chain, and ends with one JSON line.  The shipped kernel is not changed.
Needs a CUDA card and nvcc.
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

ENTRY = "starcat_fused_leapfrog"
PASSES = (("profiles", ("profiles", "col_profiles", "row_profiles")),
          ("render", ("render",)), ("contraction", ("contract",)),
          ("sweep", ("sweep_rows",)), ("reduction", ("reduce_sums", "exchange")),
          ("chain rule and priors", ("chain_rule",)))
# the first source's single grad_eval: (text that begins a pass, text that
# ends it, pass)
LEGACY = (
    ("  if (tid < K) {\n    const float m = s.mask[tid];\n",
     "    s.gyz[i] = g * z;\n  }\n  __syncthreads();\n", "profiles"),
    ("  float ll = 0.0f;\n  for (int pix = tid; pix < H * W; pix += kThreads) {\n",
     "    if (lane == 0) s.red[warp] = ll;\n  }\n  __syncthreads();\n", "render"),
    ("  // one warp per star: H-first contraction, then the W-length dots\n",
     "      s.dl[3 * k + 2] = cy / sig;\n    }\n  }\n  __syncthreads();\n", "contraction"),
    ("  // chain rule to (ux, uy, s) and the priors; K <= 16 stars fit one warp\n",
     "      if (lane == 0) s.u[0] = -(llt + lp);\n    }\n  }\n  __syncthreads();\n",
     "chain rule and priors"),
)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_leapfrog.cu")
    ap.add_argument("--old", type=Path, default=None, help="an earlier B1 source as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    from b1_before_after import shapes
    from b3_pass_clocks import build_probed, read_clocks
    from b5_before_after import launch, type_leapfrog
    from starcat_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda:0")
    name, spec, img, prior, k, L, theta, p, eps, inv_mass, mask, g0 = shapes(dev, 0)[0]
    scalars = build.leapfrog_scalars(spec, prior)
    c = theta.shape[0]
    result = {"card": smi.splitlines()[0]}
    for tag, path in (("old", args.old), ("new", args.source)):
        if path is None:
            continue
        lib, sites, names, report = build_probed(path, f"b1_{tag}", ENTRY, PASSES,
                                                 ("grad_eval",), (), LEGACY)
        type_leapfrog(lib, ENTRY)
        print(f"{tag} {path}: sites {json.dumps(sites)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas ({tag}, probed copy): {line.strip()}")

        def run(lib=lib):
            launch(lib, img, k, scalars, theta, p, eps, inv_mass, mask, L, g0, entry=ENTRY)

        # a block's count follows its first chain: the later source runs
        # several chains a block, the first one
        from starcat_torch import fused_leapfrog as fl

        blocks = -(-c // fl.CHAINS_PER_BLOCK) if "col_profiles" in path.read_text() else c
        res = read_clocks(lib, run, names, sites, blocks,
                          f"{tag} {name}: {c} chains, K={k}, {spec.height}x{spec.width}, L={L}")
        result[tag] = {"source": str(path), **res}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
