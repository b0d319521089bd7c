"""Where one B3 trajectory spends its time, pass by pass, on the card.

    python scripts/b3_pass_clocks.py [--source PATH/fused_rhmc_diag.cu]

Builds a copy of a B3 source (the checkout's csrc/fused_rhmc_diag.cu by
default) with a clock64() probe around every pass (under
build/kernels/variants/, with scripts/b4_before_after.py's helpers): thread
0 of every block adds the SM cycles since the previous probe to the pass
that just ended.  A pass is a one-line call statement of one of its
functions in PASSES (the names of the first B3 source and of later ones),
or, in the first source, the q field's loop, found by its text; a source
that lacks one reports it as absent.  What runs inside the trajectory's
phases between two passes (the per-star coefficients, the C tensor, the
metric, the W(wt) terms) counts as "per-star phases"; what the kernel body
runs between the phases (the momentum and position updates, the Picard
deltas, the energies) as "rest".  The copy runs one trajectory at each of
chip_smoke.py's two timed B3 shapes (cfg5: 256 chains, K = 16, 6 x 4,
per-chain masks; cfg1 diag: 128 chains, K = 10, 16 x 6, shared mask); the
script prints the card, each trajectory's time with CUDA events and each
pass's share of the summed block cycles, and ends with one JSON line.  The
shipped kernel is not changed.  Needs a CUDA card and nvcc.

:func:`instrument` is shared with scripts/b5_pass_clocks.py.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# (name, the functions whose call statements are that pass)
PASSES = (
    ("profiles", ("profiles",)), ("render", ("render",)),
    ("contract<kBuild>", ("contract<kBuild>", "contract<TR, kBuild>")),
    ("contract<kSolve>", ("contract<kSolve>", "contract<TR, kSolve>")),
    ("contract<kField>", ("contract<kField>", "contract<TR, kField>")),
    ("q field", ("q_field",)),
)
# the first source writes the q field inline in wt_terms: (text, pass) with
# the probe of the phase before the text and that of the pass after the loop
LEGACY = (
    ("  for (int pix = tid; pix < H * W; pix += kThreads) {\n    const int h = pix / W, "
     "col = pix - h * W;\n    float q = 0.0f;\n",
     "    s.fld[pix] = q * (r1 * r1);\n  }\n  __syncthreads();\n", "q field"),
)
# the kernel body's calls: the trajectory's phases, and the rest
PHASES = ("build_structs", "dh_dtheta", "diag_solve")
REST_CALLS = ("hamiltonian", "fp_delta")

PROBE = r'''
__device__ unsigned long long pass_clocks[%d];
__device__ __forceinline__ void probe(int id) {
  __shared__ long long last;
  if (threadIdx.x == 0) {
    const long long t = clock64();
    if (id >= 0) atomicAdd(&pass_clocks[id], static_cast<unsigned long long>(t - last));
    last = t;
  }
}
'''

READ = r'''
extern "C" int pass_read_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, pass_clocks, sizeof(pass_clocks)));
}
extern "C" int pass_zero_clocks() {
  unsigned long long z[%d] = {};
  return static_cast<int>(cudaMemcpyToSymbol(pass_clocks, z, sizeof(z)));
}
'''


def _call_re(fn: str) -> re.Pattern:
    """A one-line call statement of fn, its template arguments given or not:
    its value assigned or not, behind a one-line if or not."""
    return re.compile(r"^(\s*)(?:if\s*\(.*\)\s*)?(?:(?:const\s+)?(?:[\w:]+\s+)?\w+\s*=\s*)?"
                      + re.escape(fn) + r"(?:<[\w, ]*>)?\(.*\);\s*(?://.*)?$")


def instrument(src: str, passes, phases, rest_calls, legacy=()) -> tuple[str, dict, list]:
    """The probed copy of a kernel source, the number of sites of each pass
    and the names of the probe ids (the passes, "per-star phases", "rest").

    Inside the device functions each call statement of a pass is wrapped in
    probe(phase) before and probe(pass) after; in the kernel body (the
    __global__ function) each call of ``phases`` in probe(rest) and
    probe(phase), each call of ``rest_calls`` in probe(rest) on both sides;
    the clocks start before the kernel body's first such call and end,
    after a block barrier, before it writes its outputs.  ``legacy`` is a
    list of (text before, text after, pass) for a pass written inline."""
    names = [nm for nm, _ in passes] + ["per-star phases", "rest"]
    phase, rest = len(passes), len(passes) + 1
    if src.count("namespace {\n") != 1:
        raise RuntimeError("the source has no single anonymous namespace")
    sites = {nm: 0 for nm, _ in passes}
    for before, after, nm in legacy:
        if src.count(before) == 1 and src.count(after) == 1:
            src = src.replace(before, f"  probe({phase});\n" + before)
            src = src.replace(after, after + f"  probe({names.index(nm)});\n")
            sites[nm] += 1
    pass_pats = [(i, _call_re(fn)) for i, (_, fns) in enumerate(passes) for fn in fns]
    body_pats = ([(phase, _call_re(fn)) for fn in phases]
                 + [(rest, _call_re(fn)) for fn in rest_calls])
    out, in_body, started, ended = [], False, False, False
    lines = src.splitlines()
    for i, line in enumerate(lines):
        if "__global__" in line:
            in_body = True
        elif in_body and line == "}":
            in_body = False
        if in_body:
            if (not ended and started and i + 1 < len(lines) and "P.theta_out[" in lines[i + 1]
                    and "P.theta_out[" not in line):
                ind = re.match(r"\s*", line).group(0)
                out += [ind + "__syncthreads();", ind + f"probe({rest});"]
                ended = True
            for pid, pat in body_pats:
                m = pat.match(line)
                if m:
                    ind = m.group(1)
                    if not started:
                        out.append(ind + "probe(-1);")
                        started = True
                    out += [ind + f"probe({rest});", line, ind + f"probe({pid});"]
                    break
            else:
                out.append(line)
            continue
        for pid, pat in pass_pats:
            m = pat.match(line)
            if m:
                ind = m.group(1)
                out += [ind + f"probe({phase});", line, ind + f"probe({pid});"]
                sites[names[pid]] += 1
                break
        else:
            out.append(line)
    if not (started and ended):
        raise RuntimeError("no kernel-body call to start the clocks at, or no output store "
                           "to end them at")
    text = "\n".join(out) + "\n"
    n = len(names)
    return (text.replace("namespace {\n", "namespace {\n" + PROBE % n, 1) + READ % n,
            sites, names)


def build_probed(path: Path, tag: str, entry: str, passes, phases, rest_calls, legacy=()):
    """Build the probed copy of a source; returns (library, sites, names,
    the compiler's report)."""
    from b4_before_after import build_source
    from starcat_torch import build

    text, sites, names = instrument(path.read_text(), passes, phases, rest_calls, legacy)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    cu = build.BUILD_DIR / "variants" / f"{tag}_pass_clocks_{digest}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    lib, report = build_source(cu, cu.stem, entry=entry)
    lib.pass_read_clocks.argtypes = [ctypes.c_void_p]
    return lib, sites, names, report


def read_clocks(lib, run, names, sites, c: int, label: str) -> dict:
    """Zero the clocks, run one trajectory, print and return each pass's
    share of the summed block cycles."""
    import chip_smoke
    import torch

    run()
    torch.cuda.synchronize()
    if lib.pass_zero_clocks() != 0:
        raise RuntimeError("could not zero the clocks")
    ms = chip_smoke._time_ms(run, 1, warmup=0)
    clocks = (ctypes.c_ulonglong * len(names))()
    if lib.pass_read_clocks(ctypes.addressof(clocks)) != 0:
        raise RuntimeError("could not read the clocks")
    total = sum(clocks)
    shares = {nm: clocks[i] / total for i, nm in enumerate(names)}
    print(f"{label}: {ms:.4f} ms (instrumented); {total / c:.5g} SM cycles per block")
    for i, nm in enumerate(names):
        if sites.get(nm, 1) == 0:
            continue
        print(f"  {nm}: {100 * shares[nm]:.1f}%  ({clocks[i] / c:.5g} cycles per block)")
    return {"ms": ms, "cycles_per_block": total / c, "share": shares}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_rhmc_diag.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b3_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b4_before_after import launch
    from starcat_torch import build
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    entry = "starcat_fused_rhmc_diag"
    lib, sites, names, report = build_probed(args.source, "b3", entry, PASSES, PHASES,
                                             REST_CALLS, LEGACY)
    print(f"{args.source}: call sites {json.dumps(sites)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas (probed copy): {line.strip()}")

    dev = torch.device("cuda:0")
    cfg = CONFIGS["cfg5_transdim_mcmc"]
    truth, image = cfg.make_data()
    img = image.to(dev)
    scalars = build.riemannian_scalars(cfg.scene, cfg.prior, 1e-3)
    result = {"card": smi.splitlines()[0], "source": str(args.source), "shapes": {}}
    for name, c, k, n_steps, fpi, per_chain in (("cfg5", 256, 16, 6, 4, True),
                                                ("cfg1 diag", 128, 10, 16, 6, False)):
        theta, xi, eps, mask = chip_smoke._rhmc_inputs(truth, c, k, dev, 0, per_chain)

        def run():
            launch(lib, img, k, n_steps, fpi, scalars, theta, xi, eps, mask, 1.0, entry=entry)

        result["shapes"][name] = read_clocks(
            lib, run, names, sites, c, f"{name}: {c} chains, K={k}, {n_steps} x {fpi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
