"""Where one B6 trajectory spends its time, pass by pass, on the card.

    python scripts/b6_pass_clocks.py [--source PATH/fused_rhmc.cu]

Builds a copy of a B6 source (the checkout's csrc/fused_rhmc.cu by default)
with a clock64() probe around every call of a pass (under
build/kernels/variants/, with scripts/b4_before_after.py's helpers): thread
0 of every block adds the SM cycles since the previous probe to the pass
that just ended, and what runs between two passes (per-star and
per-parameter code, the matrix-vector products, the energies) to "rest".
A pass is a one-line call statement of one of its functions in PASSES
(the names of the first B6 source and of later ones); a source that lacks
one reports it as absent.  The copy runs one trajectory
at each of chip_smoke.py's two timed B6 shapes (cfg3: 4096 particles, K =
16, 6 x 4, per-chain masks; cfg1: 64 chains, K = 10, 16 x 6, shared mask);
the script prints the card, each trajectory's time with CUDA events and
each pass's share of the summed block cycles, and ends with one JSON line.
The shipped kernel is not changed.  Needs a CUDA card and nvcc.
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

# (name, the functions whose call statements are that pass, in the first
# B6 source and in later ones)
PASSES = (
    ("profiles", ("profiles",)), ("render", ("render",)),
    ("contract<kGrad>", ("contract<kGrad>",)),
    ("rebuild pair contractions", ("pair_contract<true>", "pair_contract")),
    ("sweep Fisher pairs", ("pair_contract<false>", "fisher_pairs")),
    ("assemble", ("assemble_metric",)), ("cholesky", ("cholesky",)),
    ("inverse", ("inverse",)), ("chol_solve", ("chol_solve",)), ("q field", ("q_field",)),
    ("contract<kQ>", ("contract<kQ>",)), ("phi field", ("phi_field",)),
    ("contract<kSweep>", ("contract<kSweep>",)), ("G^-1 p", ("ginv_matvec",)),
    ("metric terms", ("metric_terms",)),
)
REST = len(PASSES)
N_IDS = REST + 1

PROBE = r'''
__device__ unsigned long long b6_clocks[%d];
__device__ __forceinline__ void probe(int id) {
  __shared__ long long last;
  if (threadIdx.x == 0) {
    const long long t = clock64();
    if (id >= 0) atomicAdd(&b6_clocks[id], static_cast<unsigned long long>(t - last));
    last = t;
  }
}
''' % N_IDS

READ = r'''
extern "C" int b6_read_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, b6_clocks, sizeof(b6_clocks)));
}
extern "C" int b6_zero_clocks() {
  unsigned long long z[%d] = {};
  return static_cast<int>(cudaMemcpyToSymbol(b6_clocks, z, sizeof(z)));
}
''' % N_IDS


def _call_re(fn: str) -> re.Pattern:
    """A one-line call statement of fn, its value assigned (to a declared
    variable or not) or not, alone or in a one-line block that makes the
    pass's Work first (B6c's ``{ const Work s = make_work(P); fn(P, s);
    }``), the names qualified by B6c's ``wide::`` or not."""
    return re.compile(r"^(\s*)(?:\{ const Work s = (?:wide::)?make_work\(P\); )?"
                      r"(?:(?:(?:const\s+)?[\w:]+\s+)?\w+\s*=\s*)?(?:wide::)?" + re.escape(fn)
                      + r"\(.*\);(?: \})?\s*(?://.*)?$")


def instrumented_source(src: str) -> tuple[str, dict]:
    """The probed copy and the number of call sites of each pass."""
    if src.count("namespace {\n") != 1:
        raise RuntimeError("the source has no single anonymous namespace")
    lines = src.splitlines()
    pats = [(i, _call_re(fn)) for i, (_, fns) in enumerate(PASSES) for fn in fns]
    pats.append((REST, _call_re("hamiltonian")))
    first_build = _call_re("build_structs")
    sites = {name: 0 for name, _ in PASSES}
    out, started = [], False
    for line in lines:
        # the clocks restart at each kernel's first rebuild (B6c's wide
        # kernel has its own)
        if first_build.match(line) and (not started or "wide::build_structs(P, true)" in line):
            out.append(first_build.match(line).group(1) + "probe(-1);")
            started = True
        for pid, pat in pats:
            m = pat.match(line)
            if m:
                ind = m.group(1)
                out += [ind + f"probe({REST});", line, ind + f"probe({pid});"]
                if pid < REST:
                    sites[PASSES[pid][0]] += 1
                break
        else:
            out.append(line)
    if not started:
        raise RuntimeError("no call of build_structs to start the clocks at")
    text = "\n".join(out) + "\n"
    return text.replace("namespace {\n", "namespace {\n" + PROBE, 1) + READ, sites


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "starcat_torch" / "csrc" / "fused_rhmc.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6_pass_clocks: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from b4_before_after import build_source, launch
    from starcat_torch import build
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    text, sites = instrumented_source(args.source.read_text())
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    cu = build.BUILD_DIR / "variants" / f"b6_pass_clocks_{digest}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    lib, report = build_source(cu, cu.stem, entry="starcat_fused_rhmc")
    lib.b6_read_clocks.argtypes = [ctypes.c_void_p]
    print(f"{args.source}: call sites {json.dumps(sites)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas (probed copy): {line.strip()}")

    dev = torch.device("cuda:0")
    cfg = CONFIGS["cfg3_transdim_smc"]
    truth, image = cfg.make_data()
    img = image.to(dev)
    scalars = build.riemannian_scalars(cfg.scene, cfg.prior, 1e-3)
    result = {"card": smi.splitlines()[0], "source": str(args.source), "shapes": {}}
    for name, c, k, n_steps, fpi, per_chain, scale in (("cfg3", 4096, 16, 6, 4, True, 1.0),
                                                       ("cfg1", 64, 10, 16, 6, False, 1 / 3)):
        theta, xi, eps, mask = chip_smoke._rhmc_inputs(truth, c, k, dev, 20, per_chain)
        eps = eps * scale

        def run():
            launch(lib, img, k, n_steps, fpi, scalars, theta, xi, eps, mask, 1.0,
                   entry="starcat_fused_rhmc")

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
        print(f"{name}: {c} chains, K={k}, {n_steps} x {fpi}: {ms:.4f} ms (instrumented); "
              f"{total / c:.5g} SM cycles per block")
        for i, nm in enumerate(names):
            if nm != "rest" and sites[nm] == 0:
                continue
            print(f"  {nm}: {100 * shares[nm]:.1f}%  ({clocks[i] / c:.5g} cycles per block)")
        result["shapes"][name] = {"ms": ms, "cycles_per_block": total / c, "share": shares}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
