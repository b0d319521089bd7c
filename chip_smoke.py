"""Smoke test of the PyTorch/CUDA port (starcat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the five
   CUDA kernels from csrc/ with nvcc, one process per source, started
   together, printing each kernel's registers and spills;
2. holds the fused leapfrog kernel (B1/B2) against its plain torch version
   on the card at the flagship shape (1024 chains, K = 10, 32x32): both
   call contracts, n_steps in {0, 1, 5} with and without an entry gradient,
   per-chain eps, a per-chain mask with a dead slot, and the gradient
   against float64; then times one L = 20 trajectory of each; then (2b),
   against float64 too, at the edges of its layout and tiles (one chain, an
   odd count, the card's SM count of chains and one more, K = 1 at 16x16,
   K = 16 at 48x48, 40x48 and 20x48, a 24x96 scene held transposed, a 96x24
   one taller than a chunk of row profiles, scattered dead slots in both
   mask forms, B2's count from the device at 0, 1 and 512), the same bits
   on a rerun and for a chain at any chain count, alone or among others,
   the launch layout (tile, warps a chain, chains a block, blocks an SM) at
   each preset shape, and B1 beside B5 at cfg0's, the trans-d hmc move's
   and the 48x48 shape (kernel time from the profiler);
3. holds the diagonal-Fisher Riemannian kernel (B3) against its plain
   version at the cfg5 shape (256 chains, K = 16, per-chain masks with dead
   slots, beta 1 and 0.3) and the cfg1 shape (128 chains, K = 10, shared
   mask), checks that a chain that overflows comes back as a solver
   failure, and times one trajectory of each shape; then, chain by chain,
   at the edges of its layout and tiles (one chain, an odd count, one star,
   the card's SM count of chains and one more, K = 16 at 48x48 and 40x48, a
   96x24 scene held transposed, scattered dead slots), the same bits for a
   chain in a launch of the SM count and of one more, on a rerun and alone
   or among others, printing the layout at both timed shapes;
4. holds the full-Fisher Riemannian kernel (B6) against its plain version,
   chain by chain, at the cfg3 shape (512 particles, K = 16, per-chain
   masks with dead slots, beta 1 and 0.3, and against float64) and the cfg1
   shape (64 chains, K = 10, shared mask), and at the edges of its launch
   layout (one chain, an odd count, K = 1, 300 chains, 48x48 with K = 16, a
   non-square 40x48 scene), checks that a chain that overflows comes back
   as a solver failure, and times one trajectory at the cfg3 shape with
   4096 particles and at the cfg1 shape, printing the launch's layout;
5. holds the crowded-field leapfrog (B5) against its plain version at the
   crowded bench shape (1024 chains, K = 50, L = 10, 128x128): shared and
   per-chain masks, with and without an entry gradient, L = 0 and 1, B2's
   runtime step count on B5 (ChEES on crowded fields), long
   trajectories and the gradient against float64, a chain that overflows,
   B5 against B1 on the flagship shape; times one trajectory of each, and
   B5 beside B1 at B1's timed shape; then ragged scenes (96x128 at K = 37,
   100x84 at K = 50), the smaller tiles (64x64 at K = 30, 20x48 at K = 7,
   32x32 at K = 20 and 128), K = 1, K = 128 at 128x128, scattered live
   stars in both mask forms, all against float64 too, the same bits on a
   rerun and for a chain alone or among others, printing the launch's
   layout at each tile;
6. holds the crowded-field diagonal-Fisher kernel (B4) against its plain
   version chain by chain at the cfg4 mutation shape (K = 64, 6 x 4,
   per-particle masks, beta 1 and 0.3 from a device scalar, and against
   float64), at K = 50 with a shared mask and at a ragged 96x128 scene
   with K = 37 (against float64 too), checks a chain that overflows, times
   one trajectory at the preset's 4096 particles, and checks and times B4
   beside B3 at B3's timed shape (cfg5);
7-10. drive each path at full width through the public API, the launch
   counts set to 0 just before each and read just after: the fixed-K path
   (cfg6_chees, B2's contract, and the HMC head, B1's); the diagonal
   Riemannian path (cfg5_transdim_mcmc and cfg1_rhmc with rhmc.metric=diag,
   shortened, B3); the full-metric path (cfg3_transdim_smc as the preset
   stands, cfg1_rhmc shortened, B6); the crowded path (cfg4_crowded at 4096
   particles for three temperature steps, B4, and head=hmc kmax=50 at 1024
   chains, 100 + 50, B5), each checked against the records' bands;
11. holds B1 as the NUTS head's leaf and ADVI's gradient at cfg2's shape
   (1024 chains, K = 10, 32x32) against its plain version: one step with
   the entry gradient and every other chain stepping backward (a negative
   per-chain eps), against float64 too, and n_steps = 0 on 1024 chains and
   on ADVI's 8 draws; times one leaf and one 8-draw gradient;
12. drives the NUTS and ADVI path through the public API, the launch counts
   set to 0 just before and read just after: cfg2_nuts at full width (1024
   chains, max_depth 8) cut to 100 + 50 transitions and cfg7_advi as the
   preset stands (3000 steps), both on B1, checked against the records;
13. durability: each of five runs at full width through the public API,
   the launch counts set to 0 just before and read just after: cfg6_chees
   (1024 chains, K = 10, 32x32, on B2) cut to 150 + 300 draws in four
   blocks, cfg3_transdim_smc as the preset stands (4096 particles, B6),
   cfg5_transdim_mcmc (256 chains, B3) cut to 60 + 40 in four blocks,
   cfg1_rhmc on the full metric (64 chains, B6's 512-thread layout) cut to
   40 + 40 in four blocks and cfg4_crowded (4096 particles, K_max 64,
   128x128, B4 with per-particle masks) cut to three temperature steps.  Each
   runs uninterrupted with a metrics stream and checkpoints, again with
   neither (unblocked), then in a process of its own that SIGKILLs itself
   from its logger (after two blocks' checkpoints; cfg3 after three
   temperature steps', cfg4 after two), and is resumed here from that
   checkpoint.  The unblocked run and the resumed draws must equal the
   uninterrupted run's bit for bit (SMC: beta, log Z and the final
   population), the killed process must return -9, and the streams must
   hold the reference's records; prints each leg's wall and the
   checkpoint's size and save time;
14. the CLI's report on the card, each in a process of its own
   (``python -m starcat_torch report --device cuda``): cfg6_chees at full
   width cut to 150 + 300 (B2) and cfg5_transdim_mcmc at full width cut to
   60 + 40 (B3).  The catalog JSON must parse and use 512 draws, and the
   sources at prevalence >= 0.5 must match the flagship truth one to one
   within 1 px, but for the truth stars the JAX package's own report at the
   same chain count misses, with no more unmatched sources than it leaves
   (REPORT_REFERENCE); prints completeness and purity by flux bin, the walls
   and the PNGs skipped for want of matplotlib;
15. a device mesh of one: a one-rank NCCL group (``file://`` rendezvous in
   a temporary directory) runs api.sample with mesh=make_mesh() for
   cfg6_chees cut as in 13 (B2) and cfg3_transdim_smc as the preset stands
   (B6, 4096 particles); each must equal the unsharded run bit for bit (the
   draws, masks, eps, log Z).  With two or more cards it also runs two NCCL
   ranks, a process each, against the same one-process runs; with one it
   says that only a world of one ran;
16. prints one JSON line with a row per kernel (launches on its paths, the
   largest error against its plain version, kernel and plain times, and the
   bound: the least time the card could take for the same work).

Every failure raises.  Exits nonzero, printing no result, without CUDA or
outside a checkout.  The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

# posterior total flux of cfg6_chees on this image, from the JAX package's
# full-length record (runs/cfg6_full_r5.json): mean 2184.8, sd 75.8
REF_TOTAL_FLUX = (2184.8, 75.8)
TOL = {"theta": 3e-4, "p": 5e-3, "u": 0.3, "grad_rel": 5e-3, "grad_f64": 0.017}
# B3 against its plain version: tests/test_pallas_rhmc_diag.py:119-126
# (theta 1e-4, p 1e-3, h 2e-3).  h0, h1 and u1 are float32 numbers of
# magnitude ~2e4 on this scene, where float32's own spacing is ~2e-3, so
# their bound is 2e-3 plus four spacings at their magnitude.
RTOL = {"theta": 1e-4, "p": 1e-3, "h": 2e-3, "resid": 1e-5}


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _compare(case: str, out, ref) -> float:
    """Kernel output against the plain version; returns the theta error."""
    th, p, u, g = out
    th_r, p_r, u_r, g_r = ref
    errs = {
        "theta": _max_err(th, th_r),
        "p": _max_err(p, p_r),
        "u": _max_err(u, u_r),
        "grad_rel": float(((g - g_r).abs() / (1.0 + g_r.abs())).max()),
    }
    for name, err in errs.items():
        if not err <= TOL[name]:
            raise AssertionError(f"{case}: {name} error {err} > {TOL[name]}")
    return errs["theta"]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _kernel_ms(fn, reps: int, name: str) -> float:
    """The device time of the kernels whose name holds ``name``, per call of
    fn, from torch.profiler (CUPTI): at small launches the host's own time
    per call exceeds the kernel's, and CUDA events around a run of calls
    would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if name in e.key:
            total += float(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0))
    if total <= 0.0:
        raise AssertionError(f"the profiler saw no kernel named {name!r}")
    return total / reps / 1e3


def check_kernel(fl, cfg, dev):
    """Phase 2: kernel against plain on the card; returns the JSON rows."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior, k = cfg.scene, cfg.prior, cfg.kmax
    c = 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    theta = truth.to(dev)[None] + 0.02 * torch.randn((c, k, 3), generator=gen, device=dev)
    p = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.002 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    inv_mass = torch.full((k, 3), 0.9, device=dev)
    mask = torch.ones(k, device=dev)
    ref = lambda th, pp, e, m, n, g: fl.fused_leapfrog_reference(  # noqa: E731
        spec, img, prior, th, pp, e, inv_mass, m, n, g)
    _, _, _, g0 = ref(theta, p, eps, mask, 0, None)
    dyn = fl.make_fused_leapfrog_dyn(spec, img, prior, k)
    err = {"static": 0.0, "dyn": 0.0}
    for n in (0, 1, 5):
        static = fl.make_fused_leapfrog(spec, img, prior, k, n)
        for grad in (None, g0):
            tag = f"n={n} grad={'in' if grad is not None else 'none'}"
            want = ref(theta, p, eps, mask, n, grad)
            err["static"] = max(err["static"], _compare(
                f"static {tag}", static(theta, p, eps, inv_mass, mask, grad=grad), want))
            err["dyn"] = max(err["dyn"], _compare(
                f"dyn {tag}", dyn(theta, p, eps, inv_mass, mask,
                                  torch.full((1,), n, dtype=torch.int32, device=dev), grad),
                want))

    # per-chain mask: slot 3 dead on every odd chain, its momentum zeroed
    mask_c = torch.ones((c, k), device=dev)
    mask_c[1::2, 3] = 0.0
    p_m = p * mask_c[..., None]
    static5 = fl.make_fused_leapfrog(spec, img, prior, k, 5)
    out = static5(theta, p_m, eps, inv_mass, mask_c)
    err["static"] = max(err["static"], _compare(
        "per-chain mask", out, ref(theta, p_m, eps, mask_c, 5, None)))
    if not torch.equal(out[0][1::2, 3], theta[1::2, 3]):
        raise AssertionError("a dead slot moved")
    if not bool((out[3][1::2, 3] == 0).all()):
        raise AssertionError("a dead slot has a nonzero gradient")

    # the gradient against float64
    _, _, _, g64 = fl.fused_leapfrog_reference(
        spec, img.double(), prior, theta.double(), p.double(), eps.double(),
        inv_mass.double(), mask.double(), 0, None)
    _, _, _, gk = fl.make_fused_leapfrog(spec, img, prior, k, 0)(theta, p, eps, inv_mass, mask)
    grad_f64 = float((gk.double() - g64).abs().max())
    if not grad_f64 <= TOL["grad_f64"]:
        raise AssertionError(f"kernel grad vs float64: {grad_f64} > {TOL['grad_f64']}")
    torch.cuda.synchronize()
    print(f"kernel vs plain (C={c}, K={k}, {spec.height}x{spec.width}): "
          f"max theta err static {err['static']:.3g}, dyn {err['dyn']:.3g}; "
          f"grad vs float64 {grad_f64:.3g}; tolerances {json.dumps(TOL)}")

    # time one L = 20 trajectory, entry gradient supplied
    L = 20
    static20 = fl.make_fused_leapfrog(spec, img, prior, k, L)
    n20 = torch.full((1,), L, dtype=torch.int32, device=dev)
    ms = {
        "static": _time_ms(lambda: static20(theta, p, eps, inv_mass, mask, grad=g0), 50),
        "dyn": _time_ms(lambda: dyn(theta, p, eps, inv_mass, mask, n20, g0), 50),
        "plain": _time_ms(lambda: ref(theta, p, eps, mask, L, g0), 10),
    }
    for name, t in ms.items():
        print(f"L={L} trajectory, {name}: {t:.4f} ms, "
              f"{c * L / (t * 1e-3):.4g} grad-evals/s")
    return err, ms


def _rhmc_inputs(truth, c, k, dev, seed, per_chain):
    """theta near the truth in the first slots (prior-like draws in the
    rest), standard-normal xi, jittered eps and the mask: per chain with
    dead slots (the trans-d head's case) or shared and all alive."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = min(truth.shape[0], k)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = truth[:n].to(dev)[None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    if k > n:
        theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
        theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.03 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    if per_chain:
        # alive counts 6..k, slot order shuffled per chain
        n_alive = torch.randint(6, k + 1, (c,), generator=gen, device=dev)
        order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
        mask = (order < n_alive[:, None]).to(torch.float32)
    else:
        mask = torch.ones(k, device=dev)
    return theta, xi, eps, mask


def _h_tol(h, spacings: int = 4) -> float:
    return RTOL["h"] + _spacings(h, spacings)


def check_rhmc_kernel(frd, rhmc_mod, cfg, dev):
    """Phase 3: B3 against its plain version on the card at the cfg5 shape
    (256 chains, K = 16, per-chain masks with dead slots, beta 1 and 0.3)
    and the diag-rhmc cfg1 shape (128 chains, K = 10, shared mask), a
    chain that overflows, and one timed trajectory of each shape.  Returns
    the largest theta error and the times."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior = cfg.scene, cfg.prior
    cases = [  # (name, chains, K, n_steps, fixed_point_iters, per-chain mask, beta)
        ("cfg5", 256, 16, 6, 4, True, 1.0),
        ("cfg5 beta=0.3", 256, 16, 6, 4, True, 0.3),
        ("cfg1", 128, 10, 16, 6, False, 1.0),
    ]
    err = 0.0
    ms = {}
    for i, (name, c, k, n_steps, fpi, per_chain, beta) in enumerate(cases):
        theta, xi, eps, mask = _rhmc_inputs(truth, c, k, dev, i, per_chain)
        fused = frd.make_fused_rhmc_diag(spec, img, prior, k, n_steps, fpi)
        plain = lambda: frd.fused_rhmc_diag_reference(  # noqa: E731
            spec, img, prior, theta, xi, eps, mask, beta, n_steps, fpi)
        out, ref = fused(theta, xi, eps, mask, beta), plain()
        errs = {nm: float((a - b).abs().max()) for nm, a, b in zip(
            ("theta", "p", "h0", "h1", "u1", "resid"), out, ref)}
        tols = dict(theta=RTOL["theta"], p=RTOL["p"], h0=_h_tol(ref[2]),
                    h1=_h_tol(ref[3]), u1=_h_tol(ref[4]), resid=RTOL["resid"])
        print(f"B3 {name} ({c} chains, K={k}, {n_steps} steps x {fpi} sweeps) vs plain: "
              f"{json.dumps(errs)}; tolerances {json.dumps(tols)}")
        for nm, e in errs.items():
            if not e <= tols[nm]:
                raise AssertionError(f"B3 {name}: {nm} error {e} > {tols[nm]}")
        err = max(err, errs["theta"])
        if per_chain:
            dead = mask == 0
            if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
                raise AssertionError(f"B3 {name}: a dead slot moved")
        if beta == 1.0:
            ms[name] = _time_ms(lambda: fused(theta, xi, eps, mask, beta), 20)
            ms[name + "_plain"] = _time_ms(plain, 3)
            print(f"B3 {name}: kernel {ms[name]:.4f} ms, plain {ms[name + '_plain']:.4f} ms "
                  "per trajectory")

    # a chain that overflows (exp(95) > float32's range): NaN residual,
    # reported by the transition as a solver failure and rejected
    theta, xi, eps, mask = _rhmc_inputs(truth, 256, 16, dev, 7, True)
    theta[0, :, 2] = 95.0
    fused = frd.make_fused_rhmc_diag(spec, img, prior, 16, 6, 4)
    out = fused(theta, xi, eps, mask)
    u = torch.zeros(256, device=dev)
    new, info = rhmc_mod.rhmc_transition(
        rhmc_mod.ChainState(theta, u, torch.zeros_like(theta)), xi,
        torch.full((256,), 0.5, device=dev), torch.full((256,), 0.01, device=dev),
        fused, torch.tensor(0.03, device=dev), mask)
    if not (bool(torch.isnan(out[5][0])) and bool(info.solver_fail[0])
            and not bool(info.accepted[0]) and torch.equal(new.theta[0], theta[0])):
        raise AssertionError(f"B3: the overflowing chain was not a solver failure "
                             f"(resid {float(out[5][0])})")
    if not bool(torch.isfinite(out[5][1:]).all()):
        raise AssertionError("B3: the overflowing chain reached another chain")
    torch.cuda.synchronize()
    print("B3 overflowing chain: resid NaN -> solver failure, rejected; "
          "the other 255 chains finite")
    return err, ms


SOLVER_TOL = 0.05  # rhmc.RHMCConfig.solver_tol: a larger residual is rejected
TIGHT = 1e-3       # chains whose fixed points converged this far


def _per_chain(d):
    return d.reshape(d.shape[0], -1).amax(1) if d.ndim > 1 else d


def _compare_chains(name, out, ref, ref64=None, h_spacings=4, p_rel=False):
    """A Riemannian kernel (B4, B6) against its plain version, chain by chain.

    * Solver failures (residual not below SOLVER_TOL, NaN included) agree
      on at least 99% of the chains: a chain at the edge of the solver's
      reach may fall either side of the bound in two float32 programs.
    * On the chains whose fixed points converged tightly in both (residual
      < TIGHT), every output is within RTOL (h: plus ``h_spacings`` float32
      spacings at its magnitude; p, with ``p_rel``, relative to 1 + |p|,
      since p = sqrt(g) xi grows with the Fisher information).
      On the looser converged chains float32 rounding is amplified by the
      chain's own trajectory; there, given a float64 run of the plain
      version, the kernel must be no farther from it than the float32
      plain version is, plus RTOL.
    Returns the largest theta error on the tight chains."""
    import torch

    rk, rr = out[5], ref[5]
    fail_k, fail_r = ~(rk < SOLVER_TOL), ~(rr < SOLVER_TOL)
    c = rk.shape[0]
    disagree = int((fail_k != fail_r).sum())
    tight = (rk < TIGHT) & (rr < TIGHT)
    names = ("theta", "p", "h0", "h1", "u1", "resid")
    tols = dict(theta=RTOL["theta"], p=RTOL["p"], h0=_h_tol(ref[2][tight], h_spacings),
                h1=_h_tol(ref[3][tight], h_spacings), u1=_h_tol(ref[4][tight], h_spacings),
                resid=RTOL["resid"])
    def dist(nm, a, b):
        d = (a - b).abs()
        return d / (1.0 + b.abs()) if (p_rel and nm == "p") else d

    errs = {nm: float(_per_chain(dist(nm, a, b))[tight].max())
            for nm, a, b in zip(names, out, ref)}
    print(f"{name}: solver failures kernel {int(fail_k.sum())}, plain {int(fail_r.sum())}, "
          f"disagreeing {disagree} of {c}; on the {int(tight.sum())} tight chains "
          f"{json.dumps(errs)}; tolerances {json.dumps(tols)}")
    if disagree > 0.01 * c:
        raise AssertionError(f"{name}: {disagree} chains' solver verdicts disagree")
    if int(tight.sum()) < 0.8 * c:
        raise AssertionError(f"{name}: only {int(tight.sum())} of {c} chains converged")
    for nm, e in errs.items():
        if not e <= tols[nm]:
            raise AssertionError(f"{name}: {nm} error {e} > {tols[nm]}")
    if ref64 is not None:
        conv = ~fail_k & ~fail_r & (ref64[5] < SOLVER_TOL)
        far = {}
        for nm, a, b, z in zip(names[:5], out, ref, ref64):
            dk = float(_per_chain(dist(nm, a.double(), z))[conv].max())
            dp = float(_per_chain(dist(nm, b.double(), z))[conv].max())
            far[nm] = (dk, dp)
            bound = dp + (_h_tol(z[conv], h_spacings) if nm in ("h0", "h1", "u1")
                          else RTOL[nm])
            if not dk <= bound:
                raise AssertionError(f"{name}: {nm} {dk} from float64 on the converged "
                                     f"chains, the plain version {dp}")
        print(f"{name} vs float64 on the {int(conv.sum())} converged chains "
              f"(kernel, plain float32): {json.dumps(far)}")
    return errs["theta"]


# B6's layout edges: (chains, K, H, W)
B6_EDGES = ((1, 16, 32, 32), (7, 16, 32, 32), (33, 1, 32, 32), (300, 10, 32, 32),
            (9, 16, 48, 48), (16, 12, 40, 48))


def _cut_inputs(h, w, k, c, dev, seed):
    """An h x w cut of the crowded image with the true stars inside it near
    their truth in the first slots (prior-like draws in the rest),
    standard-normal xi, eps 0.01 and per-chain masks with 1..k live stars."""
    import torch

    from starcat_torch.configs import CONFIGS

    cfg4 = CONFIGS["cfg4_crowded"]
    truth, image = cfg4.make_data()
    spec = cfg4.scene._replace(height=h, width=w)
    x = cfg4.scene.width * torch.sigmoid(truth[:, 0])
    y = cfg4.scene.height * torch.sigmoid(truth[:, 1])
    inside = (x < w - 2.0) & (y < h - 2.0)
    xs, ys = x[inside] / w, y[inside] / h
    cut = torch.stack([torch.log(xs / (1 - xs)), torch.log(ys / (1 - ys)),
                       truth[inside, 2]], dim=1)[:k].to(dev)
    n = min(k, cut.shape[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = cut[:n][None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
    theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    xi = torch.randn((c, k, 3), generator=gen, device=dev)
    alive = torch.randint(1, k + 1, (c,), generator=gen, device=dev)
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < alive[:, None]).to(torch.float32)
    eps = torch.full((c,), 0.01, device=dev)
    return spec, image[:h, :w].contiguous().to(dev), theta, xi, eps, mask


def check_rhmc_full_kernel(fr, rhmc_mod, cfg, dev):
    """Phase 4: B6 against its plain version on the card at the cfg3 shape
    (512 particles, K = 16, per-chain masks with dead slots, beta 1 and 0.3;
    beta 1 also against float64) and the cfg1 shape (64 chains, K = 10,
    shared mask, 16 steps x 6 sweeps, at the step the cfg1 preset adapts
    to), at the edges of its launch layout (B6_EDGES, beta 0.7), a chain
    that overflows, and one timed trajectory at the cfg3 shape with the
    preset's 4096 particles and at the cfg1 shape, with the launch's layout
    (threads a chain, blocks an SM, SMs filled).  Returns the largest theta
    error and the times."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior = cfg.scene, cfg.prior
    cases = [  # (name, chains, K, n_steps, fixed_point_iters, per-chain mask, beta)
        ("cfg3", 512, 16, 6, 4, True, 1.0),
        ("cfg3 beta=0.3", 512, 16, 6, 4, True, 0.3),
        ("cfg1", 64, 10, 16, 6, False, 1.0),
    ]
    err = 0.0
    for i, (name, c, k, n_steps, fpi, per_chain, beta) in enumerate(cases):
        theta, xi, eps, mask = _rhmc_inputs(truth, c, k, dev, 10 + i, per_chain)
        if name == "cfg1":
            eps = eps / 3.0  # the step the cfg1 preset adapts to (~0.01)
        fused = fr.make_fused_rhmc(spec, img, prior, k, n_steps, fpi)
        out = fused(theta, xi, eps, mask, torch.tensor(beta, device=dev))
        ref = fr.fused_rhmc_reference(spec, img, prior, theta, xi, eps, mask, beta,
                                      n_steps, fpi)
        ref64 = None
        if name == "cfg3":
            ref64 = fr.fused_rhmc_reference(spec, img.double(), prior, theta.double(),
                                            xi.double(), eps.double(), mask.double(),
                                            beta, n_steps, fpi)
        err = max(err, _compare_chains(f"B6 {name}", out, ref, ref64))
        if per_chain:
            # on every chain that did not blow up (a NaN metric spreads to
            # the whole chain, which the transition rejects)
            dead = (mask == 0) & (out[5] < SOLVER_TOL)[:, None]
            if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
                raise AssertionError(f"B6 {name}: a dead slot moved")

    # where the launch layout is most at risk: one chain, an odd count, one
    # star, the 256-thread layout at a moderate count, the shared-memory
    # edge of the domain (48x48, K = 16) and a non-square scene
    for i, (c, k, h, w) in enumerate(B6_EDGES):
        if (h, w) == (32, 32):
            e_spec, e_img = spec, img
            theta, xi, eps, mask = _rhmc_inputs(truth, c, k, dev, 50 + i, k >= 6)
            eps = eps / 3.0
        else:
            e_spec, e_img, theta, xi, eps, mask = _cut_inputs(h, w, k, c, dev, 50 + i)
        out = fr.make_fused_rhmc(e_spec, e_img, prior, k, 6, 4)(
            theta, xi, eps, mask, torch.tensor(0.7, device=dev))
        ref = fr.fused_rhmc_reference(e_spec, e_img, prior, theta, xi, eps, mask, 0.7, 6, 4)
        err = max(err, _compare_chains(f"B6 edge C={c} K={k} {h}x{w}", out, ref))
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = (live == 0) & (out[5] < SOLVER_TOL)[:, None]
        if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
            raise AssertionError(f"B6 edge C={c} K={k} {h}x{w}: a dead slot moved")

    ms = {}
    for name, c, k, n_steps, fpi, per_chain, scale in (("cfg3", 4096, 16, 6, 4, True, 1.0),
                                                       ("cfg1", 64, 10, 16, 6, False, 1 / 3)):
        theta, xi, eps, mask = _rhmc_inputs(truth, c, k, dev, 20, per_chain)
        eps = eps * scale
        fused = fr.make_fused_rhmc(spec, img, prior, k, n_steps, fpi)
        ms[name] = _time_ms(lambda: fused(theta, xi, eps, mask, 1.0), 3)
        ms[name + "_plain"] = _time_ms(lambda: fr.fused_rhmc_reference(
            spec, img, prior, theta, xi, eps, mask, 1.0, n_steps, fpi), 1)
        lay = fr.launch_layout(c, k, spec.height, spec.width)
        print(f"B6 {name} ({c} chains, K={k}, {n_steps} steps x {fpi} sweeps): kernel "
              f"{ms[name]:.4f} ms, plain {ms[name + '_plain']:.4f} ms per trajectory; "
              f"{lay['threads']} threads a chain, {lay['blocks_per_sm']} blocks an SM, "
              f"{lay['sms_filled']} SMs filled")

    # a chain that overflows (exp(95) > float32's range): NaN residual,
    # reported by the transition as a solver failure and rejected
    c = 64
    theta, xi, eps, mask = _rhmc_inputs(truth, c, 16, dev, 17, True)
    theta[0, :, 2] = 95.0
    fused = fr.make_fused_rhmc(spec, img, prior, 16, 6, 4)
    out = fused(theta, xi, eps / 3.0, mask)
    u = torch.zeros(c, device=dev)
    new, info = rhmc_mod.rhmc_transition(
        rhmc_mod.ChainState(theta, u, torch.zeros_like(theta)), xi,
        torch.full((c,), 0.5, device=dev), torch.full((c,), 0.01, device=dev),
        fused, torch.tensor(0.01, device=dev), mask)
    if not (bool(torch.isnan(out[5][0])) and bool(info.solver_fail[0])
            and not bool(info.accepted[0]) and torch.equal(new.theta[0], theta[0])):
        raise AssertionError(f"B6: the overflowing chain was not a solver failure "
                             f"(resid {float(out[5][0])})")
    if not bool(torch.isfinite(out[5][1:]).all()):
        raise AssertionError("B6: the overflowing chain reached another chain")
    torch.cuda.synchronize()
    print(f"B6 overflowing chain: resid NaN -> solver failure, rejected; "
          f"the other {c - 1} chains finite")
    return err, ms


# B5 and B4 hold energies of order 7e5 (the crowded field's log-likelihood),
# where one float32 spacing is 0.06: the kernels sum them in double, the
# plain version in float32, so U and h are bounded by the B1/B3 bars plus
# eight float32 spacings at their magnitude.
def _spacings(x, n: int) -> float:
    import numpy as np

    return n * float(np.spacing(np.float32(x.abs().max().item())))


def _crowded_inputs(truth, c, k, dev, seed):
    """theta near the crowded field's truth in its first slots (prior-like
    draws in the rest), standard-normal p, jittered eps."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = min(truth.shape[0], k)
    theta = torch.empty((c, k, 3), device=dev)
    theta[:, :n] = truth[:n].to(dev)[None] + 0.02 * torch.randn((c, n, 3), generator=gen, device=dev)
    if k > n:
        theta[:, n:, :2] = 2.0 * torch.randn((c, k - n, 2), generator=gen, device=dev)
        theta[:, n:, 2] = 5.0 + 0.7 * torch.randn((c, k - n), generator=gen, device=dev)
    p = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev)
    return theta, p, eps


def _b5_errors(out, want):
    th, pp, u, g = (o.double() for o in out)
    return {"theta": _max_err(th, want[0]), "p": _max_err(pp, want[1]),
            "u": _max_err(u, want[2]),
            "grad_rel": float(((g - want[3]).abs() / (1.0 + want[3].abs())).max())}


def _b5_compare(case, out, want, want64=None, kernel="B5"):
    """B5 within TOL of its plain version (U with eight float32 spacings at
    its magnitude); on a long trajectory, where the field's stiffness
    amplifies float32 rounding in both versions, a quantity off TOL passes
    if the kernel is no farther from a float64 run of the plain version
    than the float32 plain version is, plus TOL.  Returns the theta error
    and the bound on U."""
    tol = dict(TOL, u=TOL["u"] + _spacings(want[2], 8))
    errs = _b5_errors(out, want)
    far = _b5_errors(out, want64) if want64 is not None else None
    near = _b5_errors(want, want64) if want64 is not None else None
    for name, e in errs.items():
        if e <= tol[name]:
            continue
        if far is None or not far[name] <= near[name] + tol[name]:
            raise AssertionError(f"{kernel} {case}: {name} error {e} > {tol[name]}"
                                 + (f"; from float64 {far[name]}, the plain version "
                                    f"{near[name]}" if far else ""))
        print(f"{kernel} {case}: {name} {e:.3g} from the plain version; from float64 the "
              f"kernel {far[name]:.3g}, the plain version {near[name]:.3g}")
    return errs["theta"], tol["u"]


def check_b5_kernel(flc, fl, hmc_mod, cfg4, cfg6, dev):
    """Phase 5: B5 against its plain version on the card at the crowded
    bench shape (1024 chains, K = 50, L = 10, 128x128): shared and
    per-chain masks, with and without an entry gradient, L = 0 and 1; B2's
    runtime step count (ChEES) on B5 at two counts from the device; the
    gradient against float64; a chain that overflows, rejected by the HMC
    transition; B5 forced onto the flagship shape against B1, and both
    timed there on one L = 20 trajectory; one L = 10 trajectory of kernel
    and plain timed in one call.  Returns the largest theta error and the
    times."""
    import torch

    truth, image = cfg4.make_data()
    img = image.to(dev)
    spec, prior = cfg4.scene, cfg4.prior
    c, k, L = 1024, 50, 10
    theta, p, eps = _crowded_inputs(truth, c, k, dev, 30)
    eps = 0.002 * eps
    inv_mass = torch.full((k, 3), 0.9, device=dev)
    mask = torch.ones(k, device=dev)
    ref = lambda th, pp, m, n, g: fl.fused_leapfrog_reference(  # noqa: E731
        spec, img, prior, th, pp, eps, inv_mass, m, n, g)
    _, _, _, g0 = ref(theta, p, mask, 0, None)
    err = 0.0
    tol_u = 0.0

    def compare(case, out, want, want64=None):
        nonlocal err, tol_u
        e, t = _b5_compare(case, out, want, want64)
        err, tol_u = max(err, e), max(tol_u, t)

    def ref64(th, pp, m, n, g):
        return fl.fused_leapfrog_reference(
            spec, img.double(), prior, th.double(), pp.double(), eps.double(),
            inv_mass.double(), m.double(), n, None if g is None else g.double())

    for n in (0, 1, L):
        fused = flc.make_fused_leapfrog(spec, img, prior, k, n)
        for grad in (None, g0):
            tag = f"n={n} grad={'in' if grad is not None else 'none'}"
            compare(tag, fused(theta, p, eps, inv_mass, mask, grad=grad),
                    ref(theta, p, mask, n, grad),
                    ref64(theta, p, mask, n, grad) if n == L else None)
    # B2's contract on B5 (ChEES on crowded fields): the step count read from
    # a device int32, two counts
    dyn = flc.make_fused_leapfrog_dyn(spec, img, prior, k)
    n_dev = torch.zeros((1,), dtype=torch.int32, device=dev)
    for n in (3, L):
        n_dev.fill_(n)
        compare(f"dyn n={n} grad=in", dyn(theta, p, eps, inv_mass, mask, n_dev, g0),
                ref(theta, p, mask, n, g0), ref64(theta, p, mask, n, g0) if n == L else None)
    # per-chain masks: slots 47..49 dead on every odd chain, momentum zeroed
    mask_c = torch.ones((c, k), device=dev)
    mask_c[1::2, 47:] = 0.0
    p_m = p * mask_c[..., None]
    fused = flc.make_fused_leapfrog(spec, img, prior, k, L)
    out = fused(theta, p_m, eps, inv_mass, mask_c)
    compare("per-chain mask", out, ref(theta, p_m, mask_c, L, None),
            ref64(theta, p_m, mask_c, L, None))
    if not torch.equal(out[0][1::2, 47:], theta[1::2, 47:]):
        raise AssertionError("B5: a dead slot moved")
    if not bool((out[3][1::2, 47:] == 0).all()):
        raise AssertionError("B5: a dead slot has a nonzero gradient")

    # the gradient against float64, relative to its magnitude (up to 1e4 on
    # the crowded field): no farther than the float32 plain version is, plus
    # TOL["grad_rel"]
    g64 = ref64(theta, p, mask, 0, None)[3]
    _, _, _, gk = flc.make_fused_leapfrog(spec, img, prior, k, 0)(theta, p, eps, inv_mass, mask)
    grad_f64 = float(((gk.double() - g64).abs() / (1.0 + g64.abs())).max())
    grad_f64_plain = float(((g0.double() - g64).abs() / (1.0 + g64.abs())).max())
    if not grad_f64 <= grad_f64_plain + TOL["grad_rel"]:
        raise AssertionError(f"B5 grad vs float64: {grad_f64} > {grad_f64_plain} (the plain "
                             f"version's) + {TOL['grad_rel']}")

    # a chain that overflows (exp(95) > float32's range): non-finite energy,
    # rejected by the HMC transition; the other chains stay finite
    th_o = theta.clone()
    th_o[0, :, 2] = 95.0
    out = fused(th_o, p, eps, inv_mass, mask, grad=g0)
    u0 = ref(th_o, p, mask, 0, None)[2]
    new, info = hmc_mod.hmc_transition(
        hmc_mod.ChainState(th_o, u0, g0), torch.tensor(0.002, device=dev), inv_mass, mask, p,
        torch.full((c,), 0.5, device=dev), torch.full((c,), 0.01, device=dev),
        lambda th, pp, e, im, m, nn, g: fused(th, pp, e, im, m, grad=g), L)
    if bool(torch.isfinite(out[2][0])) or bool(info.accepted[0]) \
            or not torch.equal(new.theta[0], th_o[0]):
        raise AssertionError(f"B5: the overflowing chain was not rejected (u {float(out[2][0])})")
    if not bool(torch.isfinite(out[2][1:]).all()):
        raise AssertionError("B5: the overflowing chain reached another chain")

    # B5 forced onto the flagship shape, where B1's domain holds too: the
    # two agree, and both are timed on one L = 20 trajectory (B1's timed
    # shape), the measure for the choice between them by shape
    t6, i6 = cfg6.make_data()
    i6 = i6.to(dev)
    th6, p6, e6 = _crowded_inputs(t6, c, cfg6.kmax, dev, 31)
    e6 = 0.002 * e6
    im6 = torch.full((cfg6.kmax, 3), 0.9, device=dev)
    m6 = torch.ones(cfg6.kmax, device=dev)
    a = flc.make_fused_leapfrog(cfg6.scene, i6, cfg6.prior, cfg6.kmax, 5)(th6, p6, e6, im6, m6)
    b = fl.make_fused_leapfrog(cfg6.scene, i6, cfg6.prior, cfg6.kmax, 5)(th6, p6, e6, im6, m6)
    compare("flagship shape vs B1", a, b)
    g6 = b[3]
    b5_20 = flc.make_fused_leapfrog(cfg6.scene, i6, cfg6.prior, cfg6.kmax, 20)
    b1_20 = fl.make_fused_leapfrog(cfg6.scene, i6, cfg6.prior, cfg6.kmax, 20)
    flag = {"b1": _time_ms(lambda: b1_20(th6, p6, e6, im6, m6, grad=g6), 50),
            "b5": _time_ms(lambda: b5_20(th6, p6, e6, im6, m6, grad=g6), 50)}
    torch.cuda.synchronize()
    print(f"B5 vs plain (C={c}, K={k}, {spec.height}x{spec.width}, L in 0, 1, {L}): "
          f"max theta err {err:.3g}; grad vs float64 (relative) {grad_f64:.3g}, the "
          f"plain version's {grad_f64_plain:.3g}; "
          f"tolerances {json.dumps(dict(TOL, u=tol_u))}; overflowing chain rejected; "
          f"B5 on the flagship shape agrees with B1; there (C={c}, K={cfg6.kmax}, 32x32, "
          f"L=20, gradient in) B1 {flag['b1']:.4f} ms, B5 {flag['b5']:.4f} ms")

    fused = flc.make_fused_leapfrog(spec, img, prior, k, L)
    ms = {"b5": _time_ms(lambda: fused(theta, p, eps, inv_mass, mask, grad=g0), 10),
          "b5_plain": _time_ms(lambda: ref(theta, p, mask, L, g0), 2),
          "flagship_b1": flag["b1"], "flagship_b5": flag["b5"]}
    print(f"B5 L={L} trajectory ({c} chains, K={k}): kernel {ms['b5']:.4f} ms, plain "
          f"{ms['b5_plain']:.4f} ms, {c * L / (ms['b5'] * 1e-3):.4g} grad-evals/s")
    return err, ms


def _same_bits(a, b) -> bool:
    """Whether two sequences of float32 tensors hold the same bits (a NaN
    equal to itself)."""
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def check_b5_edges(flc, fl, cfg4, dev):
    """Phase 5b: B5's block GEMMs where they are most at risk, each case an
    L = 10 trajectory of 64 chains against the plain version (float64 as
    arbiter, _b5_compare), dead slots frozen with zero gradient: ragged
    scenes (96x128 at K = 37 and 100x84 at K = 50, per-chain masks with
    1..K live stars), its two smaller tiles (64x64 at K = 30, a ragged
    20x48 at K = 7, 32x32 at K = 20, and 32x32 at K = 128, more state than
    the one-warp tile has threads), one star, the largest K (128 at
    128x128), scattered live stars in both mask forms; then the same bits
    on a rerun and for a chain alone or among others; and the launch's
    layout at each tile's timed shape.  Returns the largest theta error."""
    import torch

    truth, image = cfg4.make_data()
    img = image.to(dev)
    spec, prior = cfg4.scene, cfg4.prior
    c, L = 64, 10
    err = 0.0

    def check(name, e_spec, e_img, theta, p, mask):
        k = theta.shape[1]
        live = mask if mask.ndim == 2 else mask.expand(theta.shape[0], k)
        p = p * live[..., None]
        eps = torch.full((theta.shape[0],), 0.002, device=dev)
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        fused = flc.make_fused_leapfrog(e_spec, e_img, prior, k, L)
        out = fused(theta, p, eps, inv_mass, mask)
        want = fl.fused_leapfrog_reference(e_spec, e_img, prior, theta, p, eps, inv_mass, mask,
                                           L, None)
        want64 = fl.fused_leapfrog_reference(
            e_spec, e_img.double(), prior, theta.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), L, None)
        e, _ = _b5_compare(name, out, want, want64)
        dead = live == 0
        if not torch.equal(out[0][dead], theta[dead]) or not bool((out[3][dead] == 0).all()):
            raise AssertionError(f"B5 {name}: a dead slot moved or has a gradient")
        return e, fused, (theta, p, eps, inv_mass, mask)

    for h, w, k in ((96, 128, 37), (100, 84, 50), (64, 64, 30), (20, 48, 7), (32, 32, 20),
                    (32, 32, 128)):
        e_spec, e_img, theta, xi, _, mask = _cut_inputs(h, w, k, c, dev, 70 + k)
        err = max(err, check(f"ragged {h}x{w} K={k}", e_spec, e_img, theta, xi, mask)[0])
    for k in (1, 128):
        theta, p, _ = _crowded_inputs(truth, c, k, dev, 72 + k)
        err = max(err, check(f"K={k}", spec, img, theta, p, torch.ones(k, device=dev))[0])
    theta, p, _ = _crowded_inputs(truth, c, 50, dev, 75)
    slot = torch.arange(50, device=dev)
    shared = (slot % 3 != 1).to(torch.float32)
    per_chain = ((slot[None] + torch.arange(c, device=dev)[:, None]) % 2 == 0).to(torch.float32)
    err = max(err, check("scattered, shared mask", spec, img, theta, p, shared)[0])
    e, fused, args = check("scattered, per-chain masks", spec, img, theta, p, per_chain)
    err = max(err, e)

    full = fused(*args)
    if not _same_bits(full, fused(*args)):
        raise AssertionError("B5: a rerun on the same inputs gave other bits")
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(63, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        th, pp, eps, im, m = args
        part = fused(th[sel].contiguous(), pp[sel].contiguous(), eps[sel].contiguous(), im,
                     m[sel].contiguous())
        if not _same_bits(part, [o[sel] for o in full]):
            raise AssertionError(f"B5: chains {idx[:3]}... gave other bits among other chains")
    lay = {f"{h}x{w} K={k}": flc.launch_layout(1024, k, h, w)
           for h, w, k in ((128, 128, 50), (64, 64, 30), (32, 32, 10))}
    torch.cuda.synchronize()
    print(f"B5 edges (ragged 96x128 K=37 and 100x84 K=50, 64x64 K=30, 20x48 K=7, 32x32 K=20 "
          f"and K=128, K=1, K=128, scattered live stars in both mask forms; {c} chains, "
          f"L={L}): max theta err {err:.3g}; the same bits on a rerun and for a chain alone "
          f"or among others; layout at 1024 chains (threads a chain, blocks an SM, SMs "
          f"filled): {json.dumps(lay)}")
    return err


def check_b1_edges(fl, flc, configs, dev):
    """Phase 2b: B1/B2 where its layout and tiles are most at risk, each case
    a trajectory against the plain version (float64 as arbiter,
    _b5_compare), dead slots frozen with zero gradient: one chain, an odd
    count, the card's SM count of chains and one more (the flagship scene,
    K = 10); K = 1 at 16x16 (cfg0's scene); K = 16 at 48x48, 40x48 and
    20x48 (cuts of the crowded image, per-chain masks with 1..16 live
    stars), a 24x96 scene held transposed and a 96x24 one taller than a
    chunk of row profiles; scattered dead slots in both mask forms; B2's
    step count from a device int32 at 0 and 1 (per-chain masks) and 512
    (the whole catalog).  Then the same bits on a rerun, for a chain in a
    launch of the SM count and of one more, and alone or among others; the
    launch layout (warps a chain, chains a block, blocks an SM) at each
    preset shape; and B1 beside B5 in kernel time at each preset shape in
    B1's domain: cfg0 (4 chains, K = 1, 16x16, L = 15), the trans-d hmc
    move (256 chains, K = 16, 32x32, per-chain masks, L = 6) and 48x48 at
    K = 16 (1024 chains, L = 20).  Returns the largest theta error of each
    contract and the times."""
    import torch

    cfg = configs["cfg6_chees"]
    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior = cfg.scene, cfg.prior
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(e_truth, c, k, seed):
        theta, p, eps = _crowded_inputs(e_truth, c, k, dev, seed)
        return theta, p, 0.002 * eps

    def check(name, e_spec, e_img, theta, p, eps, mask, n, dyn=False):
        k = theta.shape[1]
        live = mask if mask.ndim == 2 else mask.expand(theta.shape[0], k)
        p = p * live[..., None]
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        if dyn:
            fused = fl.make_fused_leapfrog_dyn(e_spec, e_img, prior, k)
            n_dev = torch.full((1,), n, dtype=torch.int32, device=dev)
            out = fused(theta, p, eps, inv_mass, mask, n_dev, None)
        else:
            fused = fl.make_fused_leapfrog(e_spec, e_img, prior, k, n)
            out = fused(theta, p, eps, inv_mass, mask)
        want = fl.fused_leapfrog_reference(e_spec, e_img, prior, theta, p, eps, inv_mass, mask,
                                           n, None)
        want64 = fl.fused_leapfrog_reference(
            e_spec, e_img.double(), prior, theta.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), n, None)
        e, _ = _b5_compare(name, out, want, want64, kernel="B1")
        dead = live == 0
        if not torch.equal(out[0][dead], theta[dead]) or not bool((out[3][dead] == 0).all()):
            raise AssertionError(f"B1 {name}: a dead slot moved or has a gradient")
        contract = "dyn" if dyn else "static"
        err[contract] = max(err[contract], e)

    L = 10
    names = []
    err = {"static": 0.0, "dyn": 0.0}
    for c in (1, 7, sms, sms + 1):
        theta, p, eps = inputs(truth, c, cfg.kmax, 80 + c % 97)
        names.append(f"C={c} K=10 32x32")
        check(names[-1], spec, img, theta, p, eps, torch.ones(cfg.kmax, device=dev), L)
    cfg0 = configs["cfg0_single_star"]
    t0, i0 = cfg0.make_data()
    theta, p, eps = inputs(t0, 4, 1, 81)
    names.append("C=4 K=1 16x16")
    check(names[-1], cfg0.scene, i0.to(dev), theta, p, eps, torch.ones(1, device=dev), 15)
    for i, (h, w) in enumerate(((48, 48), (40, 48), (20, 48), (24, 96), (96, 24))):
        e_spec, e_img, theta, xi, _, mask = _cut_inputs(h, w, 16, 64, dev, 82 + i)
        names.append(f"C=64 K=16 {h}x{w}" + (" (transposed)" if w > fl.MAX_COLS else ""))
        check(names[-1], e_spec, e_img, theta, xi, torch.full((64,), 0.002, device=dev),
              mask, L)
    theta, p, eps = inputs(truth, 64, cfg.kmax, 88)
    slot = torch.arange(cfg.kmax, device=dev)
    shared = (slot % 3 != 1).to(torch.float32)
    per_chain = ((slot[None] + torch.arange(64, device=dev)[:, None]) % 2 == 0).to(
        torch.float32)
    names += ["scattered dead slots, shared mask", "scattered dead slots, per-chain masks"]
    check(names[-2], spec, img, theta, p, eps, shared, L)
    check(names[-1], spec, img, theta, p, eps, per_chain, L)
    for n in (0, 1):
        names.append(f"B2 n={n} from the device, per-chain masks")
        check(names[-1], spec, img, theta, p, eps, per_chain, n, dyn=True)
    # a long count on the whole catalog, as ChEES runs it: with half the
    # stars dead the live ones are driven far, and at 512 steps float32
    # rounding grows there in every version alike (p 0.14-0.23 from float64
    # for the plain version and both B1 designs, against 1e-4 here)
    names.append("B2 n=512 from the device")
    check(names[-1], spec, img, theta, p, eps, torch.ones(cfg.kmax, device=dev), 512, dyn=True)

    # the same bits at the SM count and one more, on a rerun, alone or among others
    theta, p, eps = inputs(truth, sms + 1, cfg.kmax, 89)
    inv_mass = torch.full((cfg.kmax, 3), 0.9, device=dev)
    mask = torch.ones(cfg.kmax, device=dev)
    fused = fl.make_fused_leapfrog(spec, img, prior, cfg.kmax, L)
    narrow = fused(theta, p, eps, inv_mass, mask)
    wide = fused(theta[:sms].contiguous(), p[:sms].contiguous(), eps[:sms].contiguous(),
                 inv_mass, mask)
    if not _same_bits(wide, [o[:sms] for o in narrow]):
        raise AssertionError(f"B1: a chain gave other bits among {sms} and {sms + 1} chains")
    if not _same_bits(narrow, fused(theta, p, eps, inv_mass, mask)):
        raise AssertionError("B1: a rerun on the same inputs gave other bits")
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(sms, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), p[sel].contiguous(), eps[sel].contiguous(),
                     inv_mass, mask)
        if not _same_bits(part, [o[sel] for o in narrow]):
            raise AssertionError(f"B1: chains {idx[:3]}... gave other bits among other chains")

    # B1 beside B5 at the preset shapes in B1's domain (the flagship's in phase 5)
    cfg5 = configs["cfg5_transdim_mcmc"]
    t5, i5 = cfg5.make_data()
    cut_spec, cut_img, cut_theta, cut_xi, _, _ = _cut_inputs(48, 48, 16, 1024, dev, 90)
    shapes = []
    theta, p, eps = inputs(t0, 4, 1, 91)
    shapes.append(("cfg0", cfg0.scene, i0.to(dev), theta, p, eps, torch.ones(1, device=dev),
                   15))
    theta, xi, _, mask = _rhmc_inputs(t5, 256, 16, dev, 92, True)
    shapes.append(("trans-d hmc", cfg5.scene, i5.to(dev), theta, xi * mask[..., None],
                   torch.full((256,), 0.002, device=dev), mask, 6))
    shapes.append(("48x48 K=16", cut_spec, cut_img, cut_theta, cut_xi,
                   torch.full((1024,), 0.002, device=dev), torch.ones(16, device=dev), 20))
    times, lay = {}, {}
    for name, e_spec, e_img, theta, p, eps, mask, n in shapes:
        c, k = theta.shape[:2]
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        g = fl.fused_leapfrog_reference(e_spec, e_img, prior, theta, p, eps, inv_mass, mask, 0,
                                        None)[3]
        b1 = fl.make_fused_leapfrog(e_spec, e_img, prior, k, n)
        b5 = flc.make_fused_leapfrog(e_spec, e_img, prior, k, n)
        _b5_compare(f"{name} vs B5", b1(theta, p, eps, inv_mass, mask, grad=g),
                    b5(theta, p, eps, inv_mass, mask, grad=g), kernel="B1")
        times[name] = {
            "chains": c, "K": k, "L": n,
            "b1": _kernel_ms(lambda: b1(theta, p, eps, inv_mass, mask, grad=g), 50,
                             "fused_leapfrog_kernel"),
            "b5": _kernel_ms(lambda: b5(theta, p, eps, inv_mass, mask, grad=g), 50,
                             "fused_leapfrog_crowded_kernel")}
        lay[name] = dict(fl.launch_tile(e_spec.height, e_spec.width, k),
                         **fl.launch_layout(c, k, e_spec.height, e_spec.width))
    lay["flagship"] = dict(fl.launch_tile(32, 32, cfg.kmax),
                           **fl.launch_layout(1024, cfg.kmax, 32, 32))
    torch.cuda.synchronize()
    print(f"B1 edges ({'; '.join(names)}; L={L} but cfg0's 15 and B2's counts): max theta "
          f"err {json.dumps(err)}; the same bits among {sms} and {sms + 1} chains, on a rerun and "
          f"alone or among others")
    for name, t in times.items():
        print(f"B1 beside B5 at {name} ({t['chains']} chains, K={t['K']}, L={t['L']}, gradient "
              f"in): B1 {t['b1']:.4f} ms, B5 {t['b5']:.4f} ms of kernel time per trajectory")
    print(f"B1 layout (tile, warps a chain, chains a block, threads, blocks an SM, SMs "
          f"filled): {json.dumps(lay)}")
    return err, times


def check_b3_edges(frd, cfg, dev):
    """Phase 3b: B3 where its layout and tiles are most at risk, chain by
    chain against its plain version (_compare_chains, beta 0.7, 6 x 4):
    one chain, an odd count, one star, the card's SM count of chains and
    one more, K = 16 at 48x48 and at 40x48, a scene taller than 48 rows
    (96x24, held transposed) and scattered dead slots; a chain gives the
    same bits in a launch of the SM count and of one more (one layout,
    256 threads a chain, at every chain count), on a rerun and alone or
    among others; and the launch's layout at both timed shapes.  Returns
    the largest theta error."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior = cfg.scene, cfg.prior
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = ((1, 16, 32, 32), (7, 16, 32, 32), (33, 1, 32, 32), (sms, 10, 32, 32),
             (sms + 1, 10, 32, 32), (9, 16, 48, 48), (16, 16, 40, 48), (16, 10, 96, 24))
    err = 0.0

    def check(name, e_spec, e_img, theta, xi, eps, mask):
        c, k = theta.shape[:2]
        fused = frd.make_fused_rhmc_diag(e_spec, e_img, prior, k, 6, 4)
        out = fused(theta, xi, eps, mask, torch.tensor(0.7, device=dev))
        ref = frd.fused_rhmc_diag_reference(e_spec, e_img, prior, theta, xi, eps, mask, 0.7, 6, 4)
        e = _compare_chains(f"B3 {name}", out, ref)
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = (live == 0) & (out[5] < SOLVER_TOL)[:, None]
        if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
            raise AssertionError(f"B3 {name}: a dead slot moved")
        return e, fused, out

    for i, (c, k, h, w) in enumerate(edges):
        if (h, w) == (32, 32):
            e_spec, e_img = spec, img
            theta, xi, eps, mask = _rhmc_inputs(truth, c, k, dev, 60 + i, k >= 6)
        else:
            e_spec, e_img, theta, xi, eps, mask = _cut_inputs(h, w, k, c, dev, 60 + i)
        err = max(err, check(f"edge C={c} K={k} {h}x{w}", e_spec, e_img, theta, xi, eps,
                             mask)[0])
    # scattered dead slots: the even slots of even chains, the odd of odd ones
    theta, xi, eps, _ = _rhmc_inputs(truth, 64, 16, dev, 68, True)
    slot = torch.arange(16, device=dev)
    mask = ((slot[None] + torch.arange(64, device=dev)[:, None]) % 2 == 0).to(torch.float32)
    err = max(err, check("scattered dead slots", spec, img, theta, xi, eps, mask)[0])

    # the same bits at the SM count and one more, on a rerun, alone or among others
    theta, xi, eps, mask = _rhmc_inputs(truth, sms + 1, 10, dev, 69, False)
    fused = frd.make_fused_rhmc_diag(spec, img, prior, 10, 16, 6)
    wide = fused(theta[:sms].contiguous(), xi[:sms].contiguous(), eps[:sms].contiguous(), mask)
    narrow = fused(theta, xi, eps, mask)
    if not _same_bits(wide, [o[:sms] for o in narrow]):
        raise AssertionError(f"B3: a chain gave other bits among {sms} and {sms + 1} chains")
    if not _same_bits(narrow, fused(theta, xi, eps, mask)):
        raise AssertionError("B3: a rerun on the same inputs gave other bits")
    for idx in ([5], [0, 9, 17, 30, 41, 52, 63], list(range(sms - 1, -1, -1))):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(), mask)
        if not _same_bits(part, [o[sel] for o in wide]):
            raise AssertionError(f"B3: chains {idx[:3]}... gave other bits among other chains")
    lay = {name: frd.launch_layout(c, k, spec.height, spec.width)
           for name, c, k in (("cfg5", 256, 16), ("cfg1 diag", 128, 10))}
    torch.cuda.synchronize()
    print(f"B3 edges ({', '.join(f'C={c} K={k} {h}x{w}' for c, k, h, w in edges)}, scattered "
          f"dead slots): max theta err {err:.3g}; the same bits among {sms} and {sms + 1} "
          f"chains, on a rerun and alone or among others; "
          f"layout {json.dumps(lay)}")
    return err


def b4_inputs(truth, c, k, dev, seed, per_chain):
    """B4's inputs: theta near the crowded field's truth, standard-normal xi,
    eps 0.04-0.06 and the mask: per particle with 30..k stars alive in
    shuffled slots (cfg4's case), or shared and all alive."""
    import torch

    theta, xi, eps = _crowded_inputs(truth, c, k, dev, seed)
    eps = 0.05 * eps
    if per_chain:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        n_alive = torch.randint(min(30, k), k + 1, (c,), generator=gen, device=dev)
        order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
        mask = (order < n_alive[:, None]).to(torch.float32)
    else:
        mask = torch.ones(k, device=dev)
    return theta, xi, eps, mask


def _ragged_scene(cfg4, dev):
    """A scene that is neither square nor a multiple of B4's tiles: the
    crowded image's first 96 rows, all 128 columns, and the crowded field's
    true stars whose rows fall inside them (39; b4_inputs puts the first K
    of them near their truth)."""
    import torch

    truth, image = cfg4.make_data()
    spec = cfg4.scene._replace(height=96)
    rows = cfg4.scene.height * torch.sigmoid(truth[:, 1])
    inside = truth[rows < 94.0]
    # the same row coordinate in the cut scene: logit(y / 96)
    y = cfg4.scene.height * torch.sigmoid(inside[:, 1]) / 96.0
    inside = torch.stack([inside[:, 0], torch.log(y / (1.0 - y)), inside[:, 2]], dim=1)
    return spec, image[:96].contiguous().to(dev), inside


def check_b4_kernel(frdc, frd, rhmc_mod, cfg4, cfg5, dev):
    """Phase 6: B4 against its plain version on the card at the cfg4
    mutation shape (K = 64, 128x128, 6 steps x 4 sweeps, per-particle masks
    with 30..64 stars alive, beta 1 and 0.3 from a device scalar), chain by
    chain as for B6 with a float64 plain run as arbiter; the shared-mask
    rhmc head's shape (K = 50); a ragged scene (96x128, K = 37, per-chain
    masks, with the float64 arbiter); a chain that overflows; one trajectory at
    the preset's 4096 particles timed, with the plain version over the same
    particles in the preset's chunks of 256; B4 forced onto B3's cfg5 shape,
    checked and timed beside B3.  Returns the largest theta error and the
    times."""
    import torch

    truth, image = cfg4.make_data()
    img = image.to(dev)
    spec, prior = cfg4.scene, cfg4.prior
    n_steps, fpi = cfg4.smc.n_leapfrog, cfg4.smc.fixed_point_iters

    def inputs(c, k, seed, per_chain):
        return b4_inputs(truth, c, k, dev, seed, per_chain)

    err = 0.0
    for i, (name, c, k, per_chain, beta) in enumerate((
            ("cfg4", 128, 64, True, 1.0), ("cfg4 beta=0.3", 128, 64, True, 0.3),
            ("rhmc K=50", 64, 50, False, 1.0))):
        theta, xi, eps, mask = inputs(c, k, 40 + i, per_chain)
        fused = frdc.make_fused_rhmc_diag(spec, img, prior, k, n_steps, fpi)
        out = fused(theta, xi, eps, mask, torch.tensor(beta, device=dev))
        ref = frd.fused_rhmc_diag_reference(spec, img, prior, theta, xi, eps, mask, beta,
                                            n_steps, fpi)
        ref64 = None
        if i == 0:
            ref64 = frd.fused_rhmc_diag_reference(spec, img.double(), prior, theta.double(),
                                                  xi.double(), eps.double(), mask.double(),
                                                  beta, n_steps, fpi)
        err = max(err, _compare_chains(f"B4 {name}", out, ref, ref64, h_spacings=8,
                                       p_rel=True))
        if per_chain:
            dead = (mask == 0) & (out[5] < SOLVER_TOL)[:, None]
            if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
                raise AssertionError(f"B4 {name}: a dead slot moved")

    # ragged edges: 96x128 (rows not a multiple of 128, columns split in
    # halves), K = 37 (not a multiple of the 4- and 2-star tiles), per-chain
    # masks whose live stars are not contiguous; against float64 too
    r_spec, r_img, r_truth = _ragged_scene(cfg4, dev)
    theta, xi, eps, mask = b4_inputs(r_truth, 128, 37, dev, 45, True)
    out = frdc.make_fused_rhmc_diag(r_spec, r_img, prior, 37, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(1.0, device=dev))
    ref = frd.fused_rhmc_diag_reference(r_spec, r_img, prior, theta, xi, eps, mask, 1.0,
                                        n_steps, fpi)
    ref64 = frd.fused_rhmc_diag_reference(r_spec, r_img.double(), prior, theta.double(),
                                          xi.double(), eps.double(), mask.double(), 1.0,
                                          n_steps, fpi)
    err = max(err, _compare_chains("B4 ragged 96x128 K=37", out, ref, ref64, h_spacings=8,
                                   p_rel=True))
    dead = (mask == 0) & (out[5] < SOLVER_TOL)[:, None]
    if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
        raise AssertionError("B4 ragged: a dead slot moved")

    # a chain that overflows: NaN residual, a solver failure, rejected
    c = 64
    theta, xi, eps, mask = inputs(c, 64, 47, True)
    theta[0, :, 2] = 95.0
    fused = frdc.make_fused_rhmc_diag(spec, img, prior, 64, n_steps, fpi)
    out = fused(theta, xi, eps, mask)
    u = torch.zeros(c, device=dev)
    new, info = rhmc_mod.rhmc_transition(
        rhmc_mod.ChainState(theta, u, torch.zeros_like(theta)), xi,
        torch.full((c,), 0.5, device=dev), torch.full((c,), 0.01, device=dev),
        fused, torch.tensor(0.05, device=dev), mask)
    if not (bool(torch.isnan(out[5][0])) and bool(info.solver_fail[0])
            and not bool(info.accepted[0]) and torch.equal(new.theta[0], theta[0])):
        raise AssertionError(f"B4: the overflowing chain was not a solver failure "
                             f"(resid {float(out[5][0])})")
    if not bool(torch.isfinite(out[5][1:]).all()):
        raise AssertionError("B4: the overflowing chain reached another chain")
    torch.cuda.synchronize()
    print(f"B4 overflowing chain: resid NaN -> solver failure, rejected; "
          f"the other {c - 1} chains finite")

    p_all = cfg4.smc.n_particles
    theta, xi, eps, mask = inputs(p_all, 64, 48, True)
    fused = frdc.make_fused_rhmc_diag(spec, img, prior, 64, n_steps, fpi)
    chunk = cfg4.smc.mutation_chunk

    def plain():
        for j in range(0, p_all, chunk):
            frd.fused_rhmc_diag_reference(spec, img, prior, theta[j:j + chunk], xi[j:j + chunk],
                                          eps[j:j + chunk], mask[j:j + chunk], 1.0,
                                          n_steps, fpi)

    ms = {"b4": _time_ms(lambda: fused(theta, xi, eps, mask, 1.0), 2),
          "b4_plain": _time_ms(plain, 1, warmup=0),
          "b4_live": int(mask.sum())}  # the kernel skips dead stars
    print(f"B4 ({p_all} particles, K=64, {ms['b4_live']} live stars, {n_steps} steps x "
          f"{fpi} sweeps): kernel {ms['b4']:.4f} ms, plain {ms['b4_plain']:.4f} ms per "
          "trajectory")

    # B4 forced onto B3's timed shape (cfg5: 256 chains, K = 16, 32x32, 6 x
    # 4, per-chain masks), where B3's domain holds too: chain by chain
    # against the plain version, then B3 and B4 timed on the same inputs,
    # which decides the choice by shape
    t5, i5 = cfg5.make_data()
    i5 = i5.to(dev)
    theta, xi, eps, mask = _rhmc_inputs(t5, 256, 16, dev, 0, True)
    b4s = frdc.make_fused_rhmc_diag(cfg5.scene, i5, cfg5.prior, 16, 6, 4)
    b3s = frd.make_fused_rhmc_diag(cfg5.scene, i5, cfg5.prior, 16, 6, 4)
    ref = frd.fused_rhmc_diag_reference(cfg5.scene, i5, cfg5.prior, theta, xi, eps, mask, 1.0,
                                        6, 4)
    _compare_chains("B4 at the cfg5 shape", b4s(theta, xi, eps, mask), ref)
    ms["flagship_b3"] = _time_ms(lambda: b3s(theta, xi, eps, mask, 1.0), 20)
    ms["flagship_b4"] = _time_ms(lambda: b4s(theta, xi, eps, mask, 1.0), 20)
    print(f"at the cfg5 shape (256 chains, K=16, 32x32, 6 x 4): B3 "
          f"{ms['flagship_b3']:.4f} ms, B4 {ms['flagship_b4']:.4f} ms per trajectory")
    return err, ms


def run_slice(api, cfg, dev):
    """Phase 7: the fixed-K path at full width through the public API."""
    import dataclasses

    import numpy as np

    runs = {
        "chees": dataclasses.replace(cfg, n_warmup=100, n_samples=50),
        "hmc": dataclasses.replace(cfg, head="hmc", n_warmup=100, n_samples=50),
    }
    for head, rcfg in runs.items():
        out = api.sample(rcfg, dev, seed=1)
        summ = api.summarize_output(out)
        st = out.stats
        tf = summ["total_flux"]
        print(f"slice {head}: {rcfg.n_chains} chains, {rcfg.n_warmup} warmup + "
              f"{rcfg.n_samples} draws in {st['wall_seconds']:.3f} s, kernel "
              f"{st['kernel']} x{st['kernel_launches']}, accept {st['accept']:.3f}, "
              f"step {st['step_size']:.4g}"
              + (f", T {st['traj_length']:.4g}" if "traj_length" in st else "")
              + f"; total flux {tf['mean']:.2f} ± {tf['sd']:.2f} "
              f"(ESS {tf['ess']:.0f}, R-hat {tf['rhat']:.4f})")
        if st["kernel"] != "cuda_fused" or st["kernel_launches"] <= 0:
            raise AssertionError(f"{head} did not run through the CUDA kernel: {st}")
        want = (rcfg.n_chains, rcfg.n_samples, rcfg.kmax, 3)
        if out.thetas.shape != want or not np.isfinite(out.thetas).all():
            raise AssertionError(f"{head}: draws of shape {out.thetas.shape}, "
                                 f"finite {np.isfinite(out.thetas).all()}")
        if not 0.5 <= st["accept"] <= 0.95:
            raise AssertionError(f"{head}: mean accept {st['accept']}")
        mean, sd = REF_TOTAL_FLUX
        if not abs(tf["mean"] - mean) <= sd:
            raise AssertionError(f"{head}: total flux {tf['mean']} vs the "
                                 f"reference posterior {mean} ± {sd}")


# Posterior references on the flagship image (JAX package, full-length
# runs): cfg5_transdim_mcmc (runs/cfg5_full_r4.json): star count mean 10.15,
# sd 1.07; total flux 2185.0 +- 84.3.  cfg1_rhmc with the diagonal metric at
# 128 chains (runs/cfg1_diag128_xla_r4.json): total flux 2140.3 +- 75.0.
REF_CFG5 = {"count": (10.15, 1.07), "flux": (2185.0, 84.3)}
REF_CFG1_DIAG = {"flux": (2140.3, 75.0)}


def run_riemannian_slice(api, configs, dev):
    """Phase 8: the diagonal Riemannian path at full width through the
    public API.

    Both runs are shortened (cfg5: the preset's 400 warmup transitions from
    its prior start, then 100 draws; cfg1: 200 + 100), so their posteriors
    carry more Monte Carlo error and less burn-in than the records': the
    bands below are one posterior sd of the record (the star count's mean
    within its sd 1.07, the total flux within 84.3 and 75.0), wide enough
    for a short run and far narrower than the prior (n ~ Poisson(8), flux
    ~ 8 x 180)."""
    import dataclasses

    import numpy as np

    runs = {
        "cfg5_transdim_mcmc": dataclasses.replace(
            configs["cfg5_transdim_mcmc"], n_warmup=400, n_samples=100),
        "cfg1_rhmc diag": dataclasses.replace(
            configs["cfg1_rhmc"], n_chains=128, n_warmup=200, n_samples=100,
            rhmc=configs["cfg1_rhmc"].rhmc._replace(metric="diag")),
    }
    for name, rcfg in runs.items():
        out = api.sample(rcfg, dev, seed=1)
        summ = api.summarize_output(out)
        st = out.stats
        tf = summ["total_flux"]
        line = (f"slice {name}: {rcfg.n_chains} chains, K={rcfg.kmax}, {rcfg.n_warmup} "
                f"warmup + {rcfg.n_samples} draws in {st['wall_seconds']:.3f} s, kernel "
                f"{st['kernel']} x{st['kernel_launches']}, accept {st['accept']:.3f}, step "
                f"{st['step_size']:.4g}, divergences {st['divergences']}, solver "
                f"rejections {st['solver_rejections']}; total flux {tf['mean']:.2f} ± "
                f"{tf['sd']:.2f} (R-hat {tf['rhat']:.4f})")
        if "star_count" in summ:
            sc = summ["star_count"]
            line += (f"; star count mode {sc['mode']}, mean {sc['mean']:.3f} ± "
                     f"{sc['sd']:.3f}, trans-d accept {st['td_accept']:.4f}")
        print(line)
        if st["kernel"] != "rhmc_diag_cuda" or st["kernel_launches"] <= 0:
            raise AssertionError(f"{name} did not run through B3: {st}")
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{name}: non-finite draws")
        if not 0.5 <= st["accept"] <= 1.0:
            raise AssertionError(f"{name}: mean within-model accept {st['accept']}")
        ref = REF_CFG5 if "star_count" in summ else REF_CFG1_DIAG
        mean, sd = ref["flux"]
        if not abs(tf["mean"] - mean) <= sd:
            raise AssertionError(f"{name}: total flux {tf['mean']} vs the reference "
                                 f"posterior {mean} ± {sd}")
        if "star_count" in summ:
            mean, sd = ref["count"]
            if not abs(summ["star_count"]["mean"] - mean) <= sd:
                raise AssertionError(f"{name}: mean star count "
                                     f"{summ['star_count']['mean']} vs {mean} ± {sd}")


# Posterior bands on the flagship image for the B6 path, each spanning the
# JAX package's full-length records: cfg3_transdim_smc over four seeds
# (runs/cfg3_full_r5.json, cfg3_full_r3.json, cfg3_seed1_r4.json,
# cfg3_seed3_r5.json: 21 temperature steps each, star-count mean
# 9.37-10.05, total flux 2152-2186, sd ~82); cfg1_rhmc on the full metric
# (runs/cfg1_full_r5.json): total flux 2129.1 +- 72.3.
REF_CFG3 = {"steps": (19, 23), "count": (9.2, 10.3), "modes": (9, 10), "flux": (2169.8, 41.0)}
REF_CFG1_FULL = {"flux": (2129.1, 72.3)}


def run_b6_slice(api, configs, dev):
    """Phase 9: the full-metric path at full width through the public API:
    cfg3_transdim_smc as the preset stands (4096 particles, K_max 16,
    tempering to beta = 1, two trans-d sweeps and two B6 mutations per
    step), then cfg1_rhmc on the full metric shortened to 200 + 100
    transitions at its 64 chains.  Checks that both ran through B6, that
    the draws are finite, and that the posteriors fall in the records'
    bands (the shortened cfg1 run within one posterior sd)."""
    import dataclasses

    import numpy as np

    runs = {
        "cfg3_transdim_smc": configs["cfg3_transdim_smc"],
        "cfg1_rhmc full": dataclasses.replace(configs["cfg1_rhmc"], n_warmup=200,
                                              n_samples=100),
    }
    for name, rcfg in runs.items():
        out = api.sample(rcfg, dev, seed=0)
        summ = api.summarize_output(out)
        st = out.stats
        tf = summ["total_flux"]
        line = (f"slice {name}: kernel {st['kernel']} x{st['kernel_launches']}, "
                f"{st['wall_seconds']:.3f} s, accept {st['accept']:.3f}, step "
                f"{st['step_size']:.4g}, divergences {st['divergences']}, solver rejections "
                f"{st['solver_rejections']}; total flux {tf['mean']:.2f} ± {tf['sd']:.2f}")
        if rcfg.head == "smc":
            sc = summ["star_count"]
            line += (f"; {st['n_temp_steps']} temperature steps to beta {st['beta']:.4f}, "
                     f"logZ {st['log_z']:.3f}; star count mode {sc['mode']}, mean "
                     f"{sc['mean']:.3f} ± {sc['sd']:.3f}")
        else:
            line += f" (R-hat {tf['rhat']:.4f})"
        print(line)
        want = "rhmc_cuda" if rcfg.head == "smc" else "rhmc_full_cuda"
        if st["kernel"] != want or st["kernel_launches"] <= 0:
            raise AssertionError(f"{name} did not run through B6: {st}")
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{name}: non-finite draws")
        if rcfg.head == "smc":
            lo, hi = REF_CFG3["steps"]
            if st["beta"] != 1.0 or not lo <= st["n_temp_steps"] <= hi:
                raise AssertionError(f"cfg3: beta {st['beta']} after {st['n_temp_steps']} steps")
            lo, hi = REF_CFG3["count"]
            if not lo <= sc["mean"] <= hi or sc["mode"] not in REF_CFG3["modes"]:
                raise AssertionError(f"cfg3: star count mode {sc['mode']}, mean {sc['mean']}")
            mean, band = REF_CFG3["flux"]
        else:
            mean, band = REF_CFG1_FULL["flux"]
            if not 0.5 <= st["accept"] <= 1.0:
                raise AssertionError(f"{name}: mean accept {st['accept']}")
        if not abs(tf["mean"] - mean) <= band:
            raise AssertionError(f"{name}: total flux {tf['mean']} vs {mean} ± {band}")


# cfg4_crowded after three temperature steps in the JAX package's four
# records at P = 4096 (runs/cfg4_full_r4_metrics.jsonl and
# runs/cfg4_s{101,202,303}_metrics.jsonl): the mean and sd over the seeds of
# beta (0.01029-0.01146), log Z (7007.3-7802.1) and the mean star count
# (31.15-31.99).  The port's run must fall within 3 sd of each mean.
REF_CFG4_STEP3 = {"beta": (0.0109508, 0.000522), "log_z": (7455.92, 355.69),
                  "mean_n": (31.6735, 0.3660)}
# The crowded HMC head (head=hmc kmax=50, 1024 chains): the posterior total
# flux of a 300 + 500 run on the plain trajectory on the card (PERF.md, the
# crowded HMC head); the shortened run must come within a quarter sd of it.
REF_CROWDED_HMC_FLUX = (9616.29, 198.6)


def run_crowded_slice(api, configs, dev):
    """Phase 10: the crowded field at full width through the public API:
    cfg4_crowded (4096 particles, K_max 64, 128x128, twelve residual-birth
    sweeps and two B4 mutations per step) for three temperature steps
    (smc.max_steps cut from 250), then the HMC head on the same scene at
    the true star count (head=hmc kmax=50, 1024 chains, B5) shortened to
    100 + 50 transitions.  Checks that cfg4 ran through B4 with beta, log Z
    and the mean star count at step 3 within the records' spread over
    seeds, and that the HMC head ran through B5 with finite draws whose
    total flux is within a quarter sd of the plain trajectory's long run."""
    import numpy as np

    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(configs["cfg4_crowded"], {"smc.max_steps": 3})
    out = api.sample(cfg, dev, seed=0)
    st = out.stats
    sc = api.summarize_output(out)["star_count"]
    print(f"slice cfg4_crowded: {cfg.smc.n_particles} particles, K_max {cfg.kmax}, "
          f"{st['n_temp_steps']} temperature steps in {st['wall_seconds']:.3f} s, kernel "
          f"{st['kernel']} ({st['trajectory_kernel']}) x{st['kernel_launches']}, beta "
          f"{st['beta']:.5f}, log Z {st['log_z']:.2f}, accept {st['accept']:.3f}, step "
          f"{st['step_size']:.4g}, solver rejections {st['solver_rejections']}; star count "
          f"mean {sc['mean']:.3f}; records at step 3 (mean, sd): "
          f"{json.dumps(REF_CFG4_STEP3)}")
    if st["trajectory_kernel"] != "B4" or st["kernel_launches"] <= 0:
        raise AssertionError(f"cfg4 did not run through B4: {st}")
    if st["n_temp_steps"] != 3 or not np.isfinite(out.thetas).all():
        raise AssertionError(f"cfg4: {st['n_temp_steps']} steps, finite "
                             f"{np.isfinite(out.thetas).all()}")
    for name, got in (("beta", st["beta"]), ("log_z", st["log_z"]), ("mean_n", sc["mean"])):
        mean, sd = REF_CFG4_STEP3[name]
        if not abs(got - mean) <= 3.0 * sd:
            raise AssertionError(f"cfg4: {name} {got} after 3 steps, records {mean} ± {sd}")

    cfg = apply_overrides(configs["cfg4_crowded"], {
        "head": "hmc", "kmax": 50, "n_chains": 1024, "n_warmup": 100, "n_samples": 50})
    out = api.sample(cfg, dev, seed=1)
    st = out.stats
    tf = api.summarize_output(out)["total_flux"]
    truth = float(np.sum(st["truth"]["f"]))
    print(f"slice cfg4_crowded head=hmc kmax=50: {cfg.n_chains} chains, {cfg.n_warmup} "
          f"warmup + {cfg.n_samples} draws in {st['wall_seconds']:.3f} s, kernel "
          f"{st['kernel']} ({st['trajectory_kernel']}) x{st['kernel_launches']}, accept "
          f"{st['accept']:.3f}, step {st['step_size']:.4g}; total flux {tf['mean']:.2f} ± "
          f"{tf['sd']:.2f} (R-hat {tf['rhat']:.4f}), truth {truth:.2f}")
    if st["trajectory_kernel"] != "B5" or st["kernel_launches"] <= 0:
        raise AssertionError(f"the crowded HMC head did not run through B5: {st}")
    if not np.isfinite(out.thetas).all() or not 0.5 <= st["accept"] <= 0.99:
        raise AssertionError(f"crowded hmc: accept {st['accept']}, finite "
                             f"{np.isfinite(out.thetas).all()}")
    mean, sd = REF_CROWDED_HMC_FLUX
    if not abs(tf["mean"] - mean) <= 0.25 * sd:
        raise AssertionError(f"crowded hmc: total flux {tf['mean']} vs the plain "
                             f"trajectory's {mean} ± {sd}")


def check_nuts_advi_kernel(fl, cfg, dev):
    """Phase 11: B1 as the NUTS leaf (one step, entry gradient in, eps signed
    per chain) and as ADVI's gradient (n_steps = 0) at cfg2's shape, against
    the plain version and the leaf against float64; returns the largest
    theta error and the times of a leaf and an 8-draw gradient."""
    import torch

    truth, image = cfg.make_data()
    img = image.to(dev)
    spec, prior, k, c = cfg.scene, cfg.prior, cfg.kmax, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    theta = truth.to(dev)[None] + 0.02 * torch.randn((c, k, 3), generator=gen, device=dev)
    p = torch.randn((c, k, 3), generator=gen, device=dev)
    eps = 0.0135 * (0.8 + 0.4 * torch.rand((c,), generator=gen, device=dev))
    eps[1::2] *= -1.0        # every other chain builds a backward subtree
    inv_mass = torch.full((k, 3), 0.02, device=dev)
    mask = torch.ones(k, device=dev)
    ref = lambda th, pp, e, n, g: fl.fused_leapfrog_reference(  # noqa: E731
        spec, img, prior, th, pp, e, inv_mass, mask, n, g)
    g0 = ref(theta, p, eps, 0, None)[3]
    leaf = fl.make_fused_leapfrog(spec, img, prior, k, 1)
    out = leaf(theta, p, eps, inv_mass, mask, grad=g0)
    want = ref(theta, p, eps, 1, g0)
    err = _compare("leaf, signed eps", out, want)
    want64 = fl.fused_leapfrog_reference(spec, img.double(), prior, theta.double(),
                                         p.double(), eps.double(), inv_mass.double(),
                                         mask.double(), 1, g0.double())
    far, near = (_max_err(x[0].double(), want64[0]) for x in (out, want))
    if not far <= near + TOL["theta"]:
        raise AssertionError(f"leaf vs float64: theta {far}, the plain version's {near}")
    if not float(((out[0] - theta)[1::2] * p[1::2]).sum()) < 0:
        raise AssertionError("the backward chains did not step against their momentum")
    zero = fl.make_fused_leapfrog(spec, img, prior, k, 0)
    for n in (c, 8):
        got = zero(theta[:n], p[:n], eps[:n], inv_mass, mask)
        err = max(err, _compare(f"n_steps=0, {n} chains", got,
                                ref(theta[:n], p[:n], eps[:n], 0, None)))
        if not (torch.equal(got[0], theta[:n]) and torch.equal(got[1], p[:n])):
            raise AssertionError("n_steps=0 changed theta or p")
    draws = (theta[:8].contiguous(), torch.zeros_like(theta[:8]))
    ms = {"leaf": _kernel_ms(lambda: leaf(theta, p, eps, inv_mass, mask, grad=g0), 200,
                             "fused_leapfrog_kernel"),
          "leaf_plain": _time_ms(lambda: ref(theta, p, eps, 1, g0), 20),
          "grad8": _kernel_ms(lambda: zero(*draws, 0.0, inv_mass, mask), 200,
                              "fused_leapfrog_kernel"),
          "grad8_plain": _time_ms(lambda: ref(*draws, 0.0, 0, None), 20)}
    torch.cuda.synchronize()
    print(f"B1 as the NUTS leaf (C={c}, K={k}, {spec.height}x{spec.width}, L=1, eps signed "
          f"per chain) and ADVI's gradient (n_steps=0, {c} and 8 chains): max theta err "
          f"{err:.3g}; leaf theta vs float64 {far:.3g} (plain {near:.3g}); leaf {ms['leaf']:.5f} "
          f"ms of kernel time, plain {ms['leaf_plain']:.4f} ms; 8-draw gradient "
          f"{ms['grad8']:.5f} ms, plain {ms['grad8_plain']:.4f} ms")
    return err, ms


# Posterior references on the flagship image: cfg2_nuts from the JAX
# package's full-length record (runs/cfg2_full_r4.json): total flux 2170.1
# +- 79.0; cfg7_advi's band from the JAX package's seeds 0-3 (PERF.md §2):
# the mean +- 3 sd over seeds of the total flux and of the ELBO.
REF_CFG2_FLUX = (2170.1, 79.0)
ADVI_BAND = {"total_flux": (1995.7, 2283.5), "elbo": (19021.9, 19056.4)}


def run_nuts_advi_slice(api, configs, dev):
    """Phase 12: cfg2_nuts at full width (1024 chains, max_depth 8), cut to
    100 + 50 transitions, and cfg7_advi as the preset stands, through the
    public API.  Checks that each ran through B1 with finite draws, NUTS's
    accept in 0.5-0.95 and total flux within one sd of the record, ADVI's
    total flux and ELBO inside the band; returns the leaves per transition."""
    import numpy as np

    from starcat_torch.configs import apply_overrides

    cfg = apply_overrides(configs["cfg2_nuts"], {"n_warmup": 100, "n_samples": 50})
    out = api.sample(cfg, dev, seed=1)
    st = out.stats
    tf = api.summarize_output(out)["total_flux"]
    leaves = st["kernel_launches"] / (cfg.n_warmup + cfg.n_samples)
    print(f"slice cfg2_nuts: {cfg.n_chains} chains, max depth {cfg.nuts.max_depth}, "
          f"{cfg.n_warmup} warmup + {cfg.n_samples} draws in {st['wall_seconds']:.3f} s, kernel "
          f"{st['kernel']} ({st['trajectory_kernel']}) x{st['kernel_launches']} ({leaves:.1f} "
          f"leaves a transition), accept {st['accept']:.3f}, step {st['step_size']:.4g}, "
          f"divergences {st['divergences']}; total flux {tf['mean']:.2f} ± {tf['sd']:.2f} "
          f"(R-hat {tf['rhat']:.4f}); record {REF_CFG2_FLUX}")
    if st["trajectory_kernel"] != "B1" or st["kernel_launches"] <= 0:
        raise AssertionError(f"nuts did not run through B1: {st}")
    want = (cfg.n_chains, cfg.n_samples, cfg.kmax, 3)
    if out.thetas.shape != want or not np.isfinite(out.thetas).all():
        raise AssertionError(f"nuts: draws of shape {out.thetas.shape}, finite "
                             f"{np.isfinite(out.thetas).all()}")
    if not 0.5 <= st["accept"] <= 0.95:
        raise AssertionError(f"nuts: mean accept {st['accept']}")
    mean, sd = REF_CFG2_FLUX
    if not abs(tf["mean"] - mean) <= sd:
        raise AssertionError(f"nuts: total flux {tf['mean']} vs the record {mean} ± {sd}")

    cfg = configs["cfg7_advi"]
    out = api.sample(cfg, dev, seed=0)
    st = out.stats
    got = {"total_flux": api.summarize_output(out)["total_flux"]["mean"], "elbo": st["elbo"]}
    print(f"slice cfg7_advi: {st['family']}, {cfg.advi.n_steps} steps of {cfg.advi.n_mc} draws "
          f"in {st['wall_seconds']:.3f} s, kernel {st['kernel']} ({st['trajectory_kernel']}) "
          f"x{st['kernel_launches']}; total flux {got['total_flux']:.2f}, ELBO "
          f"{got['elbo']:.2f}; band {json.dumps(ADVI_BAND)}")
    if st["trajectory_kernel"] != "B1" or st["kernel_launches"] != cfg.advi.n_steps:
        raise AssertionError(f"advi did not take its gradients from B1: {st}")
    if out.thetas.shape != (api.ADVI_DRAWS, 1, cfg.kmax, 3) or not np.isfinite(out.thetas).all():
        raise AssertionError(f"advi: draws of shape {out.thetas.shape}")
    for name, (lo, hi) in ADVI_BAND.items():
        if not lo <= got[name] <= hi:
            raise AssertionError(f"advi: {name} {got[name]} outside [{lo}, {hi}]")
    return leaves


# Phase 13.  Each case: the preset, its cut, the seed, and the record at
# which the killed process SIGKILLs itself (a head logs a block or step
# before it checkpoints it, so the third block's record leaves two blocks
# saved and the fourth step's record three steps).
DURABILITY = {
    "cfg6_chees": ({"n_warmup": 150, "n_samples": 300}, 1, "sampling_block", 3),
    "cfg3_transdim_smc": ({}, 0, "smc_temperature_step", 4),
    "cfg5_transdim_mcmc": ({"n_warmup": 60, "n_samples": 40}, 1, "sampling_block", 3),
    "cfg1_rhmc": ({"n_warmup": 40, "n_samples": 40}, 0, "sampling_block", 3),
    "cfg4_crowded": ({"smc.max_steps": 3}, 0, "smc_temperature_step", 3),
}
# the records each uninterrupted stream must hold: (event, count); None
# counts the temperature steps the run took
DURABILITY_EVENTS = {
    "cfg6_chees": (("warmup_phase", 3), ("warmup_complete", 1), ("sampling_block", 4),
                   ("run_complete", 1)),
    "cfg3_transdim_smc": (("smc_temperature_step", None), ("run_complete", 1)),
    "cfg5_transdim_mcmc": (("warmup_window", 4), ("warmup_complete", 1),
                           ("sampling_block", 4), ("run_complete", 1)),
    "cfg1_rhmc": (("warmup_phase", 3), ("sampling_block", 4), ("run_complete", 1)),
    "cfg4_crowded": (("smc_temperature_step", None), ("run_complete", 1)),
}
DURABILITY_DIR = Path(__file__).resolve().parent / "build" / "durability"


def _durability_cfg(configs, case):
    from starcat_torch.configs import apply_overrides

    over, seed, _, _ = DURABILITY[case]
    return apply_overrides(configs[case], over), seed


def durability_worker(case: str, ckpt: str, metrics: str, device: str) -> int:
    """The killed leg of phase 13, in a process of its own: the case's run
    with checkpoints and a metrics stream whose logger SIGKILLs the process
    at the case's record."""
    from starcat_torch import api
    from starcat_torch import metrics as tm
    from starcat_torch.configs import CONFIGS

    cfg, seed = _durability_cfg(CONFIGS, case)
    _, _, event, n = DURABILITY[case]
    log, seen = tm.MetricsLogger.log, []

    def log_then_die(self, ev, **kw):
        log(self, ev, **kw)
        seen.append(ev)
        if seen.count(event) == n:
            os.kill(os.getpid(), signal.SIGKILL)

    tm.MetricsLogger.log = log_then_die
    api.sample(cfg, device, seed=seed, metrics_path=metrics, checkpoint_path=ckpt)
    print(f"durability worker {case}: not killed", file=sys.stderr)
    return 3


def timed_saves(modules):
    """Wrap each module's save_state so that every save is timed; returns
    the list the times (ms) go into and a function that undoes the wrap."""
    times, saved = [], {m: m.save_state for m in modules}

    def wrap(save):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            save(*args, **kw)
            times.append(1e3 * (time.perf_counter() - t0))
        return timed

    for m, save in saved.items():
        m.save_state = wrap(save)

    def undo():
        for m, save in saved.items():
            m.save_state = save
    return times, undo


def _outputs(out):
    """The arrays a resumed run must reproduce: the draws (and per-draw
    masks), or SMC's final population, beta and log Z."""
    import numpy as np

    if out.config.head == "smc":
        return {"theta": out.thetas, "mask": out.masks,
                "beta": np.float32(out.stats["beta"]), "log_z": np.float32(out.stats["log_z"])}
    got = {"thetas": out.thetas}
    if out.masks.ndim == 3:
        got["masks"] = out.masks
    return got


def _same_bits_or_raise(case, what, got, want):
    import numpy as np

    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or not np.array_equal(g, w):
            diff = (float(np.nanmax(np.abs(g.astype(np.float64) - w)))
                    if g.shape == w.shape else None)
            raise AssertionError(f"durability {case}: {what}: {key} differs from the "
                                 f"uninterrupted run ({g.shape} vs {w.shape}, max |diff| {diff})")


def run_durability(api, configs, dev):
    """Phase 13 (see the module docstring).  Returns the launches of each
    kernel counter over the phase's in-process runs."""
    import numpy as np
    import torch

    from starcat_torch import chees, driver, smc, transdim_mcmc
    from starcat_torch import fused_leapfrog as fl
    from starcat_torch import fused_rhmc as fr
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch import fused_rhmc_diag_crowded as frdc

    shutil.rmtree(DURABILITY_DIR, ignore_errors=True)
    DURABILITY_DIR.mkdir(parents=True)
    fl.reset_launch_counts()
    frd.reset_launch_counts()
    fr.reset_launch_counts()
    frdc.reset_launch_counts()
    for case in DURABILITY:
        cfg, seed = _durability_cfg(configs, case)
        _, _, event, n_kill = DURABILITY[case]
        ck_a, mp_a = DURABILITY_DIR / f"{case}.ck", DURABILITY_DIR / f"{case}.jsonl"
        ck_k, mp_k = DURABILITY_DIR / f"{case}_killed.ck", DURABILITY_DIR / f"{case}_killed.jsonl"

        times, undo = timed_saves((driver, chees, transdim_mcmc, smc))
        t0 = time.perf_counter()
        full = api.sample(cfg, dev, seed=seed, metrics_path=str(mp_a), checkpoint_path=str(ck_a))
        wall_full = time.perf_counter() - t0
        undo()
        want = _outputs(full)
        t0 = time.perf_counter()
        plain = api.sample(cfg, dev, seed=seed)
        wall_plain = time.perf_counter() - t0
        _same_bits_or_raise(case, "the unblocked run without checkpoints", _outputs(plain), want)

        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--durability-worker",
                            case, str(ck_k), str(mp_k), str(dev)], capture_output=True, text=True,
                           timeout=900)
        wall_killed = time.perf_counter() - t0
        if r.returncode != -signal.SIGKILL:
            raise AssertionError(f"durability {case}: the killed process returned "
                                 f"{r.returncode}, not -9:\n{r.stderr[-3000:]}")
        saved = torch.load(ck_k, weights_only=True)
        done = int(saved["state.n_steps"]) if cfg.head == "smc" else saved["done"]
        t0 = time.perf_counter()
        resumed = api.sample(cfg, dev, seed=seed, checkpoint_path=str(ck_k), resume=True)
        wall_resumed = time.perf_counter() - t0
        if cfg.head == "smc":
            expect_done, rest = n_kill - 1, want
        else:
            expect_done = 2 * (cfg.n_samples // 4)
            rest = {k: v[:, done:] for k, v in want.items()}
        if done != expect_done:
            raise AssertionError(f"durability {case}: the killed run's checkpoint holds "
                                 f"{done}, not {expect_done}")
        _same_bits_or_raise(case, f"the run resumed at {done}", _outputs(resumed), rest)

        events = [json.loads(line)["event"] for line in mp_a.read_text().splitlines()]
        for ev, count in DURABILITY_EVENTS[case]:
            count = full.stats["n_temp_steps"] if count is None else count
            if events.count(ev) != count:
                raise AssertionError(f"durability {case}: {events.count(ev)} {ev} records, "
                                     f"not {count}: {events}")
        if events[-1] != "run_complete":
            raise AssertionError(f"durability {case}: the stream ends with {events[-1]}")
        if not np.isfinite(full.thetas).all():
            raise AssertionError(f"durability {case}: non-finite draws")
        tf = api.summarize_output(full)["total_flux"]
        print(f"durability {case}: {cfg.n_chains if cfg.head != 'smc' else cfg.smc.n_particles} "
              f"{'particles' if cfg.head == 'smc' else 'chains'}, kernel {full.stats['kernel']} "
              f"({full.stats['trajectory_kernel']}); uninterrupted with checkpoints and "
              f"metrics {wall_full:.3f} s ({len(times)} saves, {len(events)} records), "
              f"unblocked without {wall_plain:.3f} s (same bits), killed process "
              f"{wall_killed:.3f} s (returned {r.returncode} at {event} {n_kill}, checkpoint "
              f"at {done}), resumed {wall_resumed:.3f} s (same bits); checkpoint "
              f"{os.path.getsize(ck_a)} bytes, save median {float(np.median(times)):.3f} ms, "
              f"max {max(times):.3f} ms; total flux {tf['mean']:.2f} ± {tf['sd']:.2f}")
    return {"dyn": fl.DYN_LAUNCHES, "static": fl.STATIC_LAUNCHES, "b3": frd.LAUNCHES,
            "b6": fr.LAUNCHES, "b4": frdc.LAUNCHES}


# Phase 14.  The report runs: the preset, its cut and seed, and the kernel
# it must run on, whose row of the kernels line its launches go to.
#
# REPORT_REFERENCE is the JAX package's own report on the same scene, seed,
# cut and chain count, on the CPU:
#     JAX_PLATFORMS=cpu python -m starcat report --config NAME --seed 1 \
#         --out-prefix P n_warmup=W n_samples=S
# its catalog read by scripts/report_truth_match_torch.py (PERF.md §6).
# For each preset: the truth stars (by index into the truth catalog) that
# no source at prevalence >= 0.5 matches within 1 px, and how many such
# sources match no truth star.  Both presets miss the same three: star 1
# (flux 9.6 on a background of 10 a pixel), star 4 (0.96 px from the
# brighter star 6, condensed with it into one source) and star 5 (flux
# 86).  cfg6's two unmatched sources are a source 1.37 px from star 5 and
# one at (4.1, 1.9), flux 78, where the truth has no star.  The port must
# match every other truth star one to one, and may leave no more sources
# unmatched than the reference does.
REPORT = {
    "cfg6_chees": ({"n_warmup": 150, "n_samples": 300}, 1, "B2"),
    "cfg5_transdim_mcmc": ({"n_warmup": 60, "n_samples": 40}, 1, "B3"),
}
REPORT_COUNTER = {"B2": "dyn", "B3": "b3"}
REPORT_REFERENCE: dict[str, tuple[tuple[int, ...], int]] = {
    "cfg6_chees": ((1, 4, 5), 2),
    "cfg5_transdim_mcmc": ((1, 4, 5), 0),
}
REPORT_DIR = Path(__file__).resolve().parent / "build" / "report"


def run_report(configs, dev):
    """Phase 14 (see the module docstring).  Returns the launches of each
    kernel counter, as each run's stats count them."""
    import numpy as np

    from starcat_torch.catalogs import match_catalogs
    from starcat_torch.potential import constrain

    shutil.rmtree(REPORT_DIR, ignore_errors=True)
    REPORT_DIR.mkdir(parents=True)
    launches = {}
    for name, (over, seed, kernel) in REPORT.items():
        cfg = configs[name]
        prefix = REPORT_DIR / name
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "starcat_torch", "report", "--config", name, "--device",
             str(dev), "--seed", str(seed), "--out-prefix", str(prefix),
             *(f"{k}={v}" for k, v in over.items())],
            capture_output=True, text=True, timeout=600,
            cwd=str(Path(__file__).resolve().parent))
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"report {name}: returned {r.returncode}:\n{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        missing = {"config", "plots", "summary", "condensed_sources"} - set(rec)
        if missing:
            raise AssertionError(f"report {name}: the printed line lacks {sorted(missing)}")
        cat = json.loads(Path(f"{prefix}_catalog.json").read_text())
        if cat["n_draws_used"] != 512:
            raise AssertionError(f"report {name}: {cat['n_draws_used']} draws used, not 512")
        truth_theta, _ = cfg.make_data()
        truth = np.stack([t.numpy() for t in constrain(truth_theta, cfg.scene)], axis=1)
        solid = np.array([[c["x"], c["y"], c["flux"]] for c in cat["condensed"]
                          if c["prevalence"] >= 0.5]).reshape(-1, 3)
        pairs, un_truth, un_solid = match_catalogs(truth, solid, 1.0)
        missed, n_spurious = REPORT_REFERENCE[name]
        if not set(un_truth.tolist()) <= set(missed) or len(un_solid) > n_spurious:
            raise AssertionError(
                f"report {name}: {len(solid)} sources at prevalence >= 0.5 match "
                f"{len(pairs)} of {len(truth)} truth stars within 1 px; truth unmatched "
                f"{un_truth.tolist()}, sources unmatched {solid[un_solid].tolist()} (the "
                f"JAX package's report: truth unmatched {list(missed)}, {n_spurious} "
                "sources unmatched)")
        st = rec["stats"]
        if st["trajectory_kernel"] != kernel or st["kernel_launches"] <= 0:
            raise AssertionError(f"report {name}: {st['kernel_launches']} launches of "
                                 f"{st['trajectory_kernel']}, expected {kernel}")
        counter = REPORT_COUNTER[kernel]
        launches[counter] = launches.get(counter, 0) + st["kernel_launches"]
        cp = cat["completeness_purity"]
        skipped = rec.get("skipped")
        print(f"report {name}: {wall:.3f} s wall (run {st['wall_seconds']:.3f} s, kernel "
              f"{st['trajectory_kernel']}, {st['kernel_launches']} launches); "
              f"{cat['n_condensed_ge_half']} sources at prevalence >= 0.5 match "
              f"{len(pairs)} of {len(truth)} truth stars (unmatched truth "
              f"{un_truth.tolist()}, {len(un_solid)} sources unmatched); flux bins {[round(b, 1) for b in cp['flux_bins']]}, "
              f"completeness {cp['completeness']}, purity {cp['purity']}; PNGs "
              + (f"skipped ({skipped['reason']}): {[Path(q).name for q in skipped['plots']]}"
                 if skipped else f"written: {[Path(q).name for q in rec['plots'][:-1]]}"))
    return launches


# Phase 15.  Each case: the preset, its cut and seed, and the kernel counter
# its launches go to.
MESH = {
    "cfg6_chees": ({"n_warmup": 150, "n_samples": 300}, 1, "dyn"),
    "cfg3_transdim_smc": ({}, 0, "b6"),
}


def _mesh_outputs(out):
    """What a sharded run must reproduce: the draws, the masks, eps and, for
    SMC, log Z and beta."""
    import numpy as np

    got = {"thetas": out.thetas, "masks": out.masks,
           "step_size": np.float64(out.stats["step_size"])}
    if out.config.head == "smc":
        got.update(log_z=np.float64(out.stats["log_z"]), beta=np.float64(out.stats["beta"]))
    return got


def mesh_worker(case: str, rank: str, world: str, init_file: str, out: str) -> int:
    """One rank of phase 15's multi-card leg, on card ``rank``: the case's run
    under the group's mesh, its outputs saved to OUT.RANK.npz."""
    import numpy as np

    from starcat_torch import api, dist
    from starcat_torch.configs import CONFIGS, apply_overrides

    over, seed, _ = MESH[case]
    dist.init_distributed(f"cuda:{rank}", init_method=f"file://{init_file}",
                          world_size=int(world), rank=int(rank))
    mesh = dist.make_mesh()
    res = api.sample(apply_overrides(CONFIGS[case], over), mesh.device, seed=seed, mesh=mesh)
    np.savez(f"{out}.{rank}.npz", **_mesh_outputs(res))
    import torch.distributed as tdist

    tdist.destroy_process_group()
    return 0


def run_mesh(api, configs, dev):
    """Phase 15 (see the module docstring).  Returns the launches of each
    kernel counter over the sharded runs."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from starcat_torch import dist
    from starcat_torch import fused_leapfrog as fl
    from starcat_torch import fused_rhmc as fr
    from starcat_torch.configs import apply_overrides

    launches = {"dyn": 0, "b6": 0}
    singles = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_distributed(dev, init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            mesh = dist.make_mesh(dev)
            print(f"mesh: backend {tdist.get_backend()}, world {mesh.world}, rank "
                  f"{mesh.rank}, {mesh.device}")
            for case, (over, seed, counter) in MESH.items():
                cfg = apply_overrides(configs[case], over)
                t0 = time.perf_counter()
                single = api.sample(cfg, dev, seed=seed)
                wall_single = time.perf_counter() - t0
                singles[case] = _mesh_outputs(single)
                fl.reset_launch_counts()
                fr.reset_launch_counts()
                t0 = time.perf_counter()
                sharded = api.sample(cfg, dev, seed=seed, mesh=mesh)
                torch.cuda.synchronize()
                wall_mesh = time.perf_counter() - t0
                n = {"dyn": fl.DYN_LAUNCHES, "b6": fr.LAUNCHES}[counter]
                if n <= 0:
                    raise AssertionError(f"mesh {case}: {counter} never launched")
                launches[counter] += n
                _same_bits_or_raise(case, "the run on a mesh of one", _mesh_outputs(sharded),
                                    singles[case])
                print(f"mesh {case}: world 1 equals the unsharded run bit for bit (draws "
                      f"{sharded.thetas.shape}, eps {sharded.stats['step_size']:.6g}"
                      + (f", log Z {sharded.stats['log_z']:.4f}" if cfg.head == "smc" else "")
                      + f"); walls {wall_single:.3f} s unsharded, {wall_mesh:.3f} s on the "
                      f"mesh; {n} {counter} launches")
        finally:
            tdist.destroy_process_group()

        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            print(f"mesh: {n_cards} card, so only a world of one ran; two NCCL ranks need "
                  "two cards")
            return launches
        for case in MESH:
            out = f"{tmp}/{case}"
            procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                       "--mesh-worker", case, str(r), "2",
                                       f"{tmp}/rdv_{case}", out],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for r in range(2)]
            try:
                logs = [p.communicate(timeout=600) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            for p, (_, err) in zip(procs, logs):
                if p.returncode != 0:
                    raise AssertionError(f"mesh {case}: a rank returned {p.returncode}:\n"
                                         f"{err[-3000:]}")
            for r in range(2):
                got = dict(np.load(f"{out}.{r}.npz"))
                _same_bits_or_raise(case, f"rank {r} of two NCCL ranks", got, singles[case])
            print(f"mesh {case}: two NCCL ranks on two cards equal the unsharded run bit for bit")
    return launches


# Bounds: the least time the card could take for a kernel's work, the larger
# of its operations over the fp32 peak outside the tensor cores and its bytes
# (each input read once, each output written once) over the memory rate
# (NVIDIA's H100 SXM data sheet).  Operations are the pixel work that the
# function needs, one multiply-add as two operations; the per-star work and
# the profiles' exponentials are left out, so the bound is if anything low.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def leapfrog_ops(c, k, h, w, n_steps, grad_in):
    """B1/B2/B5: the render (one FMA) and the contraction (two FMAs) per
    star and pixel of every gradient evaluation."""
    evals = n_steps + (0 if grad_in and n_steps > 0 else 1)
    return c * evals * 6.0 * k * h * w


def rhmc_diag_ops(c, k, h, w, n_steps, fpi):
    """B3/B4: what the function needs per star and pixel, counted from the
    reference's crowded-field tile (starcat/pallas_rhmc_diag.py:660-870),
    not from a kernel's recomputation: a build (lambda 2, the (H,W)@(W,4K)
    bilinears 8, the rho contraction 4, the q field and its contraction 8:
    22), a momentum sweep (q field and contraction, 8), a position sweep
    (lambda and the (H,W)@(W,2K) metric contraction, 6); a step is fpi
    momentum and fpi position sweeps, a build and the final momentum half
    step, and the trajectory one build more.  c chains of k stars each; for
    B4, which skips dead stars, c = 1 and k the live stars of all chains."""
    return c * k * h * w * (22.0 + n_steps * (30.0 + 14.0 * fpi))


def rhmc_full_ops(c, k, h, w, n_steps, fpi):
    """B6: per star pair and pixel, a rebuild's pair contractions (6 FMAs)
    and q field (9 operations), a position sweep's Fisher pairs (i <= j, 4
    FMAs); per star and pixel, a momentum sweep's phi field and psi
    contractions (24 operations) and the renders."""
    pairs = k * k * h * w * (21.0 + n_steps * (4.0 * fpi + 21.0))
    single = k * h * w * (26.0 + n_steps * (26.0 * fpi + 50.0))
    return c * (pairs + single)


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def leapfrog_bytes(c, k, h, w, grad_in):
    """theta, p, eps, (grad), the mask and inv_mass in; theta, p, u, grad out."""
    return 4 * (c * 3 * k * (2 + int(grad_in)) + c + k + 3 * k + h * w
                + c * 3 * k * 3 + c)


def rhmc_bytes(c, k, h, w, per_chain_mask):
    """theta, xi, eps, the mask, beta and the image in; theta', p', h0, h1,
    u1, resid out."""
    return 4 * (c * 6 * k + c + (c * k if per_chain_mask else k) + 1 + h * w
                + c * 6 * k + 4 * c)


def _build_all(build):
    """nvcc on every kernel source at once, one process each."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("fused_leapfrog", "fused_rhmc_diag", "fused_rhmc", "fused_leapfrog_crowded",
             "fused_rhmc_diag_crowded")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.build_kernel, names)))
    print(f"kernel builds: {time.perf_counter() - t0:.2f} s wall")
    for name, (lib, report, seconds) in built.items():
        print(f"  {name}: nvcc {seconds:.2f} s -> {lib.name}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--durability-worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return durability_worker(*sys.argv[2:6])
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return mesh_worker(*sys.argv[2:7])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from starcat_torch import api, build, hmc, rhmc
    from starcat_torch import fused_leapfrog as fl
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc as fr
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch.configs import CONFIGS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build_all(build)

    dev = torch.device("cuda:0")
    cfg = CONFIGS["cfg6_chees"]
    cfg4 = CONFIGS["cfg4_crowded"]
    err, ms = check_kernel(fl, cfg, dev)
    err_edges, ms_b1_b5 = check_b1_edges(fl, flc, CONFIGS, dev)
    err = {nm: max(e, err_edges[nm]) for nm, e in err.items()}
    err_b3, ms_b3 = check_rhmc_kernel(frd, rhmc, CONFIGS["cfg5_transdim_mcmc"], dev)
    err_b3 = max(err_b3, check_b3_edges(frd, CONFIGS["cfg5_transdim_mcmc"], dev))
    err_b6, ms_b6 = check_rhmc_full_kernel(fr, rhmc, CONFIGS["cfg3_transdim_smc"], dev)
    err_b5, ms_b5 = check_b5_kernel(flc, fl, hmc, cfg4, cfg, dev)
    err_b5 = max(err_b5, check_b5_edges(flc, fl, cfg4, dev))
    err_b4, ms_b4 = check_b4_kernel(frdc, frd, rhmc, cfg4, CONFIGS["cfg5_transdim_mcmc"], dev)

    fl.reset_launch_counts()
    t0 = time.perf_counter()
    run_slice(api, cfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"static": fl.STATIC_LAUNCHES, "dyn": fl.DYN_LAUNCHES}
    print(f"fixed-K path: {wall:.3f} s wall; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel contract was never launched: {launches}")

    frd.reset_launch_counts()
    t0 = time.perf_counter()
    run_riemannian_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b3"] = frd.LAUNCHES
    print(f"Riemannian path: {wall:.3f} s wall; B3 launches {launches['b3']}")
    if launches["b3"] <= 0:
        raise AssertionError("B3 was never launched on the Riemannian path")
    print(f"B3 at the cfg1 shape: kernel {ms_b3['cfg1']:.4f} ms, plain "
          f"{ms_b3['cfg1_plain']:.4f} ms per trajectory")

    fr.reset_launch_counts()
    t0 = time.perf_counter()
    run_b6_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b6"] = fr.LAUNCHES
    print(f"full-metric path: {wall:.3f} s wall; B6 launches {launches['b6']}")
    if launches["b6"] <= 0:
        raise AssertionError("B6 was never launched on the full-metric path")
    print(f"B6 at the cfg1 shape: kernel {ms_b6['cfg1']:.4f} ms, plain "
          f"{ms_b6['cfg1_plain']:.4f} ms per trajectory")

    flc.reset_launch_counts()
    frdc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_crowded_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b4"], launches["b5"] = frdc.LAUNCHES, flc.LAUNCHES
    print(f"crowded path: {wall:.3f} s wall; B4 launches {launches['b4']}, B5 launches "
          f"{launches['b5']}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if launches["b4"] <= 0 or launches["b5"] <= 0:
        raise AssertionError(f"a crowded-field kernel was never launched: {launches}")

    err_leaf, ms_leaf = check_nuts_advi_kernel(fl, CONFIGS["cfg2_nuts"], dev)
    err["static"] = max(err["static"], err_leaf)
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    leaves = run_nuts_advi_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"NUTS and ADVI path: {wall:.3f} s wall; B1 launches {fl.STATIC_LAUNCHES} "
          f"({leaves:.1f} NUTS leaves a transition)")
    if fl.STATIC_LAUNCHES <= 0:
        raise AssertionError("B1 was never launched on the NUTS and ADVI path")
    launches["static"] += fl.STATIC_LAUNCHES
    t0 = time.perf_counter()
    dur = run_durability(api, CONFIGS, dev)
    print(f"durability path: {time.perf_counter() - t0:.3f} s wall; launches {dur}")
    for name in ("dyn", "b3", "b6"):
        if dur[name] <= 0:
            raise AssertionError(f"{name} was never launched on the durability path: {dur}")
        launches[name] += dur[name]
    launches["static"] += dur["static"]
    if dur["b4"] <= 0:
        raise AssertionError(f"B4 was never launched on the durability path: {dur}")
    launches["b4"] += dur["b4"]
    t0 = time.perf_counter()
    rep = run_report(CONFIGS, dev)
    print(f"report path: {time.perf_counter() - t0:.3f} s wall; launches {rep}")
    for name, n in rep.items():
        launches[name] += n
    t0 = time.perf_counter()
    msh = run_mesh(api, CONFIGS, dev)
    print(f"mesh path: {time.perf_counter() - t0:.3f} s wall; launches {msh}")
    for name, n in msh.items():
        launches[name] += n
    # a leaf and an 8-draw gradient at the shapes of this path, against their
    # own bounds (one evaluation each; the leaf's entry gradient is in)
    for name, c, n in (("leaf", 1024, 1), ("grad8", 8, 0)):
        b = bound_ms(leapfrog_ops(c, 10, 32, 32, n, True), leapfrog_bytes(c, 10, 32, 32, n > 0))
        print(f"B1 {name}: {ms_leaf[name]:.5f} ms kernel, {ms_leaf[name + '_plain']:.4f} ms "
              f"plain, bound {b[0]:.6f} ms ({b[1]})")

    # the timed shapes: B1/B2 C = 1024, K = 10, 32x32, L = 20, entry gradient
    # in; B3 256 chains, K = 16, 32x32, 6 x 4, per-chain masks; B6 4096
    # particles, K = 16, 32x32, 6 x 4, per-chain masks; B5 1024 chains, K =
    # 50, 128x128, L = 10, entry gradient in; B4 4096 particles, K = 64
    # (30..64 live), 128x128, 6 x 4, per-chain masks
    b12 = bound_ms(leapfrog_ops(1024, 10, 32, 32, 20, True),
                   leapfrog_bytes(1024, 10, 32, 32, True))
    b3 = bound_ms(rhmc_diag_ops(256, 16, 32, 32, 6, 4), rhmc_bytes(256, 16, 32, 32, True))
    b6 = bound_ms(rhmc_full_ops(4096, 16, 32, 32, 6, 4), rhmc_bytes(4096, 16, 32, 32, True))
    b5 = bound_ms(leapfrog_ops(1024, 50, 128, 128, 10, True),
                  leapfrog_bytes(1024, 50, 128, 128, True))
    # B4 skips dead stars: its work is that of the timed inputs' live ones
    b4 = bound_ms(rhmc_diag_ops(1, ms_b4["b4_live"], 128, 128, 6, 4),
                  rhmc_bytes(4096, 64, 128, 128, True))

    def row(name, source, replaces, n, e, t, t_plain, bound):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": e, "ms": t, "plain_ms": t_plain,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}

    src = "starcat_torch/csrc/fused_leapfrog.cu"
    rows = [
        row("fused_leapfrog (B1 contract, static L)", src, "starcat/pallas_kernels.py:441",
            launches["static"], err["static"], ms["static"], ms["plain"], b12),
        row("fused_leapfrog_dyn (B2 contract, runtime n_steps)", src,
            "starcat/pallas_kernels.py:317", launches["dyn"], err["dyn"], ms["dyn"],
            ms["plain"], b12),
        row("fused_rhmc_diag (B3, diagonal-Fisher Riemannian trajectory)",
            "starcat_torch/csrc/fused_rhmc_diag.cu", "starcat/pallas_rhmc_diag.py:405",
            launches["b3"], err_b3, ms_b3["cfg5"], ms_b3["cfg5_plain"], b3),
        row("fused_rhmc_diag_crowded (B4, diagonal-Fisher trajectory on crowded fields)",
            "starcat_torch/csrc/fused_rhmc_diag_crowded.cu",
            "starcat/pallas_rhmc_diag.py:942", launches["b4"], err_b4, ms_b4["b4"],
            ms_b4["b4_plain"], b4),
        row("fused_leapfrog_crowded (B5, leapfrog on crowded fields)",
            "starcat_torch/csrc/fused_leapfrog_crowded.cu", "starcat/pallas_mxu.py:310",
            launches["b5"], err_b5, ms_b5["b5"], ms_b5["b5_plain"], b5),
        row("fused_rhmc (B6, full-Fisher Riemannian trajectory)",
            "starcat_torch/csrc/fused_rhmc.cu", "starcat/pallas_rhmc.py:663",
            launches["b6"], err_b6, ms_b6["cfg3"], ms_b6["cfg3_plain"], b6),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
