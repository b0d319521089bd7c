"""Smoke test of the PyTorch/CUDA port (starcat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

1. prints the card (nvidia-smi name and power limit) and builds the seven
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
6b. holds the trans-d sweep kernel against its plain version (the sweep at
   the tempered Poisson likelihood, plain PyTorch on the card) on the same
   inputs and draws at cfg4's shape (4096 chains, K = 64, 128x128, residual
   births, beta 0.3 from a device scalar), cfg3's (4096 chains, K = 16,
   32x32, prior births), cfg5's (256 chains, beta 1) and four shapes that
   walk several regions of the field or chunks of the catalog (192x192 at
   K = 125, prior births at K = 100, 200x136 at K = 100, 250x240 at
   K = 200; SWEEP_SHAPES): the move type on
   every chain, the acceptance on at least 99.5% of them (the others
   decisions within the log alpha tolerance of log u), and on the agreeing
   chains log alpha, the mask, theta and tll; one launch a sweep, the same
   bits on a rerun and for seven chains alone; times the kernel and the
   plain version at each shape;
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
13. durability: each of six runs at full width through the public API,
   the launch counts set to 0 just before and read just after: cfg6_chees
   (1024 chains, K = 10, 32x32, on B2) cut to 150 + 300 draws in four
   blocks, cfg3_transdim_smc as the preset stands (4096 particles, B6),
   cfg5_transdim_mcmc (256 chains, B3) cut to 60 + 40 in four blocks,
   cfg1_rhmc on the full metric (64 chains, B6's 512-thread layout) cut to
   40 + 40 in four blocks, cfg4_crowded (4096 particles, K_max 64,
   128x128, B4 with per-particle masks) cut to three temperature steps and
   cfg2_nuts (1024 chains, every leaf a B1 launch) cut to 60 + 40 in four
   blocks.  Each runs uninterrupted with a metrics stream and checkpoints,
   again with neither (unblocked), then in a process of its own that
   SIGKILLs itself from its logger (after two blocks' checkpoints; cfg3
   after three temperature steps', cfg4 after two), and is resumed here
   from that checkpoint.  The unblocked run and the resumed draws must equal the
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
16. the benchmark (starcat_torch/bench.py): ``python -m starcat_torch bench
   --chains 1024 --scan 10 --repeats 2`` in a process of its own, whose last
   line must be the four-key headline with 0 < value <= B1's bound rate;
   then every leg of ``--full`` in process at a cut size (BENCH_CUT: 256
   chains and 2 trajectories a timed call for the trajectory legs, 64 chains
   at 20 + 10 + 10 for the ESS legs), each raising unless its kernel's
   launch count is exact and its final state finite, and the one-rank NCCL
   scaling row with verify; prints each leg's rate and the phase's wall;
17. mock scenes without JAX: (a) RunConfig.make_data draws the three
   scenes that starcat_torch/data/scenes.npz holds (written with the JAX
   package), and each draw must equal its entry bit for bit, truth and
   image; (b) two scenes that no export holds run through api.sample on
   the card, the launch counts set to 0 just before each and read just
   after: cfg6_chees at truth_seed=21 data_seed=22 at the preset's width
   (1024 chains, K = 10, 32x32) cut to 200 + 200, on B2, and the HMC head
   on a 64x64 field of 20 stars (truth_seed=31 data_seed=32, 1024 chains,
   200 + 200), past B1's 48x48 and so on B5; each must name its kernel,
   launch it, and end with a posterior total flux within 4 sd of the drawn
   truth; before the B5 run, B5 at that run's shape (1024 chains, K = 20,
   the drawn 64x64 image, L = 10, with and without an entry gradient) is
   held against its plain version, float64 as arbiter, and its error goes
   into B5's row; prints each draw's host time and each run's wall;
18. the full metric beyond B6's domain, on B6c: (a) B6c against its plain
   version chain by chain, float64 as arbiter, at a drawn 64x64 field of
   20 stars (64 chains, K = 20, shared mask, cfg1's 16 steps x 6 sweeps)
   and at cfg4's shape (128x128, K = 64, 16 particles with 30..64 live
   stars, 6 x 4, beta 1 and 0.3, float64 on the first 8), at the edges of
   its domain (K = 1 and K = 64 at 128x128, a 128x96 field with K = 40 and
   a 49x49 one with K = 16), the same bits for a chain alone, among 7
   others and among 300, a chain that overflows, and one trajectory timed
   at cfg4's full width (4096 particles), its first 16 particles held
   against the plain version, which is timed on those 16, as is the kernel;
   (b) through the public API, B6c's launch count set to 0 just before
   each run and read just after: cfg1_rhmc on that 64x64 field at its 64
   chains cut to 300 + 300, whose total flux must lie within 4 posterior
   sd of the drawn truth and within 4 combined standard errors of the same
   run on the diagonal metric (B4); cfg4_crowded with smc.mutation=rhmc at
   4096 particles for 2 temperature steps, printed beside the diagonal
   mutation's 2 steps; cfg5_transdim_mcmc with tdm.mutation=rhmc on the
   64x64 field (K_max 24, 256 chains, 30 + 30); each must run through
   B6c with finite draws, and after each B6c run the kernel is held at
   that run's shape on its last state, adapted step and temperature (the
   rhmc head's 64 chains, 1024 of cfg4's particles at beta ~0.006, cfg5's
   256 chains with their per-chain masks): solver verdicts, and the
   well-conditioned chains against float64;
19. B5 and B4 over their TPU kernels' whole domains (their wide paths):
   (a) each against its plain version, float64 as arbiter, on drawn fields
   at cfg4's density at the TPU gates' edges (B5: 128x128 K = 667,
   192x192 K = 361, 256x256 K = 183, 352x128 K = 179; B4: 128x128 K = 254,
   192x192 K = 125, 256x256 K = 47, 304x96 K = 89) and at 200x136, 5-9
   chains, both mask forms, B5 with and without an entry gradient, B4 at
   beta 1 and 0.7; the same bits on a rerun and for chains alone or among
   others, and a chain that overflows, at 192x192 K = 125; B4's wide path
   forced onto cfg4's shape against its one-tile path (float64 deciding
   where their roundings part: the wide path's pixel offsets are exact
   differences); both kernels timed
   at the slice's shapes (B4 4096 particles at K = 125, B5 1024 chains at
   K = 112, L = 10); (b) through the public API, each launch count set to
   0 just before its run and read just after: cfg4's SMC on a drawn
   192x192 field of 112 stars at K_max 125 (4096 particles, 2 temperature
   steps) on B4 and the crowded ChEES head on it (1024 chains, K = 112,
   100 + 100) on B5, each kernel then held at its run's last state;
20. the full metric beyond B6c's one-tile domain, on its wide path: (a)
   B6c against its plain version chain by chain, float64 as arbiter, on
   drawn fields at cfg4's density at the new domain's edges (128x128 K =
   254, 192x192 K = 125, 256x256 K = 47, 304x96 K = 89), at 200x136 and
   one past each one-tile edge (32x32 K = 65, 129x128 K = 10), 3-8
   chains, both mask forms, beta 1 and 0.7; the same bits on a rerun and
   for chains alone or among others, and a chain that overflows, at
   192x192 K = 125; one trajectory timed at the slice's shape (4096
   particles, K = 125), its first 16 particles held against the plain
   version, which is timed on those, as is the kernel; the 128x128 K = 254
   edge timed on 4 chains; (b) through the public API, B6c's launch count
   set to 0 just before each run and read just after: cfg4's SMC with the
   full-metric mutation on phase 19's 192x192 field (K_max 125, 4096
   particles, 2 temperature steps) and cfg1_rhmc on a drawn 128x128 field
   of 80 stars at K = 80 (64 chains, 100 + 100), whose total flux must lie
   within 4 posterior sd of the drawn truth;
21. B5, B4 and B6c beyond their TPU kernels' VMEM gates, where the JAX
   package runs XLA: (a) each against its plain version, float64 as
   arbiter, one past every old edge and at the JAX package's own examples
   (B5: 128x128 K = 668 and 1000, 256x256 K = 200, 512x512 K = 64; B4:
   128x128 K = 255 and 1000, 256x256 K = 256, 512x512 K = 64; B6c:
   256x256 K = 256, 128x128 K = 257, 300 and 700, 512x512 K = 32), 3-6
   chains, both mask forms, B5 with and without an entry gradient, B4 and
   B6c at beta 1 and 0.7; the same bits on a rerun and for chains alone or
   among others, and B6c's 132 chains the same bits at a grid of 132
   blocks and of 8; each kernel timed at the slice's shapes (B4 and B6c
   4096 particles at K = 256 on 256x256, B5 1024 chains at K = 200, B6c
   64 chains at K = 300 on 128x128), the plain versions on the first few
   chains of each launch, as is the kernel; (b) through the public API,
   each launch count set to 0 just before its run and read just after:
   W1 (cfg4's SMC on a drawn 256x256 field of 200 stars at K_max 256, 2
   temperature steps) on B4, W2 (crowded ChEES there at K = 200, 1024
   chains, 20 + 20) on B5, W3 (W1 with the full-metric mutation) and W4
   (the rhmc head on a drawn 128x128 field of 300 stars at K = 300, 2 + 2)
   on B6c, W4's total flux within 4 posterior sd of the truth (where its
   chains start: the truth plus 0.01 jitter, a step near 1e-6 after 2 + 2,
   so a finite run on B6c, not a posterior, is what it shows); B4 and B5
   then held at W1's and W2's last states; (c) B6c's slice addressing past
   both 32-bit thresholds, where a trajectory takes hours: the wide path's
   address probe (one block writing a sentinel through the passes' own
   index helpers at the first and last pair sum, packed L entry, L^-1 and
   G^-1 entry and q coefficient of a real slice) on 128x128 at K = 10923
   (the pair sums past 2^31 floats), 15447 (the D x D matrices past it)
   and the largest K whose slice the card's free memory holds, every
   offset equal to the exact one and every sentinel read back;
Every path from 8 on that runs an SMC or trans-d MCMC head also sets the
sweep kernel's launch count to 0 just before it and reads it just after,
and holds each such run's own count from its stats (``sweep_launches``,
the report's from its process's printed stats): each must be above 0 with
``sweep_kernel`` fused_transdim_sweep;
22. prints one JSON line with a row per kernel (launches on its paths, the
   largest error against its plain version, kernel and plain times, and the
   bound: the least time the card could take for the same work; B6c's row
   also gives the particles of its timed launch, the plain version's, and
   the kernel's time on the plain version's, ms_same; B4's, B5's and B6c's
   rows the same at the slice's shapes under "wide", and beyond the TPU
   gates under "beyond").

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


def _b5_compare(case, out, want, want64=None, kernel="B5", at_own=None):
    """B5 within TOL of its plain version (U with eight float32 spacings at
    its magnitude); on a long trajectory, where the field's stiffness
    amplifies float32 rounding in both versions, a quantity off TOL passes
    if the kernel is no farther from a float64 run of the plain version
    than the float32 plain version is, plus TOL.  With ``at_own`` (theta ->
    the float64 plain version's outputs at L = 0 there), the returned
    gradient off those bars passes where it lies within TOL of float64's
    gradient at the kernel's own returned theta: B5's wide path takes its
    star centres in double, so it no longer shares the plain version's
    float32 centres, and at a stiff star the gradient at a trajectory's end
    then moves with that end's theta (held above) by more than TOL in any
    float32 program (at 512x512 K = 64 on the H100, 10 steps: 0.024 and
    0.006 from float64 for kernel and plain version here, 0.0008-0.014
    and 0.021-0.13 on four more draws; at one point the kernel 3.1e-5, the
    plain version 5.6e-4).  Returns the theta error and the bound on U."""
    tol = dict(TOL, u=TOL["u"] + _spacings(want[2], 8))
    errs = _b5_errors(out, want)
    far = _b5_errors(out, want64) if want64 is not None else None
    near = _b5_errors(want, want64) if want64 is not None else None
    for name, e in errs.items():
        if e <= tol[name]:
            continue
        if (name == "grad_rel" and at_own is not None and far is not None
                and not far[name] <= near[name] + tol[name]):
            g = at_own(out[0])[3]
            own = float(((out[3].double() - g).abs() / (1.0 + g.abs())).max())
            print(f"{kernel} {case}: grad_rel {e:.3g} from the plain version; from float64 "
                  f"the kernel {far[name]:.3g}, the plain version {near[name]:.3g}; from "
                  f"float64's gradient at the kernel's own theta {own:.3g}")
            if not own <= tol[name]:
                raise AssertionError(f"{kernel} {case}: the gradient lies {own} from float64's "
                                     f"at the kernel's own theta")
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


# Phase 6b, the trans-d sweep kernel: (name, preset, overrides, chains,
# beta) of each shape it is held at: the SMC presets' at a device beta and
# cfg5's at the untempered likelihood, each one region of the field and
# one chunk of the catalog; then shapes that walk several of either, at
# cfg4's star density: phase 19's 192x192 slice at K_max 125 (36 regions
# of 32 x 32, two chunks), prior births at K 100 on 128x128 (one 128 x 128
# region, two chunks), a 200x136 field that pads unevenly to 32 x 32
# regions at K 100, and a 250x240 one that pads unevenly to four 128 x 128
# regions at K 200 (four chunks).  SWEEP_AGREE is the least share of
# chains whose acceptance must agree with the plain version's (the rest
# must be decisions within the log alpha tolerance of log u).
SWEEP_SHAPES = (
    ("cfg4", "cfg4_crowded", {}, 4096, 0.3),
    ("cfg3", "cfg3_transdim_smc", {}, 4096, 0.3),
    ("cfg5", "cfg5_transdim_mcmc", {}, 256, 1.0),
    ("cfg4_192", "cfg4_crowded",
     {"scene.height": 192, "scene.width": 192, "n_stars": 112, "kmax": 125}, 1024, 0.3),
    ("cfg4_prior_k100", "cfg4_crowded",
     {"kmax": 100, "smc.transdim.birth_proposal": "prior"}, 1024, 0.3),
    ("cfg4_200x136", "cfg4_crowded",
     {"scene.height": 200, "scene.width": 136, "n_stars": 83, "kmax": 100}, 512, 0.3),
    ("cfg4_250x240", "cfg4_crowded",
     {"scene.height": 250, "scene.width": 240, "n_stars": 183, "kmax": 200}, 256, 0.3),
)
SWEEP_AGREE = 0.995


def sweep_config(configs, preset, over):
    """A SWEEP_SHAPES entry's configuration: the preset with its overrides."""
    from starcat_torch.configs import apply_overrides

    return apply_overrides(configs[preset], over)


def sweep_inputs(cfg, c, dev, seed, beta):
    """A sweep's inputs on cfg's scene: theta near the truth in its first
    slots (prior-like draws past them), per-chain masks with n_true - 10 ..
    n_true + 10 live slots in shuffled order (chain 0 with none, chain 1
    with all K, so that both guards are held), the tempered log-likelihood
    and draw_sweep's draws; beta a device scalar or a float."""
    import torch

    from starcat_torch import transdim as td
    from starcat_torch.potential import log_likelihood

    truth, image = cfg.make_data()
    img = image.to(dev)
    k = cfg.kmax
    tcfg = cfg.smc.transdim if cfg.head == "smc" else cfg.tdm.transdim
    theta, _, _ = _crowded_inputs(truth, c, k, dev, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    n_true = truth.shape[0]
    n_alive = torch.randint(max(0, n_true - 10), min(k, n_true + 10) + 1, (c,), generator=gen,
                            device=dev)
    n_alive[0], n_alive[1] = 0, k
    order = torch.argsort(torch.rand((c, k), generator=gen, device=dev), dim=1)
    mask = (order < n_alive[:, None]).to(torch.float32)
    b = torch.tensor(beta, device=dev) if cfg.head == "smc" else float(beta)
    tll = b * log_likelihood(theta, mask, cfg.scene, img)
    draws = td.draw_sweep(gen, c, k, cfg.scene, cfg.prior, tcfg, dev)
    return img, theta, mask, tll, b, tcfg, draws


def sweep_ops(h, w, mask):
    """The sweep's pixel work that the kernel needs: one render of each
    chain's proposed catalog, whose live stars are within one of its
    current ones (counted as the current), one multiply-add as two
    operations; the transcendental functions and the profiles are left
    out, so the bound is if anything low."""
    return 2.0 * h * w * float(mask.double().sum())


def sweep_bytes(c, k, h, w, n_pix_rows):
    """theta, mask, tll, beta and the image in; a chain's scalar draws and
    up to two Gumbel rows of K, and the pixel Gumbel rows of the residual
    births (n_pix_rows of H W); theta', mask', tll', log alpha, accepted
    (a byte) and the move (8 bytes) out."""
    return (4 * (3 * c * k + c * k + c + 1 + h * w + 12 * c + 2 * c * k + n_pix_rows * h * w
                 + 3 * c * k + c * k + 2 * c) + 9 * c)


def _compare_sweep(name, out, ref, draws, spacing):
    """The kernel's sweep against the plain version's on the same inputs:
    the move type everywhere; the acceptance on at least SWEEP_AGREE of the
    chains, the others decisions within the log alpha tolerance of log u;
    on the agreeing chains log alpha within rtol 1e-4 and atol 2e-2 plus
    16 float32 spacings at the tempered log-likelihood's magnitude (two
    sums over the image, each rounded in its own order: the relocate
    move's and the CPU tests' bar plus the sums' rounding), the -inf of a
    failed guard in both or neither, the mask exactly, theta within 1e-4
    and tll within rtol 1e-5, atol 1e-3 (tests/test_torch_transdim.py's
    _assert_same_move).  Returns (largest theta error, the shares)."""
    import torch

    th, m, ll, info = out
    th_r, m_r, ll_r, info_r = ref
    if not torch.equal(info.move_type, info_r.move_type):
        raise AssertionError(f"sweep {name}: the move types differ")
    same = info.accepted == info_r.accepted
    agree = float(same.float().mean())
    la, la_r = info.log_alpha, info_r.log_alpha
    guard, guard_r = la == -float("inf"), la_r == -float("inf")
    if not torch.equal(guard, guard_r):
        raise AssertionError(f"sweep {name}: a move's guard differs")
    tol = 2e-2 + 16.0 * spacing + 1e-4 * la_r.abs()
    off = ((la - la_r).abs() > tol) & torch.isfinite(la_r) & same
    if bool(off.any()):
        i = int(off.nonzero()[0])
        raise AssertionError(f"sweep {name}: log alpha {float(la[i])} against "
                             f"{float(la_r[i])} on chain {i}")
    u_acc = torch.where(info_r.move_type <= 1, draws.bd[-1], draws.sm[-1])
    near = ((la_r - torch.log(u_acc)).abs() <= tol) | ((la - torch.log(u_acc)).abs() <= tol)
    if bool((~same & ~near).any()):
        i = int((~same & ~near).nonzero()[0])
        raise AssertionError(f"sweep {name}: an acceptance differs beyond the tolerance of log u "
                             f"on chain {i}: log alpha {float(la[i])} against {float(la_r[i])}, "
                             f"log u {float(torch.log(u_acc[i]))}")
    if agree < SWEEP_AGREE:
        raise AssertionError(f"sweep {name}: acceptance agrees on {agree:.4f} of the chains")
    if not torch.equal(m[same], m_r[same]):
        raise AssertionError(f"sweep {name}: the masks differ")
    err_th = _max_err(th[same], th_r[same])
    err_ll = float(((ll - ll_r).abs() - 1e-5 * ll_r.abs())[same].max())
    if not (err_th <= 1e-4 and err_ll <= 1e-3):
        raise AssertionError(f"sweep {name}: theta error {err_th}, tll error {err_ll}")
    finite = torch.isfinite(la_r) & same
    err_la = float((la - la_r).abs()[finite].max()) if bool(finite.any()) else 0.0
    return err_th, {"agree": agree, "log_alpha_err": err_la,
                    "accepted": float(info_r.accepted.float().mean())}


def check_sweep_kernel(fts, configs, dev):
    """Phase 6b: the trans-d sweep kernel against its plain version
    (transdim.poisson_sweep_reference, on the card) on the same inputs and
    draws at each of SWEEP_SHAPES: cfg4's shape (4096 chains, K 64,
    128x128, residual births, beta 0.3 from a device scalar), cfg3's (4096,
    K 16, 32x32, prior births), cfg5's (256 chains, beta 1 as a float) and
    four that walk several regions or chunks: _compare_sweep's bars; one
    launch a sweep; the same bits on a rerun and for the first seven chains
    alone; then the kernel and the plain version timed at each shape.
    Returns the largest theta error and the times."""
    import numpy as np
    import torch

    from starcat_torch import transdim as td

    err, ms = 0.0, {}
    for name, preset, over, c, beta in SWEEP_SHAPES:
        cfg = sweep_config(configs, preset, over)
        img, theta, mask, tll, b, tcfg, draws = sweep_inputs(cfg, c, dev, 60, beta)
        args = (b, cfg.prior, cfg.scene, img, tcfg)

        def kernel(th=theta, m=mask, t=tll, d=draws):
            return td.poisson_sweep(th, m, t, args[0], *args[1:], d)

        fts.reset_launch_counts()
        out = kernel()
        if fts.LAUNCHES != 1:
            raise AssertionError(f"sweep {name}: {fts.LAUNCHES} launches for one sweep")
        ref = td.poisson_sweep_reference(theta, mask, tll, *args, draws)
        spacing = float(np.spacing(np.float32(tll.abs().max().item())))
        e, shares = _compare_sweep(name, out, ref, draws, spacing)
        err = max(err, e)
        again = kernel()
        sub = td.SweepDraws(draws.u_sel[:7], tuple(t[:7] for t in draws.bd),
                            tuple(t[:7] for t in draws.sm))
        alone = kernel(theta[:7], mask[:7], tll[:7], sub)
        for a, r, al in zip(out[:3] + tuple(out[3]), again[:3] + tuple(again[3]),
                            alone[:3] + tuple(alone[3])):
            if not (_same_bits([a], [r]) if a.is_floating_point() else torch.equal(a, r)):
                raise AssertionError(f"sweep {name}: not the same bits on a rerun")
            if not (_same_bits([a[:7]], [al]) if a.is_floating_point() else
                    torch.equal(a[:7], al)):
                raise AssertionError(f"sweep {name}: not the same bits for 7 chains alone")
        h, w, k = cfg.scene.height, cfg.scene.width, cfg.kmax
        births = int(((out[3].move_type == 0) & (mask.sum(-1) < k)).sum())
        bound = bound_ms(sweep_ops(h, w, mask),
                         sweep_bytes(c, k, h, w, births if tcfg.birth_proposal == "residual"
                                     else 0))
        ms[name] = _time_ms(kernel, 10)
        ms[name + "_plain"] = _time_ms(
            lambda: td.poisson_sweep_reference(theta, mask, tll, *args, draws), 3)
        ms[name + "_bound"], ms[name + "_bound_by"] = bound
        ms[name + "_live"] = int(mask.sum())
        print(f"sweep kernel {name} ({c} chains, K={k}, {h}x{w}, {tcfg.birth_proposal} births, "
              f"beta {beta}): moves {torch.bincount(out[3].move_type, minlength=4).tolist()}, "
              f"accepted {shares['accepted']:.4f}, acceptance agrees on {shares['agree']:.4f}, "
              f"log alpha err {shares['log_alpha_err']:.3g}, theta err {e:.3g}; kernel "
              f"{ms[name]:.4f} ms, plain {ms[name + '_plain']:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}); layout "
              f"{json.dumps(fts.launch_layout(c, k, h, w))}")
    return err, ms


def sweep_launches(label, st):
    """A trans-d run's (an SMC or trans-d MCMC head's) launches of the sweep
    kernel, from its stats; raises unless its sweeps ran on the kernel."""
    n = st.get("sweep_launches", 0)
    if st.get("sweep_kernel") != "fused_transdim_sweep" or n <= 0:
        raise AssertionError(f"{label}: its sweeps did not run on the sweep kernel "
                             f"({st.get('sweep_kernel')}, {n} launches)")
    return n


def path_sweeps(label, fts):
    """The sweep kernel's launches on a path since its count was set to 0
    just before it; raises if there were none."""
    if fts.LAUNCHES <= 0:
        raise AssertionError(f"the sweep kernel was never launched on the {label}")
    return fts.LAUNCHES


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
        if rcfg.head == "transdim":
            sweep_launches(f"slice {name}", st)
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
        if rcfg.head == "smc":
            sweep_launches(f"slice {name}", st)
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
    sweep_launches("slice cfg4_crowded", st)
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
    "cfg2_nuts": ({"n_warmup": 60, "n_samples": 40}, 0, "sampling_block", 3),
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
    "cfg2_nuts": (("warmup_phase", 3), ("sampling_block", 4), ("run_complete", 1)),
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
        if cfg.head in ("smc", "transdim"):
            for leg, out in (("uninterrupted", full), ("unblocked", plain),
                             ("resumed", resumed)):
                sweep_launches(f"durability {case} ({leg})", out.stats)

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
    kernel counter, as each run's stats count them (the sweep kernel's of
    the trans-d MCMC report under "sweep")."""
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
        if cfg.head == "transdim":
            launches["sweep"] = launches.get("sweep", 0) + sweep_launches(f"report {name}", st)
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
    kernel counter over the sharded runs (the sweep kernel's under
    "sweep")."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from starcat_torch import dist
    from starcat_torch import fused_leapfrog as fl
    from starcat_torch import fused_rhmc as fr
    from starcat_torch.configs import apply_overrides

    launches = {"dyn": 0, "b6": 0, "sweep": 0}
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
                if cfg.head == "smc":
                    sweep_launches(f"mesh {case} (unsharded)", single.stats)
                    launches["sweep"] += sweep_launches(f"mesh {case}", sharded.stats)
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


# Phase 16.  The bench legs in process at a cut size: (chains, trajectories
# a timed call, repeats) of the trajectory legs, and (chains, warmup, draws)
# of the ESS legs; the scaling row's chains and draws.
BENCH_CUT = {"trajectories": (256, 2, 2), "ess": (64, 20, 10), "scaling": (256, 10)}
BENCH_HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def run_bench(dev):
    """Phase 16 (see the module docstring).  Returns the launches of each
    kernel counter over the in-process legs."""
    from starcat_torch import bench
    from starcat_torch import fused_leapfrog as fl
    from starcat_torch import fused_leapfrog_crowded as flc
    from starcat_torch import fused_rhmc as fr
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch.configs import CONFIGS

    cfg = CONFIGS["cfg2_nuts"]
    bound = bench.b1_bound_evals_per_sec(cfg.scene, cfg.kmax)
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "starcat_torch", "bench", "--chains", "1024", "--scan", "10",
           "--repeats", "2"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=Path(__file__).resolve().parent)
    if r.returncode != 0:
        raise AssertionError(f"bench: {' '.join(cmd[1:])} returned {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    head = json.loads(r.stdout.strip().splitlines()[-1])
    if (set(head) != BENCH_HEADLINE_KEYS
            or head["metric"] != "leapfrog_grad_evals_per_sec_per_chip"
            or not 0 < head["value"] <= bound):
        raise AssertionError(f"bench: the headline {head} (B1's bound {bound:.6g} evals/s)")
    print(f"bench CLI ({' '.join(cmd[3:])}): {json.dumps(head)} in "
          f"{time.perf_counter() - t0:.3f} s; {head['value'] / bound:.4f} of B1's bound")

    for m in (fl, flc, fr, frd, frdc):
        m.reset_launch_counts()
    c, n_scan, reps = BENCH_CUT["trajectories"]
    reduced = {}
    legs = [
        ("B1 headline evals/s", lambda: bench.bench_fused_grad_evals(c, 20, n_scan, reps, dev)[0]),
        ("plain leapfrog evals/s",
         lambda: bench.bench_plain_grad_evals(c, 20, n_scan, reps, dev, reduced)[0]),
        ("B6 steps/s", lambda: bench.bench_fused_rhmc_steps(c, 10, 6, reps, n_scan, dev)[0]),
        ("plain diagonal steps/s",
         lambda: bench.bench_plain_rhmc_diag_steps(c, 10, 6, reps, n_scan, dev, reduced)[0]),
        ("B3 steps/s", lambda: bench.bench_fused_rhmc_diag_steps(c, 10, 6, reps, n_scan, dev)[0]),
        ("crowded plain / B4 steps/s",
         lambda: bench.bench_rhmc_diag_crowded(c, reps, n_scan, device=dev, reduced=reduced)),
        ("B5 evals/s", lambda: bench.bench_fused_crowded(c, 10, n_scan, reps, dev)),
        ("plain crowded evals/s",
         lambda: bench.bench_plain_crowded(c, 10, n_scan, reps, dev, reduced)),
    ]
    ce, n_warm, n_draw = BENCH_CUT["ess"]
    legs += [
        ("NUTS (B1 leaves) ESS/s, ESS, s",
         lambda: bench.bench_ess_per_sec(ce, n_draw, n_warm, dev)),
        ("ChEES (B2) ESS/s, ESS, s, T", lambda: bench.bench_ess_chees(ce, n_draw, n_warm, dev)),
    ]
    cs, ns = BENCH_CUT["scaling"]
    legs.append(("scaling row, one NCCL rank",
                 lambda: bench.bench_scaling([1], n_chains=cs, n_samples=ns, verify=True,
                                             device=dev)["points"][0]))
    for name, leg in legs:
        t0 = time.perf_counter()
        got = leg()
        print(f"bench leg {name}: {got} ({time.perf_counter() - t0:.3f} s)", flush=True)
    if reduced:
        print(f"bench: plain legs cut {json.dumps(reduced)}")
    launches = {"static": fl.STATIC_LAUNCHES, "dyn": fl.DYN_LAUNCHES, "b3": frd.LAUNCHES,
                "b4": frdc.LAUNCHES, "b5": flc.LAUNCHES, "b6": fr.LAUNCHES}
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench: a kernel was never launched: {launches}")
    print(f"bench phase: {time.perf_counter() - t_phase:.3f} s wall")
    return launches


# Bounds: the least time the card could take for a kernel's work, the larger
# of its operations over the fp32 peak outside the tensor cores and its bytes
# (each input read once, each output written once) over the memory rate
# (NVIDIA's H100 SXM data sheet).  Operations are the pixel work that the
# function needs, one multiply-add as two operations; the per-star work and
# the profiles' exponentials are left out, so the bound is if anything low.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


# phase 17: the scenes data/scenes.npz holds, by entry and config, and two
# scenes no export holds, each with the kernel it must run on
SCENE_ENTRIES = (("cfg0_single_star", "cfg0_single_star"), ("flagship", "cfg6_chees"),
                 ("crowded", "cfg4_crowded"))
MOCK_SCENES = (
    ("cfg6_chees", {"truth_seed": 21, "data_seed": 22, "n_warmup": 200,
                    "n_samples": 200}, "B2"),
    ("cfg4_crowded", {"head": "hmc", "scene.height": 64, "scene.width": 64,
                      "n_stars": 20, "kmax": 20, "truth_seed": 31, "data_seed": 32,
                      "n_chains": 1024, "n_warmup": 200, "n_samples": 200}, "B5"),
)


def _b5_on_drawn_scene(fl, flc, cfg, truth, image, dev):
    """B5 at a drawn scene's run shape (its chains, K and field): one L = 10
    trajectory near the truth, with and without an entry gradient, against
    its plain version (float64 as arbiter, _b5_compare).  Returns the theta
    error."""
    import torch

    img = image.to(dev)
    spec, prior, c, k, L = cfg.scene, cfg.prior, cfg.n_chains, cfg.kmax, 10
    theta, p, eps = _crowded_inputs(truth, c, k, dev, 80)
    eps = 0.002 * eps
    inv_mass = torch.full((k, 3), 0.9, device=dev)
    mask = torch.ones(k, device=dev)
    fused = flc.make_fused_leapfrog(spec, img, prior, k, L)
    _, _, _, g0 = fl.fused_leapfrog_reference(spec, img, prior, theta, p, eps, inv_mass, mask,
                                              0, None)
    err = 0.0
    for grad in (None, g0):
        case = (f"drawn {spec.height}x{spec.width} K={k}, {c} chains, L={L}, "
                f"grad={'in' if grad is not None else 'none'}")
        want = fl.fused_leapfrog_reference(spec, img, prior, theta, p, eps, inv_mass, mask, L,
                                           grad)
        want64 = fl.fused_leapfrog_reference(
            spec, img.double(), prior, theta.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), L, None if grad is None else grad.double())
        e, _ = _b5_compare(case, fused(theta, p, eps, inv_mass, mask, grad=grad), want, want64)
        print(f"B5 {case}: max theta err {e:.3g}")
        err = max(err, e)
    return err


def run_mock_scenes(api, configs, dev, fl, flc):
    """Phase 17: mock scenes drawn on a machine without JAX (docstring, 17).
    Returns the launches of B2's contract and of B5, and B5's largest theta
    error against its plain version at the B5 scene's run shape."""
    import numpy as np
    import torch

    from starcat_torch.configs import apply_overrides

    scenes = Path(__file__).resolve().parent / "starcat_torch" / "data" / "scenes.npz"
    with np.load(scenes) as data:
        for entry, name in SCENE_ENTRIES:
            t0 = time.perf_counter()
            theta, image = configs[name].make_data()
            ms = (time.perf_counter() - t0) * 1e3
            want_theta, want_image = data[f"{entry}/theta"], data[f"{entry}/image"]
            n_theta = int((theta.numpy() != want_theta).sum())
            n_pix = int((image.numpy() != want_image).sum())
            print(f"mock scene {entry} ({name}): drawn in {ms:.1f} ms on the host; "
                  f"{n_theta} of {want_theta.size} truth values and {n_pix} of "
                  f"{want_image.size} pixels differ from scenes.npz")
            if n_theta or n_pix:
                raise AssertionError(f"the draw of {entry} is not the JAX package's")
    launches = {"dyn": 0, "b5": 0}
    err_b5 = 0.0
    for name, overrides, kernel in MOCK_SCENES:
        cfg = apply_overrides(configs[name], overrides)
        t0 = time.perf_counter()
        truth_theta, image = cfg.make_data()
        draw_ms = (time.perf_counter() - t0) * 1e3
        if kernel == "B5":
            err_b5 = max(err_b5, _b5_on_drawn_scene(fl, flc, cfg, truth_theta, image, dev))
        fl.reset_launch_counts()
        flc.reset_launch_counts()
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = fl.DYN_LAUNCHES if kernel == "B2" else flc.LAUNCHES
        launches["dyn" if kernel == "B2" else "b5"] += n
        st = out.stats
        tf = api.summarize_output(out)["total_flux"]
        truth = float(np.sum(st["truth"]["f"]))
        print(f"mock scene {name} {json.dumps(overrides)}: drawn in {draw_ms:.1f} ms on "
              f"the host; {cfg.n_chains} chains, {cfg.n_warmup} + {cfg.n_samples} in "
              f"{wall:.3f} s wall ({st['wall_seconds']:.3f} s sampling), "
              f"{st['trajectory_kernel']} x{n}, accept {st['accept']:.3f}; total flux "
              f"{tf['mean']:.2f} ± {tf['sd']:.2f}, truth {truth:.2f}")
        if st["trajectory_kernel"] != kernel or n <= 0:
            raise AssertionError(f"{name} {overrides} did not run through {kernel}: "
                                 f"{st['trajectory_kernel']} x{n}")
        if not np.isfinite(out.thetas).all() or not abs(tf["mean"] - truth) <= 4 * tf["sd"]:
            raise AssertionError(f"{name} {overrides}: total flux {tf['mean']} ± {tf['sd']} "
                                 f"vs the drawn truth {truth}")
    return launches, err_b5


# phase 18: the full metric beyond B6's domain.  The rhmc head's leg runs
# cfg1_rhmc on a drawn 64x64 field of 20 stars at the preset's 64 chains,
# warmup and samples cut from 400 + 1000 to 300 + 300, on the full metric
# (B6c) and on its diagonal (B4); cfg4 with the full-metric mutation runs
# 2 temperature steps at the preset's 4096 particles; cfg5 with the
# full-metric move runs 30 + 30 transitions at its 256 chains on the 64x64
# field with K_max 24
WIDE_FIELD = {"scene.height": 64, "scene.width": 64, "n_stars": 20, "truth_seed": 41,
              "data_seed": 42}
B6C_RHMC = {**WIDE_FIELD, "kmax": 20, "n_warmup": 300, "n_samples": 300}
B6C_CFG4 = {"smc.mutation": "rhmc", "smc.max_steps": 2}
B6C_CFG5 = {**WIDE_FIELD, "kmax": 24, "tdm.mutation": "rhmc", "n_warmup": 30,
            "n_samples": 30}
B6C_CFG4_HELD = 1024  # cfg4's particles held against the plain version
# B6c's edges: (chains, K, H, W) on cuts of the crowded image
B6C_EDGES = ((7, 1, 128, 128), (5, 64, 128, 128), (9, 40, 128, 96), (9, 16, 49, 49))


def _plain_chunked(reference, spec, img, pr, theta, xi, eps, mask, beta, n_steps, fpi):
    """A Riemannian kernel's plain version (``reference``) 32 chains a call,
    in the inputs' dtype."""
    import torch

    c = theta.shape[0]
    parts = [reference(spec, img, pr, theta[i:i + 32], xi[i:i + 32], eps[i:i + 32],
                       mask[i:i + 32] if mask.ndim == 2 else mask, beta, n_steps, fpi)
             for i in range(0, c, 32)]
    return [torch.cat(o) for o in zip(*parts)]


def _hold_b6c(frc, fr, name, spec, img, pr, k, n_steps, fpi, theta, xi, eps, mask, beta,
              n64, crowded):
    """B6c against its plain version (32 chains a call), chain by chain
    (_compare_chains), the first n64 chains with the float64 arbiter too, and
    its dead slots frozen.  The crowded field's energies get eight float32
    spacings and its momenta, p = L xi with L growing with the Fisher
    information of its bright stars, the bar relative to 1 + |p|, as B4's
    (phase 6).  Returns the largest theta error."""
    import torch

    dev = theta.device
    out = frc.make_fused_rhmc(spec, img, pr, k, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(beta, device=dev))
    c = theta.shape[0]
    ref = _plain_chunked(fr.fused_rhmc_reference, spec, img, pr, theta, xi, eps, mask, beta,
                         n_steps, fpi)
    spacings = 8 if crowded else 4
    e = 0.0
    if n64 < c:  # every chain against the plain version alone
        e = _compare_chains(f"B6c {name}", out, ref, h_spacings=spacings, p_rel=crowded)
    if n64:  # the first n64 with the float64 arbiter too
        m = mask[:n64] if mask.ndim == 2 else mask
        ref64 = fr.fused_rhmc_reference(spec, img.double(), pr, theta[:n64].double(),
                                        xi[:n64].double(), eps[:n64].double(),
                                        m.double(), beta, n_steps, fpi)
        e = max(e, _compare_chains(f"B6c {name}, {n64} of {c} with float64",
                                   [o[:n64] for o in out], [r[:n64] for r in ref], ref64,
                                   h_spacings=spacings, p_rel=crowded))
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    dead = (live == 0) & (out[5] < SOLVER_TOL)[:, None]
    if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
        raise AssertionError(f"B6c {name}: a dead slot moved")
    return e


def _hold_b6c_wide(frc, fr, name, spec, img, pr, k, n_steps, fpi, theta, xi, eps, mask, beta):
    """B6c's wide path against its plain version, float64 arbitrating:
    the kernel's and the float32 plain version's solver verdicts agree on
    at least 99% of all chains; of the chains the float64 plain version
    brings to TIGHT, at least 80% are tight in both float32 programs too,
    and on those each output of the kernel lies within _compare_chains'
    bar of the plain version's (RTOL; the energies eight float32 spacings
    at their magnitude; p relative to 1 + |p|) or nearer float64 than the
    plain version's, chain by chain.  A chain float64 itself does not
    bring to TIGHT (a trajectory that blows up in every program: at
    128x128 K = 254 one of 6 drawn chains goes NaN in float64 at a twelfth
    of B4's step) tells nothing of float32's rounding, so it counts only
    in the verdicts.  Dead slots frozen.  Returns the largest theta
    distance from the plain version on the tight chains."""
    import torch

    out = frc.make_fused_rhmc(spec, img, pr, k, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(beta, device=theta.device))
    ref = fr.fused_rhmc_reference(spec, img, pr, theta, xi, eps, mask, beta, n_steps, fpi)
    ref64 = fr.fused_rhmc_reference(spec, img.double(), pr, theta.double(), xi.double(),
                                    eps.double(), mask.double(), beta, n_steps, fpi)
    return _judge_b6c_wide(name, out, ref, ref64, theta, mask)


def _judge_b6c_wide(name, out, ref, ref64, theta, mask):
    """_hold_b6c_wide's verdict on given outputs of the kernel, the float32
    plain version and the float64 one."""
    import torch

    c, k = theta.shape[0], theta.shape[1]
    fail_k, fail_r = ~(out[5] < SOLVER_TOL), ~(ref[5] < SOLVER_TOL)
    disagree = int((fail_k != fail_r).sum())
    ok64 = ref64[5] < TIGHT
    tight = ok64 & (out[5] < TIGHT) & (ref[5] < TIGHT)
    print(f"B6c {name}: solver failures kernel {int(fail_k.sum())}, plain "
          f"{int(fail_r.sum())}, float64 {int((~(ref64[5] < SOLVER_TOL)).sum())}, "
          f"disagreeing {disagree} of {c}; float64 tight on {int(ok64.sum())}, all three on "
          f"{int(tight.sum())}")
    if disagree > 0.01 * c:
        raise AssertionError(f"B6c {name}: {disagree} chains' solver verdicts disagree")
    if int(ok64.sum()) < 2 or int(tight.sum()) < 0.8 * int(ok64.sum()):
        raise AssertionError(f"B6c {name}: tight on {int(tight.sum())} of the "
                             f"{int(ok64.sum())} chains float64 brings to TIGHT")
    names = ("theta", "p", "h0", "h1", "u1", "resid")

    def dist(nm, x, z):
        d = (x.double() - z.double()).abs()
        return _per_chain(d / (1.0 + z.double().abs()) if nm == "p" else d)[tight]

    report, e_theta = {}, 0.0
    for nm, a, b, z in zip(names, out, ref, ref64):
        tol = _h_tol(b[tight], 8) if nm in ("h0", "h1", "u1") else RTOL[nm]
        e, dk, dp = dist(nm, a, b), dist(nm, a, z), dist(nm, b, z)
        bad = (e > tol) & (dk > dp)
        report[nm] = {"max": float(e.max()), "tol": tol, "by_float64": int((e > tol).sum()),
                      "kernel_f64": float(dk.max()), "plain_f64": float(dp.max())}
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(f"B6c {name}: {nm} {float(e[i])} from the plain version "
                                 f"(bar {tol}) and {float(dk[i])} from float64, the plain "
                                 f"version {float(dp[i])}")
        if nm == "theta":
            e_theta = float(e.max())
    print(f"B6c {name}: on the {int(tight.sum())} tight chains (max from the plain version, "
          f"bar, chains beyond it that float64 decided for the kernel, max from float64 of "
          f"kernel and plain) {json.dumps(report)}")
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    dead = (live == 0) & (~fail_k)[:, None]
    if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
        raise AssertionError(f"B6c {name}: a dead slot moved")
    return e_theta


def _arbitrate(label, make_fused, reference, name, spec, img, pr, k, n_steps, fpi, theta, xi,
               eps, mask, beta, crowded, min_conv):
    """A Riemannian kernel (``label``, built by ``make_fused``: B6c, B4) on
    a run's own state, against its plain version ``reference`` 32 chains a
    call.  Solver verdicts agree with the plain version's on at least 99%
    of the chains, and at least min_conv chains converged in both.
    float64 then sorts the converged chains: on a
    well-conditioned one the fixed points converged to TIGHT in the kernel
    and in both plain versions, and every output of the float32 plain
    version lies within RTOL of the float64 one's (energies _h_tol, eight
    spacings on the crowded field; p relative to 1 + |p|, as phase 6 holds
    B4's, since p = L xi grows with the Fisher information of a run's
    bright stars), and there the kernel's must lie no farther from float64
    than the plain version's, plus RTOL, chain by chain; at least 8 chains
    must be well-conditioned.  On the others the trajectory amplifies
    float32 rounding beyond RTOL in any float32 program (on the H100 the
    plain version alone moved a tightly converged chain's theta by 1.5e-4
    between a launch of 1 chain and one of 32), so their distances are only
    printed.  Dead slots frozen."""
    import torch

    dev = theta.device
    out = make_fused(spec, img, pr, k, n_steps, fpi)(
        theta, xi, eps, mask, torch.tensor(beta, device=dev))
    ref = _plain_chunked(reference, spec, img, pr, theta, xi, eps, mask, beta, n_steps, fpi)
    c = theta.shape[0]
    fail_k, fail_r = ~(out[5] < SOLVER_TOL), ~(ref[5] < SOLVER_TOL)
    disagree = int((fail_k != fail_r).sum())
    conv = ~fail_k & ~fail_r
    n_conv = int(conv.sum())
    print(f"{label} {name}: solver failures kernel {int(fail_k.sum())}, plain "
          f"{int(fail_r.sum())}, disagreeing {disagree} of {c}; {n_conv} converged in both")
    if disagree > 0.01 * c:
        raise AssertionError(f"{label} {name}: {disagree} chains' solver verdicts disagree")
    if n_conv < min_conv:
        raise AssertionError(f"{label} {name}: only {n_conv} of {c} chains converged, "
                             f"fewer than {min_conv}")
    idx = conv.nonzero()[:, 0]
    m = mask[idx] if mask.ndim == 2 else mask
    ref64 = _plain_chunked(reference, spec, img.double(), pr, theta[idx].double(),
                           xi[idx].double(), eps[idx].double(), m.double(), beta, n_steps, fpi)
    ok = ref64[5] < SOLVER_TOL

    def dist(x, z, rel):
        d = (x[idx].double() - z).abs()
        return _per_chain(d / (1.0 + z.abs()) if rel else d)

    dk, dp, tol = {}, {}, {}
    for nm, a, b, z in zip(("theta", "p", "h0", "h1", "u1"), out, ref, ref64):
        dk[nm], dp[nm] = dist(a, z, nm == "p"), dist(b, z, nm == "p")
        tol[nm] = _h_tol(z[ok], 8 if crowded else 4) if nm in ("h0", "h1", "u1") else RTOL[nm]
    well = ok & (out[5][idx] < TIGHT) & (ref[5][idx] < TIGHT) & (ref64[5] < TIGHT)
    for nm in dk:
        well &= dp[nm] <= tol[nm]
    ill = ok & ~well
    worst = torch.argsort(dk["theta"] - dp["theta"], descending=True)[:4].tolist()
    print(f"{label} {name}: the converged chains whose kernel theta is farthest beyond the "
          "plain version's from float64 (chain, resid kernel / plain / float64, theta "
          "kernel / plain from float64, well-conditioned): " + "; ".join(
              f"{int(idx[i])}, {float(out[5][idx[i]]):.2e} / {float(ref[5][idx[i]]):.2e} / "
              f"{float(ref64[5][i]):.2e}, {float(dk['theta'][i]):.2e} / "
              f"{float(dp['theta'][i]):.2e}, {bool(well[i])}" for i in worst))
    far = {nm: (float(dk[nm][well].max()), float(dp[nm][well].max()))
           if bool(well.any()) else None for nm in dk}
    print(f"{label} {name}: {int(ok.sum())} converged in float64 too, {int(well.sum())} "
          f"well-conditioned; there against float64 (kernel, plain float32) {json.dumps(far)}; "
          f"tolerances {json.dumps(tol)}; on the {int(ill.sum())} others theta "
          f"{float(dk['theta'][ill].max()) if bool(ill.any()) else 0.0} (kernel), "
          f"{float(dp['theta'][ill].max()) if bool(ill.any()) else 0.0} (plain float32)")
    if int(well.sum()) < 8:
        raise AssertionError(f"{label} {name}: only {int(well.sum())} well-conditioned chains")
    flagged = {nm: int((well & (dk[nm] > dp[nm] + tol[nm])).sum()) for nm in dk}
    print(f"{label} {name}: well-conditioned chains on which the kernel lies farther from "
          f"float64 than the plain version plus its bar, by output: {json.dumps(flagged)}")
    for nm in dk:
        bad = well & (dk[nm] > dp[nm] + tol[nm])
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(f"{label} {name}: chain {int(idx[i])}'s {nm} is "
                                 f"{float(dk[nm][i])} from float64, the plain version's "
                                 f"{float(dp[nm][i])}")
    live = mask if mask.ndim == 2 else mask.expand(c, k)
    dead = (live == 0) & (~fail_k)[:, None]
    if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
        raise AssertionError(f"{label} {name}: a dead slot moved")


def check_b6c_kernel(frc, fr, rhmc_mod, configs, dev):
    """Phase 18a: B6c against its plain version, chain by chain (float64 as
    arbiter), at the drawn 64x64 field with K = 20 (64 chains, shared mask,
    cfg1's 16 steps x 6 sweeps) and at cfg4's shape (128x128, K = 64, 16
    particles with 30..64 live stars, B4's step over 3, 6 x 4, beta 1 and
    0.3; float64 on the first 8), at the edges of its domain (B6C_EDGES,
    beta 0.7), the same bits for a chain alone, among 7 others and among
    300, a chain that overflows, and one timed trajectory at cfg4's full
    width (4096 particles), its first 16 particles held against the plain
    version, which is timed on those 16; then the kernel timed at the rhmc
    leg's shape (64 chains, K = 20, 16 x 6, shared mask) and at cfg5's rhmc
    move's (256 chains, K_max 24, 6 x 4, per-chain masks) on the drawn
    64x64 field, each beside its bound (rhmc_full_sparse_ops).  Phase 18b
    holds the kernel at each run's own state and step.  Returns the largest
    theta error and the times."""
    import torch

    from starcat_torch.configs import apply_overrides

    wide = apply_overrides(configs["cfg1_rhmc"], B6C_RHMC)
    w_truth, w_image = wide.make_data()
    w_img, w_spec, prior = w_image.to(dev), wide.scene, wide.prior
    cfg4 = configs["cfg4_crowded"]
    c_truth, c_image = cfg4.make_data()
    c_img, c_spec = c_image.to(dev), cfg4.scene
    err = 0.0

    theta, xi, eps, mask = _rhmc_inputs(w_truth, 64, 20, dev, 60, False)
    err = max(err, _hold_b6c(frc, fr, "64x64 K=20 (64 chains, 16 x 6)", w_spec, w_img, prior,
                             20, 16, 6, theta, xi, eps / 3.0, mask, 1.0, 64, False))
    # B4's inputs at a third of its step: at B4's own step (0.04-0.06) 4 of
    # 16 particles at beta 0.3 do not converge to TIGHT on the H100, in the
    # kernel and the plain version alike, below _compare_chains' 80%; the
    # step the cfg4 mutation takes is held in phase 18b on its own state
    for i, beta in enumerate((1.0, 0.3)):
        theta, xi, eps, mask = b4_inputs(c_truth, 16, 64, dev, 61 + i, True)
        err = max(err, _hold_b6c(frc, fr, f"cfg4 shape beta={beta} (16 particles, 6 x 4)",
                                 c_spec, c_img, cfg4.prior, 64, 6, 4, theta, xi, eps / 3.0,
                                 mask, beta, 8, True))
    for i, (c, k, h, w) in enumerate(B6C_EDGES):
        e_spec, e_img, theta, xi, eps, mask = _cut_inputs(h, w, k, c, dev, 63 + i)
        err = max(err, _hold_b6c(frc, fr, f"edge C={c} K={k} {h}x{w}", e_spec, e_img,
                                 cfg4.prior, k, 6, 4, theta, xi, eps, mask, 0.7, 0, h == 128))

    # nothing of one chain reaches another through the workspace: a chain's
    # bits alone, among 7 others and among 300, and on a rerun
    e_spec, e_img, theta, xi, eps, mask = _cut_inputs(49, 49, 16, 300, dev, 68)
    fused = frc.make_fused_rhmc(e_spec, e_img, cfg4.prior, 16, 6, 4)
    full = fused(theta, xi, eps, mask)
    if not _same_bits(full, fused(theta, xi, eps, mask)):
        raise AssertionError("B6c: a rerun gave other bits")
    for idx in ([5], [0, 9, 17, 5, 41, 52, 63, 299]):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(),
                     mask[sel].contiguous())
        if not _same_bits(part, [o[sel] for o in full]):
            raise AssertionError(f"B6c: chains {idx} differ from the 300-chain launch")
    print("B6c: chain 5 gives the same bits alone, among 7 others and among 300 "
          f"({frc.launch_layout(300, 16, 49, 49)}), and on a rerun")

    # a chain that overflows (exp(95) > float32's range): NaN residual,
    # reported by the transition as a solver failure and rejected
    c = 64
    theta, xi, eps, mask = _rhmc_inputs(w_truth, c, 20, dev, 69, True)
    theta[0, :, 2] = 95.0
    fused = frc.make_fused_rhmc(w_spec, w_img, prior, 20, 6, 4)
    out = fused(theta, xi, eps / 3.0, mask)
    new, info = rhmc_mod.rhmc_transition(
        rhmc_mod.ChainState(theta, torch.zeros(c, device=dev), torch.zeros_like(theta)), xi,
        torch.full((c,), 0.5, device=dev), torch.full((c,), 0.01, device=dev),
        fused, torch.tensor(0.01, device=dev), mask)
    if not (bool(torch.isnan(out[5][0])) and bool(info.solver_fail[0])
            and not bool(info.accepted[0]) and torch.equal(new.theta[0], theta[0])):
        raise AssertionError(f"B6c: the overflowing chain was not a solver failure "
                             f"(resid {float(out[5][0])})")
    if not bool(torch.isfinite(out[5][1:]).all()):
        raise AssertionError("B6c: the overflowing chain reached another chain")
    print(f"B6c overflowing chain: resid NaN -> solver failure, rejected; "
          f"the other {c - 1} chains finite")

    # one trajectory at cfg4's full width, the plain version on 16 particles
    n_steps, fpi = cfg4.smc.n_leapfrog, cfg4.smc.fixed_point_iters
    p_all = cfg4.smc.n_particles
    fused = frc.make_fused_rhmc(c_spec, c_img, cfg4.prior, 64, n_steps, fpi)
    theta, xi, eps, mask = b4_inputs(c_truth, p_all, 64, dev, 70, True)
    eps = eps / 3.0
    t0 = time.perf_counter()
    fused(theta, xi, eps, mask, 1.0)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if first > 60.0:
        print(f"B6c: one trajectory of {p_all} particles took {first:.1f} s; timing 1024")
        p_all = 1024
        theta, xi, eps, mask = (t[:p_all].contiguous() for t in (theta, xi, eps, mask))
    last = []
    counts = mask.sum(1).tolist()
    ms = {"b6c": _time_ms(lambda: last.append(fused(theta, xi, eps, mask, 1.0)), 2, warmup=0),
          "particles": p_all,
          "ops": rhmc_full_sparse_ops(theta, mask, c_spec, n_steps, fpi),
          "ops_dense": sum(rhmc_full_crowded_ops(1, int(n), 128, 128, n_steps, fpi)
                           for n in counts),
          "ops_b6_count": sum(rhmc_full_ops(1, int(n), 128, 128, n_steps, fpi)
                              for n in counts)}
    sub = tuple(t[:16].contiguous() for t in (theta, xi, eps, mask))
    plain = []
    ms["b6c_plain"] = _time_ms(lambda: plain.append(fr.fused_rhmc_reference(
        c_spec, c_img, cfg4.prior, *sub, 1.0, n_steps, fpi)), 1, warmup=0)
    ms["plain_particles"] = 16
    # the kernel on the same 16, for a like-for-like reading of the plain time
    ms["b6c_16"] = _time_ms(lambda: fused(*sub, 1.0), 2, warmup=1)
    err = max(err, _compare_chains(f"B6c timed launch, the first 16 of {p_all} particles",
                                   [o[:16] for o in last[-1]], plain[-1], h_spacings=8,
                                   p_rel=True))
    lay = frc.launch_layout(p_all, 64, 128, 128)
    print(f"B6c ({p_all} particles, K=64, {int(mask.sum())} live stars, 128x128, {n_steps} "
          f"steps x {fpi} sweeps): kernel {ms['b6c']:.3f} ms per trajectory; on 16 of them "
          f"kernel {ms['b6c_16']:.3f} ms, plain {ms['b6c_plain']:.3f} ms; layout {lay}")

    # the kernel at the rhmc leg's shape (64 chains, K = 20, 16 x 6, shared
    # mask) and at cfg5's rhmc move's (256 chains, K_max 24, 6 x 4, per-chain
    # masks), both on the drawn 64x64 field, each beside its bound
    cfg5 = apply_overrides(configs["cfg5_transdim_mcmc"], B6C_CFG5)
    ms["shapes"] = {}
    for label, c, k, n_steps, fpi, seed, per_chain in (
            ("rhmc_leg", 64, 20, wide.rhmc.n_leapfrog, wide.rhmc.fixed_point_iters, 60, False),
            ("cfg5_rhmc", cfg5.n_chains, 24, cfg5.tdm.n_leapfrog, cfg5.tdm.fixed_point_iters,
             61, True)):
        theta, xi, eps, mask = _rhmc_inputs(w_truth, c, k, dev, seed, per_chain)
        fused = frc.make_fused_rhmc(w_spec, w_img, prior, k, n_steps, fpi)
        t = _time_ms(lambda: fused(theta, xi, eps / 3.0, mask, 1.0), 3, warmup=1)
        counts = mask.sum(1).tolist() if per_chain else [k] * c
        nbytes = rhmc_bytes(c, k, 64, 64, per_chain)
        b = bound_ms(rhmc_full_sparse_ops(theta, mask, w_spec, n_steps, fpi), nbytes)
        dense = bound_ms(sum(rhmc_full_crowded_ops(1, int(n), 64, 64, n_steps, fpi)
                             for n in counts), nbytes)[0]
        ms["shapes"][label] = {"chains": c, "k": k, "n_steps": n_steps, "fpi": fpi,
                               "live_stars": int(sum(counts)), "ms": t, "bound_ms": b[0],
                               "bound_by": b[1], "bound_ms_dense": dense}
        print(f"B6c {label} ({c} chains, K={k}, {int(sum(counts))} live stars, 64x64, {n_steps} "
              f"x {fpi}): kernel {t:.3f} ms per trajectory, bound {b[0]:.4f} ms ({b[1]}), "
              f"{100 * b[0] / t:.2f}% of it (every pixel of every pair: {dense:.4f} ms); "
              f"layout {frc.launch_layout(c, k, 64, 64)}")
    return err, ms


def _run_state(out, dev, seed, n=None):
    """The next transition's inputs from a run's last state: each chain's
    (or particle's) last draw and mask, standard-normal xi and the run's
    adapted step jittered by +-20% per chain, as rhmc_transition does; the
    first n chains only, given n."""
    import torch

    theta = torch.as_tensor(out.thetas[:n, -1], dtype=torch.float32)
    m = out.masks
    mask = torch.as_tensor(m if m.ndim == 1 else (m[:n, -1] if m.ndim == 3 else m[:n]),
                           dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    theta, mask = theta.to(dev).contiguous(), mask.to(dev).contiguous()
    xi = torch.randn(theta.shape, generator=gen, device=dev)
    eps = out.stats["step_size"] * (
        0.8 + 0.4 * torch.rand((theta.shape[0],), generator=gen, device=dev))
    return theta, xi, eps, mask


def run_full_crowded_slice(api, configs, dev, frc, fr):
    """Phase 18b: the full metric beyond B6's domain through the public API,
    B6c's launch count set to 0 just before each run and read just after:
    the rhmc head on the drawn 64x64 field (B6C_RHMC, then the same on the
    diagonal metric, B4), cfg4 with the full-metric mutation (B6C_CFG4,
    then with the preset's diagonal one) and cfg5 with the full-metric
    move (B6C_CFG5).  After each B6c run (its count read), B6c is held
    at that run's shape on its last state, at its adapted step and
    temperature (_run_state, _arbitrate): the rhmc head's 64 chains and
    cfg5's 256 chains with their per-chain masks, 80% of them converged,
    and the first B6C_CFG4_HELD of cfg4's particles at beta ~0.006, where
    the full metric's mutation fails the solver on most particles (the run
    rejects those), at least 8 of them converged.  Returns B6c's
    launches."""
    import numpy as np
    import torch

    from starcat_torch.configs import apply_overrides

    launches = 0

    def run(name, over, want_kernel):
        nonlocal launches
        cfg = apply_overrides(configs[name], over)
        frc.reset_launch_counts()
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = frc.LAUNCHES
        st = out.stats
        if st["trajectory_kernel"] != want_kernel or st["kernel_launches"] <= 0:
            raise AssertionError(f"{name} {over} did not run through {want_kernel}: "
                                 f"{st['trajectory_kernel']} x{st['kernel_launches']}")
        if want_kernel == "B6c":
            if n <= 0 or n != st["kernel_launches"]:
                raise AssertionError(f"{name} {over}: B6c launches {n}, the run's "
                                     f"{st['kernel_launches']}")
            launches += n
        if cfg.head in ("smc", "transdim"):
            sweep_launches(f"{name} {over}", st)
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{name} {over}: non-finite draws")
        print(f"B6c slice {name} {json.dumps(over)}: {wall:.3f} s wall, "
              f"{st['trajectory_kernel']} x{st['kernel_launches']}, accept {st['accept']:.3f}, "
              f"step {st['step_size']:.5f}, solver rejections {st.get('solver_rejections')}")
        return out, api.summarize_output(out)

    def hold(label, out, sub, beta, n, crowded, seed, min_conv):
        """B6c at a run's shape on its last state (launched after the
        run's count was read)."""
        cfg = out.config
        image = cfg.make_data()[1].to(dev)
        theta, xi, eps, mask = _run_state(out, dev, seed, n)
        return _arbitrate("B6c", frc.make_fused_rhmc, fr.fused_rhmc_reference,
                          f"{label} on the run's last state (beta {beta:.6f}, "
                          f"step {out.stats['step_size']:.5f})", cfg.scene, image,
                          cfg.prior, cfg.kmax, sub.n_leapfrog, sub.fixed_point_iters,
                          theta, xi, eps, mask, beta, crowded, min_conv)

    full, s_full = run("cfg1_rhmc", B6C_RHMC, "B6c")
    hold("rhmc head 64x64 K=20 (64 chains, 16 x 6)", full, full.config.rhmc, 1.0, None,
         False, 71, 0.8 * full.thetas.shape[0])
    diag, s_diag = run("cfg1_rhmc", {**B6C_RHMC, "rhmc.metric": "diag"}, "B4")
    truth = float(np.sum(full.stats["truth"]["f"]))
    tf, td = s_full["total_flux"], s_diag["total_flux"]
    se = float(np.hypot(tf["mcse"], td["mcse"]))
    print(f"rhmc on the drawn 64x64 field: total flux full {tf['mean']:.2f} ± {tf['sd']:.2f} "
          f"(ESS {tf['ess']:.0f}, R-hat {tf['rhat']:.4f}), diagonal {td['mean']:.2f} ± "
          f"{td['sd']:.2f} (ESS {td['ess']:.0f}); truth {truth:.2f}; combined standard "
          f"error {se:.3f}")
    if not abs(tf["mean"] - truth) <= 4 * tf["sd"]:
        raise AssertionError(f"rhmc full on the 64x64 field: total flux {tf['mean']} ± "
                             f"{tf['sd']} vs the drawn truth {truth}")
    if not abs(tf["mean"] - td["mean"]) <= 4 * se:
        raise AssertionError(f"rhmc full vs diag on the 64x64 field: {tf['mean']} vs "
                             f"{td['mean']}, combined standard error {se}")

    rows = {}
    for label, over, kernel in (("full", B6C_CFG4, "B6c"),
                                ("diagonal", {"smc.max_steps": 2}, "B4")):
        out, summ = run("cfg4_crowded", over, kernel)
        st = out.stats
        if kernel == "B6c":
            hold(f"cfg4 mutation 128x128 K=64 ({B6C_CFG4_HELD} of {out.thetas.shape[0]} "
                 f"particles, 6 x 4)", out, out.config.smc, st["beta"], B6C_CFG4_HELD, True,
                 72, 8)
        rows[label] = (st["beta"], st["log_z"], st["accept"], summ["star_count"]["mean"])
        if not (0.0 < st["beta"] and np.isfinite(st["log_z"]) and st["n_temp_steps"] == 2):
            raise AssertionError(f"cfg4 {label}: beta {st['beta']}, log Z {st['log_z']} "
                                 f"after {st['n_temp_steps']} steps")
    for label, (beta, log_z, acc, mean_n) in rows.items():
        print(f"cfg4 after 2 temperature steps, {label} metric: beta {beta:.6f}, log Z "
              f"{log_z:.3f}, accept {acc:.3f}, mean star count {mean_n:.3f}")

    out, _ = run("cfg5_transdim_mcmc", B6C_CFG5, "B6c")
    hold("cfg5 trans-d 64x64 K=24 (256 chains, 6 x 4)", out, out.config.tdm, 1.0, None,
         False, 73, 0.8 * out.thetas.shape[0])
    return launches


# phase 19: B5 and B4 over their TPU kernels' whole domains.  The slice's
# scene is cfg4's star density (50 stars on 128x128) on a 192x192 field:
# 112 stars.  Run 1 is cfg4's SMC on it at K_max 125 (B4's gate edge
# there) and the preset's widths (4096 particles, twelve residual-birth
# sweeps and two 6 x 4 diagonal mutations a step), cut from up to 250
# temperature steps to 2; run 2 the crowded ChEES head at 1024 chains and
# K = 112 (a fixed-K head's K is the star count, as in the JAX package),
# cut from 500 + 1000 to 100 + 100 at most 64 steps a trajectory (1024),
# with no warmup extension or equilibration stage (2 and 2): there a step
# costs 1.4 ms and an uncut trajectory up to 1024 of them.  The uncut runs
# (scripts/wide_runs.py): PERF.md.
WIDE_SLICE = {"scene.height": 192, "scene.width": 192, "n_stars": 112}
WIDE_RUN1 = {**WIDE_SLICE, "kmax": 125, "smc.max_steps": 2}
WIDE_RUN2 = {**WIDE_SLICE, "kmax": 112, "head": "chees", "n_chains": 1024, "n_warmup": 100,
             "n_samples": 100, "chees.max_leapfrog": 64, "chees.max_warmup_extensions": 0,
             "chees.max_eq_stages": 0}
WIDE_HELD = 256  # run 1's particles held against the plain version
# (H, W, K) at the TPU gates' edges (tests/test_torch_wide_fields.py) and
# at a non-square interior shape, with the chains of each launch
B5_WIDE = ((128, 128, 667, 5), (192, 192, 361, 7), (256, 256, 183, 9), (352, 128, 179, 6),
           (200, 136, 300, 8))
B4_WIDE = ((128, 128, 254, 5), (192, 192, 125, 7), (256, 256, 47, 9), (304, 96, 89, 6),
           (200, 136, 100, 8))


def _wide_scene(configs, h, w, n=None):
    """A drawn h x w field at cfg4's star density, or of n stars: (the
    config, the truth, the image on the host)."""
    from starcat_torch.configs import apply_overrides

    n = max(1, round(50 * h * w / (128 * 128))) if n is None else n
    cfg = apply_overrides(configs["cfg4_crowded"],
                          {"scene.height": h, "scene.width": w, "n_stars": n})
    truth, image = cfg.make_data()
    return cfg, truth, image


def check_wide_kernels(flc, fl, frdc, frd, configs, dev):
    """Phase 19a: B5 and B4 beyond their one-tile domains, each on a drawn
    field at cfg4's density, at the TPU gates' edges and at 200x136
    (B5_WIDE, B4_WIDE): B5 an L = 10 trajectory against its plain version
    with float64 as arbiter (_b5_compare), shared masks and per-chain
    masks with scattered dead slots by turns; B4 a 6 x 4 trajectory chain
    by chain (_compare_chains, float64 for the looser chains), per-chain
    and shared masks by turns, beta 1 and 0.7 from a device scalar, at a
    third of b4_inputs' step (as phase 18a holds B6c at cfg4's shape); dead
    slots frozen.  Then the same bits on a rerun and for chains alone or
    among others at the slice's 192x192 shape, and both kernels timed
    there: B5 at 1024 chains, K = 112, L = 10, entry gradient in (run 2's
    width), B4 at 4096 particles, K = 125 with 30..125 live, 6 x 4 (run
    1's), the plain version on the first WIDE_HELD.  Returns the largest
    theta errors and the times."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(90)
    err5 = err4 = 0.0
    for i, (h, w, k, c) in enumerate(B5_WIDE):
        cfg, truth, image = _wide_scene(configs, h, w)
        img = image.to(dev)
        theta, p, eps = _crowded_inputs(truth, c, k, dev, 90 + i)
        eps = 0.002 * eps
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        mask, g0 = torch.ones(k, device=dev), None
        if i % 2:  # per-chain masks and the entry gradient in
            mask = (torch.rand((c, k), generator=gen, device=dev) < 0.8).to(torch.float32)
            p = p * mask[..., None]
            g0 = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                             mask, 0, None)[3]
        fused = flc.make_fused_leapfrog(cfg.scene, img, cfg.prior, k, 10)
        out = fused(theta, p, eps, inv_mass, mask, grad=g0)
        want = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                           mask, 10, g0)
        want64 = fl.fused_leapfrog_reference(
            cfg.scene, img.double(), cfg.prior, theta.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), 10, None if g0 is None else g0.double())
        name = (f"wide {h}x{w} K={k} ({c} chains, "
                f"{'per-chain mask, gradient in' if i % 2 else 'shared mask'})")
        own = lambda th: fl.fused_leapfrog_reference(  # noqa: E731
            cfg.scene, img.double(), cfg.prior, th.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), 0, None)
        err5 = max(err5, _b5_compare(name, out, want, want64, at_own=own)[0])
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = live == 0
        if not torch.equal(out[0][dead], theta[dead]) or not bool((out[3][dead] == 0).all()):
            raise AssertionError(f"B5 {name}: a dead slot moved or has a gradient")
    for i, (h, w, k, c) in enumerate(B4_WIDE):
        cfg, truth, image = _wide_scene(configs, h, w)
        img = image.to(dev)
        per_chain = i % 2 == 0
        theta, xi, eps, mask = b4_inputs(truth, c, k, dev, 95 + i, per_chain)
        eps = eps / 3.0
        beta = 1.0 if per_chain else 0.7
        out = frdc.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, k, 6, 4)(
            theta, xi, eps, mask, torch.tensor(beta, device=dev))
        ref = frd.fused_rhmc_diag_reference(cfg.scene, img, cfg.prior, theta, xi, eps, mask,
                                            beta, 6, 4)
        ref64 = frd.fused_rhmc_diag_reference(cfg.scene, img.double(), cfg.prior,
                                              theta.double(), xi.double(), eps.double(),
                                              mask.double(), beta, 6, 4)
        name = (f"B4 wide {h}x{w} K={k} ({c} chains, {'per-chain' if per_chain else 'shared'} "
                f"mask, beta {beta})")
        err4 = max(err4, _compare_chains(name, out, ref, ref64, h_spacings=8, p_rel=True))
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = (live == 0) & (out[5] < SOLVER_TOL)[:, None]
        if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
            raise AssertionError(f"{name}: a dead slot moved")

    # the same bits on a rerun and for chains alone or among 8 others, at
    # the slice's shape, per-chain masks
    cfg, truth, image = _wide_scene(configs, 192, 192)
    img, spec, prior = image.to(dev), cfg.scene, cfg.prior
    theta, xi, eps, mask = b4_inputs(truth, 9, 125, dev, 101, True)
    b4 = frdc.make_fused_rhmc_diag(spec, img, prior, 125, 6, 4)
    p = xi * mask[..., None]
    inv_mass = torch.full((125, 3), 0.9, device=dev)
    b5 = flc.make_fused_leapfrog(spec, img, prior, 125, 10)
    for name, fused, args in (("B4", b4, (theta, xi, eps / 3.0, mask)),
                              ("B5", b5, (theta, p, 0.002 * eps, inv_mass, mask))):
        full = fused(*args)
        if not _same_bits(full, fused(*args)):
            raise AssertionError(f"{name} wide: a rerun gave other bits")
        for idx in ([4], [0, 8, 4, 2]):
            sel = torch.tensor(idx, device=dev)
            part = fused(*(a if a is inv_mass else a[sel].contiguous() for a in args))
            if not _same_bits(part, [o[sel] for o in full]):
                raise AssertionError(f"{name} wide: chains {idx} differ from the 9-chain launch")
    # a chain that overflows (exp(95) > float32's range) on each wide path:
    # B4's residual NaN (a solver failure), B5's energy not finite; the
    # other chains finite
    th_o = theta.clone()
    th_o[0, :, 2] = 95.0
    o4 = b4(th_o, xi, eps / 3.0, mask)
    o5 = b5(th_o, p, 0.002 * eps, inv_mass, mask)
    if not (bool(torch.isnan(o4[5][0])) and bool(torch.isfinite(o4[5][1:]).all())
            and not bool(torch.isfinite(o5[2][0])) and bool(torch.isfinite(o5[2][1:]).all())):
        raise AssertionError(f"wide paths: the overflowing chain gave B4 resid {o4[5].tolist()}, "
                             f"B5 u {o5[2].tolist()}")
    print("B4 and B5 wide at 192x192 K=125: the same bits on a rerun and for chains alone or "
          "among others; an overflowing chain NaN (B4) or not finite (B5), the others finite")

    # timed at the slice's shapes
    c5, k5, L = 1024, 112, 10
    theta, p, e5 = _crowded_inputs(truth, c5, k5, dev, 102)
    e5 = 0.002 * e5
    m5, im5 = torch.ones(k5, device=dev), torch.full((k5, 3), 0.9, device=dev)
    b5 = flc.make_fused_leapfrog(spec, img, prior, k5, L)
    g0 = fl.fused_leapfrog_reference(spec, img, prior, theta, p, e5, im5, m5, 0, None)[3]
    ms = {"b5": _time_ms(lambda: b5(theta, p, e5, im5, m5, grad=g0), 5, warmup=1),
          "b5_plain": _time_ms(lambda: fl.fused_leapfrog_reference(
              spec, img, prior, theta, p, e5, im5, m5, L, g0), 2, warmup=1),
          "b5_chains": c5, "b5_k": k5, "b5_layout": flc.launch_layout(c5, k5, 192, 192)}
    p_all = configs["cfg4_crowded"].smc.n_particles
    theta, xi, eps, mask = b4_inputs(truth, p_all, 125, dev, 103, True)
    sub = tuple(t[:WIDE_HELD].contiguous() for t in (theta, xi, eps, mask))
    ms.update(b4=_time_ms(lambda: b4(theta, xi, eps, mask, 1.0), 2, warmup=1),
              b4_plain=_time_ms(lambda: _plain_chunked(
                  frd.fused_rhmc_diag_reference, spec, img, prior, *sub, 1.0, 6, 4), 1,
                  warmup=0),
              b4_same=_time_ms(lambda: b4(*sub, 1.0), 2, warmup=1),
              b4_particles=p_all, b4_plain_particles=WIDE_HELD, b4_live=int(mask.sum()))
    # B4's wide path forced onto cfg4's shape (a launch with a workspace
    # takes it), against the one-tile path there, float64 deciding where
    # their roundings part (the wide path's pixel offsets are exact
    # differences): why both stay
    from starcat_torch import build

    cfg4 = configs["cfg4_crowded"]
    t4, i4 = cfg4.make_data()
    i4 = i4.to(dev)
    args = b4_inputs(t4, cfg4.smc.n_particles, 64, dev, 48, True)
    scal = build.riemannian_scalars(cfg4.scene, cfg4.prior, 1e-3)
    work = torch.empty(args[0].shape[0] * frdc.workspace_floats(64, 128, 128), device=dev)
    forced = lambda: build.launch_riemannian(  # noqa: E731
        "fused_rhmc_diag_crowded", i4, 64, 6, 4, scal, *args, 1.0,
        workspace=(work, args[0].shape[0]))
    one = frdc.make_fused_rhmc_diag(cfg4.scene, i4, cfg4.prior, 64, 6, 4)
    _hold_two_paths("B4 wide path forced at cfg4's shape, against the one-tile path", forced(),
                    one(*args, 1.0), lambda idx: frd.fused_rhmc_diag_reference(
                        cfg4.scene, i4.double(), cfg4.prior,
                        *(a[idx].double() for a in args), 1.0, 6, 4),
                    args[3], args[0])
    ms.update(b4_cfg4_one_tile=_time_ms(lambda: one(*args, 1.0), 2, warmup=1),
              b4_cfg4_wide=_time_ms(forced, 2, warmup=1))
    print(f"B4 at cfg4's shape (4096 particles, K=64, 128x128): one-tile path "
          f"{ms['b4_cfg4_one_tile']:.3f} ms, wide path forced {ms['b4_cfg4_wide']:.3f} ms")
    print(f"B5 wide ({c5} chains, K={k5}, 192x192, L={L}): kernel {ms['b5']:.4f} ms, plain "
          f"{ms['b5_plain']:.4f} ms per trajectory; layout {ms['b5_layout']}")
    print(f"B4 wide ({p_all} particles, K=125, {ms['b4_live']} live stars, 192x192, 6 x 4): "
          f"kernel {ms['b4']:.3f} ms per trajectory; on {WIDE_HELD} of them kernel "
          f"{ms['b4_same']:.3f} ms, plain {ms['b4_plain']:.3f} ms")
    return err5, err4, ms


def _hold_two_paths(name, out, ref, plain64, mask, theta):
    """Two float32 paths of one kernel on the same inputs (B4's wide path
    forced onto a shape of its one-tile path, ``out``, against that path,
    ``ref``), chain by chain: solver verdicts agree on at least 99% of the
    chains and at least 80% converge tightly in both; on those, every
    output of ``out`` lies within _compare_chains' bar of ``ref``'s (the
    energies eight float32 spacings, p relative to 1 + |p|), or float64
    decides: ``plain64(idx)`` runs the float64 plain version on those
    chains only, and where ``ref`` lies within the bar of it in every
    output (a well-conditioned chain), ``out`` must lie no farther from it
    than ``ref`` plus the bar.  Where ``ref`` itself parts from float64
    beyond the bar, the chain amplifies float32 rounding in any program and
    its distances are only printed.  Dead slots frozen.  Returns the
    largest theta distance between the two on the tight chains."""
    import torch

    c = theta.shape[0]
    fail_o, fail_r = ~(out[5] < SOLVER_TOL), ~(ref[5] < SOLVER_TOL)
    disagree = int((fail_o != fail_r).sum())
    tight = (out[5] < TIGHT) & (ref[5] < TIGHT)
    names = ("theta", "p", "h0", "h1", "u1")
    tol = {nm: _h_tol(ref[i][tight], 8) if nm[0] in "hu" else RTOL[nm]
           for i, nm in enumerate(names)}

    def dist(nm, a, b):
        d = (a.double() - b.double()).abs()
        return _per_chain(d / (1.0 + b.double().abs()) if nm == "p" else d)

    e = {nm: dist(nm, out[i], ref[i]) for i, nm in enumerate(names)}
    beyond = torch.zeros_like(tight)
    for nm in names:
        beyond |= tight & (e[nm] > tol[nm])
    print(f"{name}: solver failures {int(fail_o.sum())} and {int(fail_r.sum())}, disagreeing "
          f"{disagree} of {c}; on the {int(tight.sum())} tight chains "
          f"{json.dumps({nm: float(e[nm][tight].max()) for nm in names})}, beyond a bar on "
          f"{int(beyond.sum())}; tolerances {json.dumps(tol)}")
    if disagree > 0.01 * c:
        raise AssertionError(f"{name}: {disagree} chains' solver verdicts disagree")
    if int(tight.sum()) < 0.8 * c:
        raise AssertionError(f"{name}: only {int(tight.sum())} of {c} chains converged")
    idx = beyond.nonzero()[:, 0]
    if idx.numel():
        z = plain64(idx)
        well = z[5] < TIGHT
        dk = {nm: dist(nm, out[i][idx], z[i]) for i, nm in enumerate(names)}
        dr = {nm: dist(nm, ref[i][idx], z[i]) for i, nm in enumerate(names)}
        for nm in names:
            well &= dr[nm] <= tol[nm]
        far = {nm: (float(dk[nm][well].max()), float(dr[nm][well].max()))
               if bool(well.any()) else None for nm in names}
        print(f"{name}: of the {idx.numel()} chains beyond a bar, {int(well.sum())} "
              f"well-conditioned; there from float64 (forced path, other path) "
              f"{json.dumps(far)}; on the others theta "
              f"{float(dk['theta'][~well].max()) if bool((~well).any()) else 0.0} and "
              f"{float(dr['theta'][~well].max()) if bool((~well).any()) else 0.0}")
        for nm in names:
            bad = well & (dk[nm] > dr[nm] + tol[nm])
            if bool(bad.any()):
                i = int(bad.nonzero()[0, 0])
                raise AssertionError(f"{name}: chain {int(idx[i])}'s {nm} is "
                                     f"{float(dk[nm][i])} from float64, the other path's "
                                     f"{float(dr[nm][i])}")
    live = mask if mask.ndim == 2 else mask.expand(c, theta.shape[1])
    dead = (live == 0) & (~fail_o)[:, None]
    if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
        raise AssertionError(f"{name}: a dead slot moved")
    return float(e["theta"][tight].max())


def _arbitrate_b5(name, out, want, moved, want64, mask, theta, min_well=8):
    """B5's outputs on a run's own state against its plain version's, chain
    by chain with a float64 run of the plain version as arbiter (phase
    18b's _arbitrate for the leapfrog), the float32 plain version from
    theta one float32 spacing up (moved) as the control.  Distances: theta
    absolute; p relative to 1 + |p|, since a run's adapted mass scales p by
    1/sqrt(inv_mass), as phase 6 holds B4's; U with eight float32 spacings
    at its magnitude; the gradient relative to 1 + |g|.  Finite verdicts
    (U) agree on at least 99% of the chains; the kernel lies within TOL of
    float64 in every output on at least as many chains as the plain
    version does, less 1% of them; at least min_well chains are
    well-conditioned (the plain version within TOL of float64 there).  On
    those, a chain is flagged where the kernel lies farther from float64
    than the plain version plus TOL, and the kernel may be flagged on no
    more chains than the control is by the same rule.  Over a long
    trajectory at a run's adapted step a rounding-sized change moves a
    chaotic chain beyond TOL in any float32 program, so phase 18b's rule
    alone (no chain flagged) fails the plain version itself: on the H100
    at run 2's last state, 64 steps, the control was flagged on 37 of the
    382 chains, the kernel on 19 (scripts/b5_run_state_accuracy.py).  Dead
    slots frozen with zero gradient.  Returns the largest
    theta distance between the kernel and the plain version on the
    unflagged well-conditioned chains."""
    import torch

    c = theta.shape[0]
    fin_k, fin_r = torch.isfinite(out[2]), torch.isfinite(want[2])
    disagree = int((fin_k != fin_r).sum())
    fin = fin_k & fin_r & torch.isfinite(want64[2]) & torch.isfinite(moved[2])
    print(f"B5 {name}: U not finite in the kernel on {int((~fin_k).sum())} chains, in the "
          f"plain version on {int((~fin_r).sum())}, disagreeing on {disagree} of {c}")
    if disagree > 0.01 * c:
        raise AssertionError(f"B5 {name}: {disagree} chains' finite verdicts disagree")
    tol = dict(TOL, u=TOL["u"] + _spacings(want64[2][fin], 8))
    rel = {"theta": False, "p": True, "u": False, "grad_rel": True}

    def dist(x, z, nm):
        d = (x.double() - z).abs()
        d = d / (1.0 + z.abs()) if rel[nm] else d
        return d if d.ndim == 1 else _per_chain(d)

    dk, dp, dm = {}, {}, {}
    for nm, a, b, m, z in zip(rel, out, want, moved, want64):
        dk[nm], dp[nm], dm[nm] = dist(a, z, nm), dist(b, z, nm), dist(m, z, nm)
    near_k, well = fin.clone(), fin.clone()
    for nm in rel:
        near_k &= dk[nm] <= tol[nm]
        well &= dp[nm] <= tol[nm]
    flag_k, flag_m = torch.zeros_like(well), torch.zeros_like(well)
    for nm in rel:
        flag_k |= well & (dk[nm] > dp[nm] + tol[nm])
        flag_m |= well & (dm[nm] > dp[nm] + tol[nm])
    by = {nm: [int((well & (d[nm] > dp[nm] + tol[nm])).sum()) for d in (dk, dm)] for nm in rel}
    ok = well & ~flag_k
    far = {nm: (float(dk[nm][ok].max()), float(dp[nm][ok].max()))
           if bool(ok.any()) else None for nm in rel}
    print(f"B5 {name}: within TOL of float64 in every output the kernel on {int(near_k.sum())} "
          f"chains, the plain version (well-conditioned) on {int(well.sum())}; there flagged "
          f"(beyond the plain version + TOL) the kernel on {int(flag_k.sum())}, the control on "
          f"{int(flag_m.sum())}, by output (kernel, control) {json.dumps(by)}; on the others "
          f"against float64 (kernel, plain float32) {json.dumps(far)}; tolerances "
          f"{json.dumps(tol)}")
    if int(near_k.sum()) < int(well.sum()) - 0.01 * c:
        raise AssertionError(f"B5 {name}: the kernel lies near float64 on {int(near_k.sum())} "
                             f"chains, the plain version on {int(well.sum())}")
    if int(well.sum()) < min_well:
        raise AssertionError(f"B5 {name}: only {int(well.sum())} well-conditioned chains")
    if int(flag_k.sum()) > int(flag_m.sum()):
        raise AssertionError(f"B5 {name}: the kernel is flagged on {int(flag_k.sum())} "
                             f"chains, the control on {int(flag_m.sum())}")
    live = mask if mask.ndim == 2 else mask.expand(c, theta.shape[1])
    dead = live == 0
    if not torch.equal(out[0][dead], theta[dead]) or not bool((out[3][dead] == 0).all()):
        raise AssertionError(f"B5 {name}: a dead slot moved or has a gradient")
    return float((out[0][ok] - want[0][ok]).abs().max())


def _hold_b5_run(out, dev, flc, fl, seed):
    """B5 held on a ChEES run's last state, through B2's contract as the
    run calls it: every chain's last draw, momentum drawn as the run draws
    it (standard normal over sqrt(inv_mass)) at the run's adapted step and
    inverse mass, the run's longest trajectory (ceil(T / eps), at most
    chees.max_leapfrog steps) from a device int32, the entry gradient in;
    first (U, grad U) at that state (_b5_compare), then the trajectory
    chain by chain (_arbitrate_b5; the control, the plain version from
    theta one float32 spacing up).  Returns the
    largest theta error."""
    import math

    import torch

    cfg, st = out.config, out.stats
    image = cfg.make_data()[1].to(dev)
    theta = torch.as_tensor(out.thetas[:, -1], dtype=torch.float32).to(dev).contiguous()
    mask = torch.as_tensor(out.masks, dtype=torch.float32).to(dev).contiguous()
    inv_mass = torch.as_tensor(out.inv_mass, dtype=torch.float32).to(dev).contiguous()
    c, k = theta.shape[:2]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = torch.randn(theta.shape, generator=gen, device=dev) / torch.sqrt(inv_mass)
    p = (p * mask[..., None]).contiguous()
    step = st["step_size"]
    eps = torch.full((c,), step, device=dev)
    n = min(max(math.ceil(st["traj_length"] / step), 1), cfg.chees.max_leapfrog)
    spec, prior = cfg.scene, cfg.prior
    fused = flc.make_fused_leapfrog_dyn(spec, image, prior, k)
    label = (f"run 2 {spec.height}x{spec.width} K={k} ({c} chains) on its last state, step "
             f"{step:.5f}, inverse mass {float(inv_mass.min()):.3e}..{float(inv_mass.max()):.3e}")

    def plain(n_steps, g, dtype, th=theta):
        return fl.fused_leapfrog_reference(spec, image.to(dtype), prior, th.to(dtype),
                                           p.to(dtype), eps.to(dtype), inv_mass.to(dtype),
                                           mask.to(dtype), n_steps, g)

    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    at0 = fused(theta, p, eps, inv_mass, mask, zero, None)
    want0 = plain(0, None, torch.float32)
    err0, _ = _b5_compare(f"{label}, L=0", at0, want0, plain(0, None, torch.float64))
    g0 = want0[3]
    n_dev = torch.full((1,), n, dtype=torch.int32, device=dev)
    got = fused(theta, p, eps, inv_mass, mask, n_dev, g0)
    up = torch.nextafter(theta, torch.full_like(theta, math.inf))
    moved = plain(n, plain(0, None, torch.float32, up)[3], torch.float32, up)
    err = _arbitrate_b5(f"{label}, L={n} (T {st['traj_length']:.4f})", got,
                        plain(n, g0, torch.float32), moved, plain(n, None, torch.float64),
                        mask, theta)
    return max(err0, err)


def run_wide_slice(api, configs, dev, flc, frdc, fl, frd):
    """Phase 19b: the slice's two runs through the public API (WIDE_RUN1 on
    B4, WIDE_RUN2 on B5), each kernel's launch count set to 0 just before
    its run and read just after, equal to the run's own count.  After each
    run its kernel is held at the run's shape on its last state: B4 on run
    1's first WIDE_HELD particles at its step and temperature
    (_run_state, _arbitrate); B5 on run 2's 1024 chains at its adapted
    step, inverse mass and longest trajectory (_hold_b5_run).
    Returns each kernel's launches and the largest theta error."""
    import numpy as np
    import torch

    from starcat_torch.configs import apply_overrides

    def run(over, want, mod):
        cfg = apply_overrides(configs["cfg4_crowded"], over)
        flc.reset_launch_counts()
        frdc.reset_launch_counts()
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, st = mod.LAUNCHES, out.stats
        if st["trajectory_kernel"] != want or n <= 0 or n != st["kernel_launches"]:
            raise AssertionError(f"{json.dumps(over)} did not run through {want}: "
                                 f"{st['trajectory_kernel']} x{st['kernel_launches']}, "
                                 f"{want} launches {n}")
        if cfg.head == "smc":
            sweep_launches(json.dumps(over), st)
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{json.dumps(over)}: non-finite draws")
        summ = api.summarize_output(out)
        tf = summ["total_flux"]
        print(f"wide slice {json.dumps(over)}: {wall:.3f} s wall, {want} x{n}, accept "
              f"{st['accept']:.3f}, step {st['step_size']:.5f}; total flux {tf['mean']:.1f} ± "
              f"{tf['sd']:.1f} (R-hat {tf['rhat']:.4f}), truth "
              f"{float(np.sum(st['truth']['f'])):.1f}; star count mean "
              f"{summ['star_count']['mean'] if 'star_count' in summ else cfg.kmax}")
        return out, n

    out1, n4 = run(WIDE_RUN1, "B4", frdc)
    st = out1.stats
    if not (0.0 < st["beta"] and np.isfinite(st["log_z"]) and st["n_temp_steps"] == 2):
        raise AssertionError(f"wide cfg4: beta {st['beta']}, log Z {st['log_z']} after "
                             f"{st['n_temp_steps']} steps")
    cfg = out1.config
    image = cfg.make_data()[1].to(dev)
    theta, xi, eps, mask = _run_state(out1, dev, 104, WIDE_HELD)
    _arbitrate("B4", frdc.make_fused_rhmc_diag, frd.fused_rhmc_diag_reference,
               f"run 1 192x192 K=125 ({WIDE_HELD} of {out1.thetas.shape[0]} particles, 6 x 4) "
               f"on its last state (beta {st['beta']:.6f}, step {st['step_size']:.5f})",
               cfg.scene, image, cfg.prior, cfg.kmax, cfg.smc.n_leapfrog,
               cfg.smc.fixed_point_iters, theta, xi, eps, mask, st["beta"], True, 8)

    out2, n5 = run(WIDE_RUN2, "B5", flc)
    err = _hold_b5_run(out2, dev, flc, fl, 105)
    return {"b4": n4, "b5": n5}, err


# phase 20: the full metric beyond B6c's one-tile domain, on its wide path.
# (H, W, K, chains, per-chain masks) at the edges of the new domain (B4's
# gate at K <= 256: 128x128 K = 254, 192x192 K = 125, 256x256 K = 47,
# 304x96 K = 89), at 200x136, and one past each one-tile edge (32x32 K =
# 65, 129x128 K = 10), each on a drawn field at cfg4's density.  R1 is
# cfg4's SMC with the full-metric mutation on the 192x192 slice of phase
# 19 (4096 particles, K_max 125), cut from up to 250 temperature steps to
# 2; R2 the rhmc head on a drawn 128x128 field of 80 stars at K = 80 and
# the preset's 64 chains, cut from 400 + 1000 to 100 + 100.  The uncut
# runs (scripts/wide_runs.py --only smc_full|rhmc_full): PERF.md.
# (H, W, K, chains, per-chain masks, the fraction of b4_inputs' step, the
# drawn field's stars: None at cfg4's density)
B6C_WIDE = ((192, 192, 125, 8, True, 6, None), (128, 128, 254, 6, True, 12, 254),
            (256, 256, 47, 6, False, 6, None), (304, 96, 89, 5, True, 6, None),
            (200, 136, 100, 6, False, 6, None), (32, 32, 65, 6, True, 6, None),
            (129, 128, 10, 7, False, 6, None))
B6C_R1 = {**WIDE_SLICE, "kmax": 125, "smc.mutation": "rhmc", "smc.max_steps": 2}
B6C_R2 = {"scene.height": 128, "scene.width": 128, "n_stars": 80, "kmax": 80, "n_warmup": 100,
          "n_samples": 100}
B6C_WIDE_HELD = 16  # the slice's particles held against the plain version when timed


def check_b6c_wide(frc, fr, configs, dev):
    """Phase 20a: B6c's wide path against its plain version, chain by
    chain with float64 sorting the chains (_hold_b6c_wide), a 6 x 4
    trajectory at a sixth of b4_inputs' step (phase 18a holds B6c at
    cfg4's shape at a third; on the H100 at a third 2 of 8 chains at
    192x192 K = 125 did not converge to TIGHT, the kernel and the plain
    version alike, below _compare_chains' 80%: there more stars share each
    chain's solve), at the 128x128 K = 254 edge a twelfth on a drawn field
    of 254 stars (at cfg4's 50 stars, 204 slots would hold prior-like
    draws), beta 1 (per-chain masks, 30..K live) or 0.7 (shared), at
    B6C_WIDE; the same bits on a rerun and for chains alone or among
    others, and a chain that overflows, at the slice's 192x192 K = 125;
    then one trajectory timed at the slice's shape (4096 particles, K = 125
    with 30..125 live), its first B6C_WIDE_HELD particles held against the
    plain version, which is timed on those, as is the kernel; and the
    128x128 K = 254 edge timed on 4 chains.  Returns the largest theta
    error and the times."""
    import torch

    err = 0.0
    for i, (h, w, k, c, per_chain, frac, n) in enumerate(B6C_WIDE):
        cfg, truth, image = _wide_scene(configs, h, w, n)
        if frc.one_tile(k, h, w) or frc.domain_error(cfg.scene, k) is not None:
            raise AssertionError(f"B6c wide: {h}x{w} K={k} is not on the wide path")
        theta, xi, eps, mask = b4_inputs(truth, c, k, dev, 110 + i, per_chain)
        beta = 1.0 if per_chain else 0.7
        err = max(err, _hold_b6c_wide(
            frc, fr, f"wide {h}x{w} K={k} ({c} chains, {'per-chain' if per_chain else 'shared'} "
            f"mask, beta {beta})", cfg.scene, image.to(dev), cfg.prior, k, 6, 4, theta, xi,
            eps / frac, mask, beta))

    cfg, truth, image = _wide_scene(configs, 192, 192)
    img, spec, prior = image.to(dev), cfg.scene, cfg.prior
    theta, xi, eps, mask = b4_inputs(truth, 9, 125, dev, 120, True)
    eps = eps / 6.0
    fused = frc.make_fused_rhmc(spec, img, prior, 125, 6, 4)
    full = fused(theta, xi, eps, mask)
    if not _same_bits(full, fused(theta, xi, eps, mask)):
        raise AssertionError("B6c wide: a rerun gave other bits")
    for idx in ([4], [0, 8, 4, 2]):
        sel = torch.tensor(idx, device=dev)
        part = fused(theta[sel].contiguous(), xi[sel].contiguous(), eps[sel].contiguous(),
                     mask[sel].contiguous())
        if not _same_bits(part, [o[sel] for o in full]):
            raise AssertionError(f"B6c wide: chains {idx} differ from the 9-chain launch")
    th_o = theta.clone()
    th_o[0, :, 2] = 95.0  # exp(95) overflows float32
    o = fused(th_o, xi, eps, mask)
    if not (bool(torch.isnan(o[5][0])) and bool(torch.isfinite(o[5][1:]).all())):
        raise AssertionError(f"B6c wide: the overflowing chain gave resid {o[5].tolist()}")
    print("B6c wide at 192x192 K=125: the same bits on a rerun and for chains alone or among "
          f"others ({frc.launch_layout(9, 125, 192, 192)}); an overflowing chain NaN, the "
          "others finite")

    p_all = configs["cfg4_crowded"].smc.n_particles
    theta, xi, eps, mask = b4_inputs(truth, p_all, 125, dev, 121, True)
    eps = eps / 6.0
    last = []
    ms = {"b6c": _time_ms(lambda: last.append(fused(theta, xi, eps, mask, 1.0)), 2, warmup=1),
          "particles": p_all, "live": int(mask.sum()),
          "ops": rhmc_full_sparse_ops(theta, mask, spec, 6, 4),
          "layout": frc.launch_layout(p_all, 125, 192, 192)}
    sub = tuple(t[:B6C_WIDE_HELD].contiguous() for t in (theta, xi, eps, mask))
    plain = []
    ms["b6c_plain"] = _time_ms(lambda: plain.append(_plain_chunked(
        fr.fused_rhmc_reference, spec, img, prior, *sub, 1.0, 6, 4)), 1, warmup=0)
    ms["plain_particles"] = B6C_WIDE_HELD
    ms["b6c_same"] = _time_ms(lambda: fused(*sub, 1.0), 2, warmup=1)
    fails = int((~(last[-1][5] < SOLVER_TOL)).sum())
    ms["solver_failures"] = fails
    ref64 = fr.fused_rhmc_reference(spec, img.double(), prior, *(t.double() for t in sub), 1.0,
                                    6, 4)
    err = max(err, _judge_b6c_wide(
        f"wide timed launch, the first {B6C_WIDE_HELD} of {p_all} particles",
        [o[:B6C_WIDE_HELD] for o in last[-1]], plain[-1], ref64, sub[0], sub[3]))
    b = bound_ms(ms["ops"], rhmc_bytes(p_all, 125, 192, 192, True))
    ms["bound_ms"], ms["bound_by"] = b
    print(f"B6c wide ({p_all} particles, K=125, {ms['live']} live stars, 192x192, 6 x 4): "
          f"kernel {ms['b6c']:.3f} ms per trajectory ({fails} solver failures), bound "
          f"{b[0]:.4f} ms ({b[1]}), {100 * b[0] / ms['b6c']:.2f}% of it; on "
          f"{B6C_WIDE_HELD} of them kernel {ms['b6c_same']:.3f} ms, plain "
          f"{ms['b6c_plain']:.3f} ms; layout {ms['layout']}")

    e_cfg, e_truth, e_image = _wide_scene(configs, 128, 128, 254)
    theta, xi, eps, mask = b4_inputs(e_truth, 4, 254, dev, 122, True)
    edge = frc.make_fused_rhmc(e_cfg.scene, e_image.to(dev), e_cfg.prior, 254, 6, 4)
    t = _time_ms(lambda: edge(theta, xi, eps / 6.0, mask, 1.0), 1, warmup=1)
    b = bound_ms(rhmc_full_sparse_ops(theta, mask, e_cfg.scene, 6, 4),
                 rhmc_bytes(4, 254, 128, 128, True))
    ms["edge_254"] = {"chains": 4, "live": int(mask.sum()), "ms": t, "bound_ms": b[0],
                      "bound_by": b[1], "workspace_bytes":
                      frc.launch_layout(4, 254, 128, 128)["workspace_bytes"]}
    print(f"B6c wide at the 128x128 K=254 edge (4 chains, {int(mask.sum())} live stars, 6 x 4): "
          f"kernel {t:.3f} ms per trajectory, bound {b[0]:.4f} ms ({b[1]})")
    return err, ms


def run_b6c_wide_slice(api, configs, dev, frc):
    """Phase 20b: R1 (cfg4's SMC with the full-metric mutation on the
    192x192 slice, B6C_R1) and R2 (the rhmc head at K = 80 on 128x128,
    B6C_R2) through the public API, B6c's launch count set to 0 just
    before each run and read just after, equal to the run's own count;
    each must run through B6c with finite draws.  R2's total flux must lie
    within 4 posterior sd of the drawn truth, as phase 18b holds the rhmc
    head's.  Returns B6c's launches."""
    import numpy as np
    import torch

    from starcat_torch.configs import apply_overrides

    launches = 0
    for name, over in (("cfg4_crowded", B6C_R1), ("cfg1_rhmc", B6C_R2)):
        cfg = apply_overrides(configs[name], over)
        frc.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, st = frc.LAUNCHES, out.stats
        if st["trajectory_kernel"] != "B6c" or n <= 0 or n != st["kernel_launches"]:
            raise AssertionError(f"{name} {json.dumps(over)} did not run through B6c: "
                                 f"{st['trajectory_kernel']} x{st['kernel_launches']}, B6c "
                                 f"launches {n}")
        if cfg.head == "smc":
            sweep_launches(f"{name} {json.dumps(over)}", st)
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{name} {json.dumps(over)}: non-finite draws")
        launches += n
        summ = api.summarize_output(out)
        tf = summ["total_flux"]
        truth = float(np.sum(st["truth"]["f"]))
        print(f"B6c wide slice {name} {json.dumps(over)}: {wall:.3f} s wall, B6c x{n}, accept "
              f"{st['accept']:.3f}, step {st['step_size']:.5f}, solver rejections "
              f"{st.get('solver_rejections')}; total flux {tf['mean']:.1f} ± {tf['sd']:.1f} "
              f"(R-hat {tf['rhat']:.4f}), truth {truth:.1f}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if name == "cfg4_crowded":
            if not (0.0 < st["beta"] and np.isfinite(st["log_z"]) and st["n_temp_steps"] == 2):
                raise AssertionError(f"R1: beta {st['beta']}, log Z {st['log_z']} after "
                                     f"{st['n_temp_steps']} steps")
            print(f"R1 after 2 temperature steps: beta {st['beta']:.6f}, log Z "
                  f"{st['log_z']:.3f}, mean star count {summ['star_count']['mean']:.3f}")
        elif not abs(tf["mean"] - truth) <= 4 * tf["sd"]:
            raise AssertionError(f"R2: total flux {tf['mean']} ± {tf['sd']} vs the drawn "
                                 f"truth {truth}")
    return launches


# phase 21: B5, B4 and B6c beyond their TPU kernels' VMEM gates, where the
# JAX package runs XLA and the port its crowded-field kernels.  The slice's
# scene is cfg4's star density on a 256x256 field (200 stars, truth_seed 11,
# data_seed 12, RunConfig's defaults).  W1 is cfg4's SMC on it at K_max 256
# (B4's gate there: K <= 47) and the preset's widths, cut from up to 250
# temperature steps to 2; W2 the crowded ChEES head on it at K = 200 and
# 1024 chains (B5's gate: K <= 183), cut from 500 + 1000 to 20 + 20 at most
# 64 steps a trajectory, no warmup extension or equilibration stage; W3 W1
# with the full-metric mutation (B6c); W4 the rhmc head on a drawn 128x128
# field of 300 stars at K = 300 (B6c beyond K = 256, D = 900), its 64
# chains, cut from 400 + 1000 to 2 + 2 (a 16 x 6 trajectory of its 64
# chains takes about 9 s on the H100).  The uncut runs
# (scripts/wide_runs.py --only w1 w2 w3 w4, themselves cut): PERF.md.
BEYOND_SLICE = {"scene.height": 256, "scene.width": 256, "n_stars": 200}
W1 = {**BEYOND_SLICE, "kmax": 256, "smc.max_steps": 2}
W2 = {**BEYOND_SLICE, "kmax": 200, "head": "chees", "n_chains": 1024, "n_warmup": 20,
      "n_samples": 20, "chees.max_leapfrog": 64, "chees.max_warmup_extensions": 0,
      "chees.max_eq_stages": 0}
W2_HOLD_SEED = 161  # the momentum of B5's hold at W2's last state
W3 = {**W1, "smc.mutation": "rhmc"}
W4 = {"scene.height": 128, "scene.width": 128, "n_stars": 300, "kmax": 300, "n_warmup": 2,
      "n_samples": 2}
# (H, W, K, chains) one past each old edge and at the JAX package's own
# examples (a 512x512 field, K = 1000 on 128x128), on drawn fields at cfg4's
# density
B5_BEYOND = ((128, 128, 668, 5), (128, 128, 1000, 4), (256, 256, 200, 6), (512, 512, 64, 3))
B4_BEYOND = ((128, 128, 255, 5), (128, 128, 1000, 4), (256, 256, 256, 6), (512, 512, 64, 3))
# (H, W, K, chains, per-chain masks, the fraction of b4_inputs' step,
# n_steps, fixed-point sweeps, the drawn field's stars: None at cfg4's
# density): B6c at the slice's 256x256 K = 256, on 128x128 at K = 257, at
# K = 300 (the whole Cholesky panel in shared memory) and at K = 700 (the
# panel streamed, the per-star vectors in the workspace), and on a 512x512
# field; past the 32-bit thresholds (K = 10923, 15447) the address probe
# holds its slice offsets (check_b6c_addressing)
B6C_BEYOND = ((256, 256, 256, 4, True, 6, 6, 4, 256), (128, 128, 257, 6, False, 48, 6, 4, 257),
              (128, 128, 300, 4, True, 12, 6, 4, 300), (128, 128, 700, 3, False, 96, 2, 2, 700),
              (512, 512, 32, 4, True, 6, 6, 4, None))
# the chains of each timed launch that the plain version runs and is timed on
BEYOND_HELD = {"b4": 32, "b6c": 8, "b6c_w4": 4}


def check_beyond_gates(flc, fl, frdc, frd, frc, fr, configs, dev):
    """Phase 21a: B5, B4 and B6c one past their old edges, each against its
    plain version with float64 as arbiter, on drawn fields at cfg4's
    density (B6c's at K stars where K passes it): B5 an L = 10 trajectory
    (_b5_compare), shared masks and per-chain masks with the entry gradient
    in by turns, at B5_BEYOND; B4 a 6 x 4 trajectory chain by chain
    (_compare_chains) at a third of b4_inputs' step, per-chain masks at beta
    1 and shared ones at 0.7 by turns, at B4_BEYOND; B6c chain by chain
    (_hold_b6c_wide) at B6C_BEYOND.  Then the same bits on a rerun and for
    chains alone or among others (B5 at 128x128 K = 1000, B4 at 256x256 K =
    256, B6c at 128x128 K = 300), B6c's 132 chains at 128x128 K = 257 the
    same bits at a grid of 132 blocks and of 8, and each kernel timed at
    the slice's shapes: B4 4096 particles at K = 256 on 256x256 (6 x 4,
    30..256 live), B5 1024 chains at K = 200 (L = 10, entry gradient in),
    B6c 4096 particles at K = 256 on 256x256 (6 x 4) and W4's 64 chains at
    K = 300 on 128x128 (16 x 6, all live), the plain versions on the first
    BEYOND_HELD of each launch, as is the kernel.  Returns the largest
    theta errors and the times."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(130)
    err5 = err4 = err6 = 0.0
    for i, (h, w, k, c) in enumerate(B5_BEYOND):
        cfg, truth, image = _wide_scene(configs, h, w)
        if flc.one_tile(k, h, w) or flc.domain_error(cfg.scene, k) is not None:
            raise AssertionError(f"B5 beyond: {h}x{w} K={k} is not on the wide path")
        img = image.to(dev)
        theta, p, eps = _crowded_inputs(truth, c, k, dev, 130 + i)
        eps = 0.002 * eps
        inv_mass = torch.full((k, 3), 0.9, device=dev)
        mask, g0 = torch.ones(k, device=dev), None
        if i % 2:  # per-chain masks and the entry gradient in
            mask = (torch.rand((c, k), generator=gen, device=dev) < 0.8).to(torch.float32)
            p = p * mask[..., None]
            g0 = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                             mask, 0, None)[3]
        out = flc.make_fused_leapfrog(cfg.scene, img, cfg.prior, k, 10)(
            theta, p, eps, inv_mass, mask, grad=g0)
        want = fl.fused_leapfrog_reference(cfg.scene, img, cfg.prior, theta, p, eps, inv_mass,
                                           mask, 10, g0)
        want64 = fl.fused_leapfrog_reference(
            cfg.scene, img.double(), cfg.prior, theta.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), 10, None if g0 is None else g0.double())
        name = (f"beyond {h}x{w} K={k} ({c} chains, "
                f"{'per-chain mask, gradient in' if i % 2 else 'shared mask'})")
        own = lambda th: fl.fused_leapfrog_reference(  # noqa: E731
            cfg.scene, img.double(), cfg.prior, th.double(), p.double(), eps.double(),
            inv_mass.double(), mask.double(), 0, None)
        err5 = max(err5, _b5_compare(name, out, want, want64, at_own=own)[0])
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = live == 0
        if not torch.equal(out[0][dead], theta[dead]) or not bool((out[3][dead] == 0).all()):
            raise AssertionError(f"B5 {name}: a dead slot moved or has a gradient")
    for i, (h, w, k, c) in enumerate(B4_BEYOND):
        cfg, truth, image = _wide_scene(configs, h, w)
        if frdc.one_tile(k, h, w) or frdc.domain_error(cfg.scene, k) is not None:
            raise AssertionError(f"B4 beyond: {h}x{w} K={k} is not on the wide path")
        img = image.to(dev)
        per_chain = i % 2 == 0
        theta, xi, eps, mask = b4_inputs(truth, c, k, dev, 135 + i, per_chain)
        eps = eps / 3.0
        beta = 1.0 if per_chain else 0.7
        out = frdc.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, k, 6, 4)(
            theta, xi, eps, mask, torch.tensor(beta, device=dev))
        ref = frd.fused_rhmc_diag_reference(cfg.scene, img, cfg.prior, theta, xi, eps, mask,
                                            beta, 6, 4)
        ref64 = frd.fused_rhmc_diag_reference(cfg.scene, img.double(), cfg.prior,
                                              theta.double(), xi.double(), eps.double(),
                                              mask.double(), beta, 6, 4)
        name = (f"B4 beyond {h}x{w} K={k} ({c} chains, "
                f"{'per-chain' if per_chain else 'shared'} mask, beta {beta})")
        err4 = max(err4, _compare_chains(name, out, ref, ref64, h_spacings=8, p_rel=True))
        live = mask if mask.ndim == 2 else mask.expand(c, k)
        dead = (live == 0) & (out[5] < SOLVER_TOL)[:, None]
        if not torch.equal(out[0][dead], theta[dead]) or bool((out[1][dead] != 0).any()):
            raise AssertionError(f"{name}: a dead slot moved")
    for i, (h, w, k, c, per_chain, frac, n_steps, fpi, n) in enumerate(B6C_BEYOND):
        cfg, truth, image = _wide_scene(configs, h, w, n)
        if frc.one_tile(k, h, w) or frc.domain_error(cfg.scene, k) is not None:
            raise AssertionError(f"B6c beyond: {h}x{w} K={k} is not on the wide path")
        theta, xi, eps, mask = b4_inputs(truth, c, k, dev, 140 + i, per_chain)
        beta = 1.0 if per_chain else 0.7
        mode = (f"{'whole' if frc.full_panel(k) else 'streamed'} panel, vectors in "
                f"{'shared memory' if frc.vectors_in_shared(k) else 'the workspace'}")
        err6 = max(err6, _hold_b6c_wide(
            frc, fr, f"beyond {h}x{w} K={k} ({c} chains, "
            f"{'per-chain' if per_chain else 'shared'} mask, beta {beta}, {n_steps} x {fpi}, "
            f"{mode})", cfg.scene, image.to(dev), cfg.prior, k, n_steps, fpi, theta, xi,
            eps / frac, mask, beta))

    # the same bits on a rerun and for chains alone or among others
    def same_bits(name, fused, args, fixed=()):
        full = fused(*args)
        if not _same_bits(full, fused(*args)):
            raise AssertionError(f"{name}: a rerun gave other bits")
        for idx in ([3], [0, 4, 3, 1]):
            sel = torch.tensor(idx, device=dev)
            part = fused(*(a if j in fixed else a[sel].contiguous()
                           for j, a in enumerate(args)))
            if not _same_bits(part, [o[sel] for o in full]):
                raise AssertionError(f"{name}: chains {idx} differ from the 5-chain launch")

    cfg, truth, image = _wide_scene(configs, 128, 128)
    theta, p, eps = _crowded_inputs(truth, 5, 1000, dev, 145)
    mask = (torch.rand((5, 1000), generator=gen, device=dev) < 0.8).to(torch.float32)
    inv_mass = torch.full((1000, 3), 0.9, device=dev)
    same_bits("B5 beyond 128x128 K=1000",
              flc.make_fused_leapfrog(cfg.scene, image.to(dev), cfg.prior, 1000, 10),
              (theta, p * mask[..., None], 0.002 * eps, inv_mass, mask), fixed=(3,))
    s_cfg, s_truth, s_image = _wide_scene(configs, 256, 256)
    s_img = s_image.to(dev)
    theta, xi, eps, mask = b4_inputs(s_truth, 5, 256, dev, 146, True)
    same_bits("B4 beyond 256x256 K=256",
              frdc.make_fused_rhmc_diag(s_cfg.scene, s_img, s_cfg.prior, 256, 6, 4),
              (theta, xi, eps / 3.0, mask))
    c_cfg, c_truth, c_image = _wide_scene(configs, 128, 128, 300)
    theta, xi, eps, mask = b4_inputs(c_truth, 5, 300, dev, 147, True)
    same_bits("B6c beyond 128x128 K=300",
              frc.make_fused_rhmc(c_cfg.scene, c_image.to(dev), c_cfg.prior, 300, 2, 2),
              (theta, xi, eps / 12.0, mask))
    # the wrapper's grid (one block an SM) against a launch of 8 blocks
    # through build.launch_riemannian with a workspace for 8
    from starcat_torch import build

    g_cfg, g_truth, g_image = _wide_scene(configs, 128, 128, 257)
    g_img = g_image.to(dev)
    theta, xi, eps, mask = b4_inputs(g_truth, 132, 257, dev, 148, True)
    eps = eps / 12.0
    grid = frc.launch_layout(132, 257, 128, 128, dev)["grid"]
    full = frc.make_fused_rhmc(g_cfg.scene, g_img, g_cfg.prior, 257, 2, 2)(theta, xi, eps, mask)
    work = torch.zeros(frc.workspace_bytes(257, 128, 128, 8) // 4, device=dev)
    eight = build.launch_riemannian(
        "fused_rhmc_crowded", g_img, 257, 2, 2,
        build.riemannian_scalars(g_cfg.scene, g_cfg.prior, 1e-3), theta, xi, eps, mask, 1.0,
        workspace=(work, 8))
    if grid != 132 or not _same_bits(full, eight):
        raise AssertionError(f"B6c 128x128 K=257, 132 chains: grids {grid} and 8 gave other "
                             "bits")
    print("B5 (128x128 K=1000), B4 (256x256 K=256) and B6c (128x128 K=300) beyond: the same "
          "bits on a rerun and for chains alone or among others; B6c's 132 chains at "
          "128x128 K=257 the same bits at a grid of 132 blocks and of 8")

    # timed at the slice's shapes
    c5, k5, L = 1024, 200, 10
    theta, p, e5 = _crowded_inputs(s_truth, c5, k5, dev, 150)
    e5 = 0.002 * e5
    m5, im5 = torch.ones(k5, device=dev), torch.full((k5, 3), 0.9, device=dev)
    b5 = flc.make_fused_leapfrog(s_cfg.scene, s_img, s_cfg.prior, k5, L)
    g0 = fl.fused_leapfrog_reference(s_cfg.scene, s_img, s_cfg.prior, theta, p, e5, im5, m5, 0,
                                     None)[3]
    ms = {"b5": _time_ms(lambda: b5(theta, p, e5, im5, m5, grad=g0), 5, warmup=1),
          "b5_plain": _time_ms(lambda: fl.fused_leapfrog_reference(
              s_cfg.scene, s_img, s_cfg.prior, theta, p, e5, im5, m5, L, g0), 1, warmup=1),
          "b5_chains": c5, "b5_k": k5}
    p_all = configs["cfg4_crowded"].smc.n_particles
    theta, xi, eps, mask = b4_inputs(s_truth, p_all, 256, dev, 151, True)
    b4 = frdc.make_fused_rhmc_diag(s_cfg.scene, s_img, s_cfg.prior, 256, 6, 4)
    sub = tuple(t[:BEYOND_HELD["b4"]].contiguous() for t in (theta, xi, eps, mask))
    ms.update(b4=_time_ms(lambda: b4(theta, xi, eps, mask, 1.0), 1, warmup=1),
              b4_plain=_time_ms(lambda: _plain_chunked(
                  frd.fused_rhmc_diag_reference, s_cfg.scene, s_img, s_cfg.prior, *sub, 1.0,
                  6, 4), 1, warmup=0),
              b4_same=_time_ms(lambda: b4(*sub, 1.0), 2, warmup=1),
              b4_particles=p_all, b4_live=int(mask.sum()))
    b6 = frc.make_fused_rhmc(s_cfg.scene, s_img, s_cfg.prior, 256, 6, 4)
    eps = eps / 6.0
    sub = tuple(t[:BEYOND_HELD["b6c"]].contiguous() for t in (theta, xi, eps, mask))
    last, plain = [], []
    ms.update(b6c=_time_ms(lambda: last.append(b6(theta, xi, eps, mask, 1.0)), 1, warmup=0),
              b6c_plain=_time_ms(lambda: plain.append(_plain_chunked(
                  fr.fused_rhmc_reference, s_cfg.scene, s_img, s_cfg.prior, *sub, 1.0, 6, 4)),
                  1, warmup=0),
              b6c_same=_time_ms(lambda: b6(*sub, 1.0), 1, warmup=0),
              b6c_particles=p_all, b6c_live=int(mask.sum()),
              b6c_ops=rhmc_full_sparse_ops(theta, mask, s_cfg.scene, 6, 4),
              b6c_failures=int((~(last[-1][5] < SOLVER_TOL)).sum()),
              b6c_layout=frc.launch_layout(p_all, 256, 256, 256, dev))
    ref64 = fr.fused_rhmc_reference(s_cfg.scene, s_img.double(), s_cfg.prior,
                                    *(t.double() for t in sub), 1.0, 6, 4)
    err6 = max(err6, _judge_b6c_wide(
        f"beyond timed launch, the first {BEYOND_HELD['b6c']} of {p_all} particles",
        [o[:BEYOND_HELD["b6c"]] for o in last[-1]], plain[-1], ref64, sub[0], sub[3]))
    # W4's shape: the rhmc head's 64 chains, 16 x 6, all 300 stars live
    w_cfg, w_truth, w_image = _wide_scene(configs, 128, 128, 300)
    w_img = w_image.to(dev)
    theta, xi, eps, mask = b4_inputs(w_truth, 64, 300, dev, 152, False)
    eps = eps / 12.0
    b6w = frc.make_fused_rhmc(w_cfg.scene, w_img, w_cfg.prior, 300, 16, 6)
    n_w4 = BEYOND_HELD["b6c_w4"]
    sub = (theta[:n_w4].contiguous(), xi[:n_w4].contiguous(), eps[:n_w4].contiguous(), mask)
    ms.update(b6c_w4=_time_ms(lambda: b6w(theta, xi, eps, mask, 1.0), 1, warmup=0),
              b6c_w4_plain=_time_ms(lambda: fr.fused_rhmc_reference(
                  w_cfg.scene, w_img, w_cfg.prior, *sub, 1.0, 16, 6), 1, warmup=0),
              b6c_w4_same=_time_ms(lambda: b6w(*sub, 1.0), 1, warmup=0),
              b6c_w4_ops=rhmc_full_sparse_ops(theta, mask, w_cfg.scene, 16, 6))
    print(f"B5 beyond ({c5} chains, K={k5}, 256x256, L={L}): kernel {ms['b5']:.4f} ms, plain "
          f"{ms['b5_plain']:.4f} ms per trajectory")
    print(f"B4 beyond ({p_all} particles, K=256, {ms['b4_live']} live stars, 256x256, 6 x 4): "
          f"kernel {ms['b4']:.3f} ms per trajectory; on {BEYOND_HELD['b4']} of them kernel "
          f"{ms['b4_same']:.3f} ms, plain {ms['b4_plain']:.3f} ms")
    print(f"B6c beyond ({p_all} particles, K=256, {ms['b6c_live']} live stars, 256x256, 6 x 4): "
          f"kernel {ms['b6c']:.3f} ms per trajectory ({ms['b6c_failures']} solver failures); "
          f"on {BEYOND_HELD['b6c']} of them kernel {ms['b6c_same']:.3f} ms, plain "
          f"{ms['b6c_plain']:.3f} ms; layout {ms['b6c_layout']}")
    print(f"B6c beyond (64 chains, K=300, 128x128, 16 x 6): kernel {ms['b6c_w4']:.3f} ms per "
          f"trajectory; on {BEYOND_HELD['b6c_w4']} of them kernel {ms['b6c_w4_same']:.3f} ms, "
          f"plain {ms['b6c_w4_plain']:.3f} ms")
    return err5, err4, err6, ms


# the address probe's catalogs beside the largest the card holds: the first
# K whose pair sums pass 2^31 - 1 floats (18 K^2) and the first whose dense
# D x D matrices do (D (D + 1), D = 3 K)
PROBE_K = (10923, 15447)
PROBE_MARGIN = 2**28  # bytes left free beside the largest slice


def check_b6c_addressing(frc, dev):
    """Phase 21c: B6c's slice addressing beyond both 32-bit thresholds, where
    a trajectory (a Cholesky of D > 32,000 on one SM) takes hours: the
    wide path's address probe (fused_rhmc_crowded.address_probe: one block
    writes a sentinel through the passes' own index helpers at each corner
    of a real slice, the first and last pair sum, packed L entry, L^-1 and
    G^-1 entry and q coefficient) on 128x128 at PROBE_K and at the largest
    K whose one-block slice fits the card's free memory less PROBE_MARGIN,
    each offset against Python's exact integers and each sentinel read back
    there.  The allocation also holds the build's sizes to the Python
    mirrors at those K.  Returns {K: slice GiB}."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] - PROBE_MARGIN
    lo = frc.largest_kmax(128, 128, free)
    if lo <= PROBE_K[-1]:
        raise AssertionError(f"B6c's address probe: {free} bytes free hold K <= {lo} only")
    out = {}
    for k in (*PROBE_K, lo):
        got = frc.address_probe(k, 128, 128, dev)
        gib = got["slice_bytes"] / 2**30
        print(f"B6c address probe, 128x128 K={k} (D = {3 * k}, slice {gib:.3f} GiB"
              + (f", the largest of {(free + PROBE_MARGIN) / 2**30:.3f} GiB free)" if k == lo
                 else ")") + ": " + "; ".join(
                  f"{c['name']} {c['offset']} (exact {c['exact']}, read "
                  f"{c['value']})" for c in got["corners"]))
        if not got["ok"]:
            raise AssertionError(f"B6c's address probe at K={k}: {json.dumps(got['corners'])}")
        out[k] = gib
        torch.cuda.empty_cache()
    print(f"B6c address probe: every offset exact and every sentinel read back at K = "
          f"{', '.join(str(k) for k in out)}")
    return out


def run_beyond_slice(api, configs, dev, flc, frdc, frc, fl, frd):
    """Phase 21b: W1-W4 through the public API, each kernel's launch count
    set to 0 just before its run and read just after, equal to the run's
    own count: W1 on B4, W2 on B5, W3 and W4 on B6c, each with finite
    draws; W1's and W3's SMC at 2 temperature steps with a positive beta
    and a finite log Z, W4's total flux within 4 posterior sd of the drawn
    truth (its chains start there, the truth plus 0.01 jitter, and at 2 + 2
    its step adapts near 1e-6: the check cannot tell a sampler that moves
    from one that does not).  After W1 and W2 their kernels are held at the run's last state,
    as phase 19b holds them: B4 on W1's first 128 particles at its step and
    temperature (_run_state, _arbitrate), B5 on W2's 1024 chains at its
    adapted step, inverse mass and longest trajectory (_hold_b5_run).
    Returns each kernel's launches and the largest theta errors."""
    import numpy as np
    import torch

    from starcat_torch.configs import apply_overrides

    def run(name, over, want, mod):
        cfg = apply_overrides(configs[name], over)
        mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = api.sample(cfg, dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, st = mod.LAUNCHES, out.stats
        if st["trajectory_kernel"] != want or n <= 0 or n != st["kernel_launches"]:
            raise AssertionError(f"{name} {json.dumps(over)} did not run through {want}: "
                                 f"{st['trajectory_kernel']} x{st['kernel_launches']}, "
                                 f"{want} launches {n}")
        if cfg.head == "smc":
            sweep_launches(f"{name} {json.dumps(over)}", st)
        if not np.isfinite(out.thetas).all():
            raise AssertionError(f"{name} {json.dumps(over)}: non-finite draws")
        summ = api.summarize_output(out)
        tf = summ["total_flux"]
        truth = float(np.sum(st["truth"]["f"]))
        print(f"beyond slice {name} {json.dumps(over)}: {wall:.3f} s wall, {want} x{n}, accept "
              f"{st['accept']:.3f}, step {st['step_size']:.5f}, solver rejections "
              f"{st.get('solver_rejections')}; total flux {tf['mean']:.1f} ± {tf['sd']:.1f} "
              f"(R-hat {tf['rhat']:.4f}), truth {truth:.1f}; star count mean "
              f"{summ['star_count']['mean'] if 'star_count' in summ else cfg.kmax}; peak "
              f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if cfg.head == "smc":
            if not (0.0 < st["beta"] and np.isfinite(st["log_z"]) and st["n_temp_steps"] == 2):
                raise AssertionError(f"{name} {json.dumps(over)}: beta {st['beta']}, log Z "
                                     f"{st['log_z']} after {st['n_temp_steps']} steps")
            print(f"  after 2 temperature steps: beta {st['beta']:.6f}, log Z "
                  f"{st['log_z']:.3f}, mean star count {summ['star_count']['mean']:.3f}")
        elif cfg.head == "rhmc" and not abs(tf["mean"] - truth) <= 4 * tf["sd"]:
            raise AssertionError(f"{name} {json.dumps(over)}: total flux {tf['mean']} ± "
                                 f"{tf['sd']} vs the drawn truth {truth}")
        return out, n

    out1, n4 = run("cfg4_crowded", W1, "B4", frdc)
    st = out1.stats
    cfg = out1.config
    image = cfg.make_data()[1].to(dev)
    theta, xi, eps, mask = _run_state(out1, dev, 160, 128)
    _arbitrate("B4", frdc.make_fused_rhmc_diag, frd.fused_rhmc_diag_reference,
               f"W1 256x256 K=256 (128 of {out1.thetas.shape[0]} particles, 6 x 4) on its last "
               f"state (beta {st['beta']:.6f}, step {st['step_size']:.5f})",
               cfg.scene, image, cfg.prior, cfg.kmax, cfg.smc.n_leapfrog,
               cfg.smc.fixed_point_iters, theta, xi, eps, mask, st["beta"], True, 8)
    out2, n5 = run("cfg4_crowded", W2, "B5", flc)
    err = _hold_b5_run(out2, dev, flc, fl, W2_HOLD_SEED)
    _, n6 = run("cfg4_crowded", W3, "B6c", frc)
    _, n6w = run("cfg1_rhmc", W4, "B6c", frc)
    return {"b4": n4, "b5": n5, "b6c": n6 + n6w}, err


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


def rhmc_full_crowded_ops(c, k, h, w, n_steps, fpi):
    """B6c: rhmc_full_ops with the q field counted in the product form B6c
    computes it in, every pass on the CUDA cores (no pass runs on tensor
    cores, so the whole count is over the float32 rate): per pixel of a
    rebuild, one FMA for each of the four column-profile combinations of
    each unordered star pair, 4 k (k + 1) operations in place of B6's
    9 k^2."""
    q_saved = (1 + n_steps) * h * w * (9.0 * k * k - 4.0 * k * (k + 1))
    return rhmc_full_ops(c, k, h, w, n_steps, fpi) - c * q_saved


def _footprints(coord, n, sig, norm):
    """The first and last pixel (of n) where a star's float32 profile
    exp(-z^2 / 2) norm at coordinate ``coord`` (any shape) is not 0, as the
    kernels compute it; an empty footprint gives first > last."""
    import torch

    z = ((torch.arange(n, device=coord.device, dtype=torch.float32) + 0.5)
         - coord[..., None]) / sig
    nz = (torch.exp(-0.5 * z * z) * norm) != 0
    idx = torch.arange(n, device=coord.device)
    first = torch.where(nz, idx, n).amin(-1)
    last = torch.where(nz, idx, -1).amax(-1)
    return first, last


def rhmc_full_sparse_ops(theta, mask, spec, n_steps, fpi):
    """What B6c's work needs on these inputs: rhmc_full_crowded_ops with
    every star-pair term counted only on the pixels where both stars'
    float32 profiles are non-zero (the rows and the columns of their
    footprints' overlap, at theta), and every single-star term only on the
    star's footprint: elsewhere those products are exact zeros; and the
    dense algebra at D = 3 live stars, which the pixel counts leave out: a
    Cholesky factorisation (D^3 / 3 FMAs) at each of the 1 + n_steps
    rebuilds and n_steps fpi position sweeps, L^-1 and G^-1 = L^-T L^-1
    (D^3 / 6 FMAs each) at each rebuild.  Per chain, with O the ordered
    pairs' overlaps, U the unordered pairs' (i <= j) and A the live stars'
    footprints, in pixels: (1 + n_steps)(12 O + 8 U) + n_steps fpi 4 O +
    A (26 + n_steps (26 fpi + 50)) + 2 D^3 ((1 + n_steps + n_steps fpi) /
    3 + (1 + n_steps) / 3).  Every operation counts at the float32 rate:
    no pass of B6c runs on tensor cores.  The footprints are theta's, the
    trajectory's start: its stars move by far less than a footprint's
    width."""
    import math

    import torch

    theta = theta.float()
    live = (mask if mask.ndim == 2 else mask.expand(theta.shape[0], -1)) != 0
    sig = float(spec.psf_sigma)
    norm = 1.0 / (math.sqrt(2.0 * math.pi) * sig)
    x = spec.width * torch.sigmoid(theta[..., 0])
    y = spec.height * torch.sigmoid(theta[..., 1])
    x0, x1 = _footprints(x, spec.width, sig, norm)
    y0, y1 = _footprints(y, spec.height, sig, norm)

    def overlap(a0, a1):
        lo = torch.maximum(a0[:, :, None], a0[:, None, :])
        hi = torch.minimum(a1[:, :, None], a1[:, None, :])
        return (hi - lo + 1).clamp(min=0).double()

    both = (live[:, :, None] & live[:, None, :]).double()
    ov = overlap(x0, x1) * overlap(y0, y1) * both
    o_sum = float(ov.sum())
    u_sum = 0.5 * (o_sum + float(torch.diagonal(ov, dim1=1, dim2=2).sum()))
    area = float((((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).double()
                  * live.double()).sum())
    d3 = float(((3.0 * live.double().sum(1)) ** 3).sum())
    return ((1 + n_steps) * (12.0 * o_sum + 8.0 * u_sum) + n_steps * fpi * 4.0 * o_sum
            + area * (26.0 + n_steps * (26.0 * fpi + 50.0))
            + 2.0 * d3 * ((1 + n_steps + n_steps * fpi) / 3.0 + (1 + n_steps) / 3.0))


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
             "fused_rhmc_diag_crowded", "fused_rhmc_crowded", "fused_transdim_sweep")
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
    from starcat_torch import fused_rhmc_crowded as frc
    from starcat_torch import fused_rhmc_diag as frd
    from starcat_torch import fused_rhmc_diag_crowded as frdc
    from starcat_torch import fused_transdim_sweep as fts
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
    t0 = time.perf_counter()
    err_sweep, ms_sweep = check_sweep_kernel(fts, CONFIGS, dev)
    print(f"sweep kernel checks: {time.perf_counter() - t0:.3f} s wall")

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
    fts.reset_launch_counts()
    t0 = time.perf_counter()
    run_riemannian_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b3"] = frd.LAUNCHES
    launches["sweep"] = path_sweeps("Riemannian path", fts)
    print(f"Riemannian path: {wall:.3f} s wall; B3 launches {launches['b3']}, sweep "
          f"launches {fts.LAUNCHES}")
    if launches["b3"] <= 0:
        raise AssertionError("B3 was never launched on the Riemannian path")
    print(f"B3 at the cfg1 shape: kernel {ms_b3['cfg1']:.4f} ms, plain "
          f"{ms_b3['cfg1_plain']:.4f} ms per trajectory")

    fr.reset_launch_counts()
    fts.reset_launch_counts()
    t0 = time.perf_counter()
    run_b6_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b6"] = fr.LAUNCHES
    launches["sweep"] += path_sweeps("full-metric path", fts)
    print(f"full-metric path: {wall:.3f} s wall; B6 launches {launches['b6']}, sweep "
          f"launches {fts.LAUNCHES}")
    if launches["b6"] <= 0:
        raise AssertionError("B6 was never launched on the full-metric path")
    print(f"B6 at the cfg1 shape: kernel {ms_b6['cfg1']:.4f} ms, plain "
          f"{ms_b6['cfg1_plain']:.4f} ms per trajectory")

    flc.reset_launch_counts()
    frdc.reset_launch_counts()
    fts.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_crowded_slice(api, CONFIGS, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["b4"], launches["b5"] = frdc.LAUNCHES, flc.LAUNCHES
    launches["sweep"] += path_sweeps("crowded path", fts)
    print(f"crowded path: {wall:.3f} s wall; B4 launches {launches['b4']}, B5 launches "
          f"{launches['b5']}, sweep launches {fts.LAUNCHES}; peak device memory "
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
    fts.reset_launch_counts()
    dur = run_durability(api, CONFIGS, dev)
    dur["sweep"] = path_sweeps("durability path", fts)
    print(f"durability path: {time.perf_counter() - t0:.3f} s wall; launches {dur}")
    for name in ("dyn", "static", "b3", "b6"):
        if dur[name] <= 0:
            raise AssertionError(f"{name} was never launched on the durability path: {dur}")
        launches[name] += dur[name]
    if dur["b4"] <= 0:
        raise AssertionError(f"B4 was never launched on the durability path: {dur}")
    launches["b4"] += dur["b4"]
    launches["sweep"] += dur["sweep"]
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
    t0 = time.perf_counter()
    bnc = run_bench(dev)
    print(f"bench path: {time.perf_counter() - t0:.3f} s wall; launches {bnc}")
    for name, n in bnc.items():
        launches[name] += n
    t0 = time.perf_counter()
    mock, err_mock = run_mock_scenes(api, CONFIGS, dev, fl, flc)
    err_b5 = max(err_b5, err_mock)
    print(f"mock-scene path: {time.perf_counter() - t0:.3f} s wall; launches {mock}")
    for name, n in mock.items():
        launches[name] += n
    t0 = time.perf_counter()
    err_b6c, ms_b6c = check_b6c_kernel(frc, fr, rhmc, CONFIGS, dev)
    print(f"B6c kernel checks: {time.perf_counter() - t0:.3f} s wall")
    t0 = time.perf_counter()
    fts.reset_launch_counts()
    launches["b6c"] = run_full_crowded_slice(api, CONFIGS, dev, frc, fr)
    launches["sweep"] += path_sweeps("path beyond B6's domain", fts)
    print(f"full metric beyond B6's domain: {time.perf_counter() - t0:.3f} s wall; B6c "
          f"launches {launches['b6c']}, sweep launches {fts.LAUNCHES}")
    if launches["b6c"] <= 0:
        raise AssertionError("B6c was never launched on its path")
    t0 = time.perf_counter()
    err_b5w, err_b4w, ms_wide = check_wide_kernels(flc, fl, frdc, frd, CONFIGS, dev)
    err_b5, err_b4 = max(err_b5, err_b5w), max(err_b4, err_b4w)
    print(f"wide kernel checks: {time.perf_counter() - t0:.3f} s wall")
    t0 = time.perf_counter()
    fts.reset_launch_counts()
    wide, err_run = run_wide_slice(api, CONFIGS, dev, flc, frdc, fl, frd)
    wide["sweep"] = path_sweeps("wide path", fts)
    err_b5 = max(err_b5, err_run)
    print(f"B5 and B4 beyond their one-tile domains: {time.perf_counter() - t0:.3f} s wall; "
          f"launches {wide}")
    for name, n in wide.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the wide path: {wide}")
        launches[name] += n
    t0 = time.perf_counter()
    err_b6cw, ms_b6cw = check_b6c_wide(frc, fr, CONFIGS, dev)
    err_b6c = max(err_b6c, err_b6cw)
    print(f"B6c wide checks: {time.perf_counter() - t0:.3f} s wall")
    t0 = time.perf_counter()
    fts.reset_launch_counts()
    b6c_wide = run_b6c_wide_slice(api, CONFIGS, dev, frc)
    launches["sweep"] += path_sweeps("path beyond B6c's one-tile domain", fts)
    print(f"the full metric beyond B6c's one-tile domain: {time.perf_counter() - t0:.3f} s "
          f"wall; B6c launches {b6c_wide}, sweep launches {fts.LAUNCHES}")
    if b6c_wide <= 0:
        raise AssertionError("B6c's wide path was never launched on its path")
    launches["b6c"] += b6c_wide
    t0 = time.perf_counter()
    err_b5x, err_b4x, err_b6cx, ms_x = check_beyond_gates(flc, fl, frdc, frd, frc, fr, CONFIGS,
                                                          dev)
    err_b5, err_b4, err_b6c = max(err_b5, err_b5x), max(err_b4, err_b4x), max(err_b6c, err_b6cx)
    print(f"beyond-gate kernel checks: {time.perf_counter() - t0:.3f} s wall")
    t0 = time.perf_counter()
    fts.reset_launch_counts()
    beyond, err_run = run_beyond_slice(api, CONFIGS, dev, flc, frdc, frc, fl, frd)
    beyond["sweep"] = path_sweeps("path beyond the gates", fts)
    err_b5 = max(err_b5, err_run)
    print(f"B5, B4 and B6c beyond the TPU kernels' gates: {time.perf_counter() - t0:.3f} s "
          f"wall; launches {beyond}")
    for name, n in beyond.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched beyond the gates: {beyond}")
        launches[name] += n
    t0 = time.perf_counter()
    probed = check_b6c_addressing(frc, dev)
    print(f"B6c's slice addressing: {time.perf_counter() - t0:.3f} s wall")
    # a leaf and an 8-draw gradient at the shapes of this path, against their
    # own bounds (one evaluation each; the leaf's entry gradient is in)
    for name, c, n in (("leaf", 1024, 1), ("grad8", 8, 0)):
        b = bound_ms(leapfrog_ops(c, 10, 32, 32, n, True), leapfrog_bytes(c, 10, 32, 32, n > 0))
        print(f"B1 {name}: {ms_leaf[name]:.5f} ms kernel, {ms_leaf[name + '_plain']:.4f} ms "
              f"plain, bound {b[0]:.6f} ms ({b[1]})")

    # the timed shapes: B1/B2 C = 1024, K = 10, 32x32, L = 20, entry gradient
    # in; B3 256 chains, K = 16, 32x32, 6 x 4, per-chain masks; B6 4096
    # particles, K = 16, 32x32, 6 x 4, per-chain masks; B5 1024 chains, K =
    # 50, 128x128, L = 10, entry gradient in; B4 and B6c 4096 particles, K =
    # 64 (30..64 live), 128x128, 6 x 4, per-chain masks
    b12 = bound_ms(leapfrog_ops(1024, 10, 32, 32, 20, True),
                   leapfrog_bytes(1024, 10, 32, 32, True))
    b3 = bound_ms(rhmc_diag_ops(256, 16, 32, 32, 6, 4), rhmc_bytes(256, 16, 32, 32, True))
    b6 = bound_ms(rhmc_full_ops(4096, 16, 32, 32, 6, 4), rhmc_bytes(4096, 16, 32, 32, True))
    b5 = bound_ms(leapfrog_ops(1024, 50, 128, 128, 10, True),
                  leapfrog_bytes(1024, 50, 128, 128, True))
    # B4 skips dead stars: its work is that of the timed inputs' live ones
    b4 = bound_ms(rhmc_diag_ops(1, ms_b4["b4_live"], 128, 128, 6, 4),
                  rhmc_bytes(4096, 64, 128, 128, True))
    # B6c's: the work its inputs need, each star pair's terms on the pixels
    # where both stars' profiles are non-zero, and its dense algebra
    # (rhmc_full_sparse_ops)
    b6c_bytes = rhmc_bytes(ms_b6c["particles"], 64, 128, 128, True)
    b6c = bound_ms(ms_b6c["ops"], b6c_bytes)

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
        row("fused_rhmc_crowded (B6c, full-Fisher trajectory beyond B6's domain)",
            "starcat_torch/csrc/fused_rhmc_crowded.cu", "starcat/api.py:205",
            launches["b6c"], err_b6c, ms_b6c["b6c"], ms_b6c["b6c_plain"], b6c),
    ]
    # B6c's kernel time and bound are of the full-width launch, its plain
    # time of the first plain_particles of it (the kernel on those: ms_same)
    # the trans-d sweep (phase 6b): kernel, plain and bound at cfg4's shape,
    # every other SWEEP_SHAPES entry's beside it; launches on this run's SMC
    # and trans-d MCMC paths, each path's counted on its own
    sweep_row = row("fused_transdim_sweep (the trans-d sweep, one move a chain)",
                    "starcat_torch/csrc/fused_transdim_sweep.cu",
                    "none (the JAX package's XLA sweep, starcat/transdim.py:523)",
                    launches["sweep"], err_sweep, ms_sweep["cfg4"], ms_sweep["cfg4_plain"],
                    (ms_sweep["cfg4_bound"], ms_sweep["cfg4_bound_by"]))
    sweep_row.update({nm: {"ms": ms_sweep[nm], "plain_ms": ms_sweep[nm + "_plain"],
                           "bound_ms": ms_sweep[nm + "_bound"],
                           "bound_by": ms_sweep[nm + "_bound_by"]}
                      for nm, *_ in SWEEP_SHAPES[1:]})
    rows[-1].update(particles=ms_b6c["particles"], plain_particles=ms_b6c["plain_particles"],
                    ms_same=ms_b6c["b6c_16"],
                    bound_ms_dense=bound_ms(ms_b6c["ops_dense"], b6c_bytes)[0],
                    bound_ms_b6_count=bound_ms(ms_b6c["ops_b6_count"], b6c_bytes)[0],
                    shapes=ms_b6c["shapes"])
    # B4 and B5 at the slice's shapes (phase 19): B4's plain time is of the
    # first plain_particles of the launch (the kernel on those: ms_same)
    b4w = bound_ms(rhmc_diag_ops(1, ms_wide["b4_live"], 192, 192, 6, 4),
                   rhmc_bytes(ms_wide["b4_particles"], 125, 192, 192, True))
    b5w = bound_ms(leapfrog_ops(ms_wide["b5_chains"], ms_wide["b5_k"], 192, 192, 10, True),
                   leapfrog_bytes(ms_wide["b5_chains"], ms_wide["b5_k"], 192, 192, True))
    rows[3]["wide"] = {"shape": f"{ms_wide['b4_particles']} particles, K=125 "
                                f"({ms_wide['b4_live']} live), 192x192, 6 x 4",
                       "launches": wide["b4"], "ms": ms_wide["b4"],
                       "plain_ms": ms_wide["b4_plain"], "plain_particles": WIDE_HELD,
                       "ms_same": ms_wide["b4_same"], "bound_ms": b4w[0], "bound_by": b4w[1]}
    rows[4]["wide"] = {"shape": f"{ms_wide['b5_chains']} chains, K={ms_wide['b5_k']}, "
                                f"192x192, L=10",
                       "launches": wide["b5"], "ms": ms_wide["b5"],
                       "plain_ms": ms_wide["b5_plain"], "bound_ms": b5w[0], "bound_by": b5w[1]}
    # B6c's wide path at the slice's shape (phase 20): its plain time is of
    # the first plain_particles of the launch (the kernel on those: ms_same)
    rows[-1]["wide"] = {"shape": f"{ms_b6cw['particles']} particles, K=125 "
                                 f"({ms_b6cw['live']} live), 192x192, 6 x 4",
                        "launches": b6c_wide, "ms": ms_b6cw["b6c"],
                        "plain_ms": ms_b6cw["b6c_plain"],
                        "plain_particles": ms_b6cw["plain_particles"],
                        "ms_same": ms_b6cw["b6c_same"], "bound_ms": ms_b6cw["bound_ms"],
                        "bound_by": ms_b6cw["bound_by"], "edge_254": ms_b6cw["edge_254"]}
    # the slice beyond the TPU kernels' gates (phase 21): each plain time is
    # of the first plain_chains of its launch (the kernel on those: ms_same)
    b4x = bound_ms(rhmc_diag_ops(1, ms_x["b4_live"], 256, 256, 6, 4),
                   rhmc_bytes(ms_x["b4_particles"], 256, 256, 256, True))
    b5x = bound_ms(leapfrog_ops(ms_x["b5_chains"], ms_x["b5_k"], 256, 256, 10, True),
                   leapfrog_bytes(ms_x["b5_chains"], ms_x["b5_k"], 256, 256, True))
    b6x = bound_ms(ms_x["b6c_ops"], rhmc_bytes(ms_x["b6c_particles"], 256, 256, 256, True))
    b6w = bound_ms(ms_x["b6c_w4_ops"], rhmc_bytes(64, 300, 128, 128, False))
    rows[3]["beyond"] = {"shape": f"{ms_x['b4_particles']} particles, K=256 "
                                  f"({ms_x['b4_live']} live), 256x256, 6 x 4",
                         "launches": beyond["b4"], "ms": ms_x["b4"],
                         "plain_ms": ms_x["b4_plain"], "plain_chains": BEYOND_HELD["b4"],
                         "ms_same": ms_x["b4_same"], "bound_ms": b4x[0], "bound_by": b4x[1]}
    rows[4]["beyond"] = {"shape": f"{ms_x['b5_chains']} chains, K={ms_x['b5_k']}, 256x256, "
                                  f"L=10",
                         "launches": beyond["b5"], "ms": ms_x["b5"],
                         "plain_ms": ms_x["b5_plain"], "plain_chains": ms_x["b5_chains"],
                         "ms_same": ms_x["b5"], "bound_ms": b5x[0], "bound_by": b5x[1]}
    rows[-1]["beyond"] = {"shape": f"{ms_x['b6c_particles']} particles, K=256 "
                                   f"({ms_x['b6c_live']} live), 256x256, 6 x 4",
                          "launches": beyond["b6c"], "ms": ms_x["b6c"],
                          "plain_ms": ms_x["b6c_plain"], "plain_chains": BEYOND_HELD["b6c"],
                          "ms_same": ms_x["b6c_same"], "bound_ms": b6x[0], "bound_by": b6x[1],
                          "w4": {"shape": "64 chains, K=300 (all live), 128x128, 16 x 6",
                                 "ms": ms_x["b6c_w4"], "plain_ms": ms_x["b6c_w4_plain"],
                                 "plain_chains": BEYOND_HELD["b6c_w4"],
                                 "ms_same": ms_x["b6c_w4_same"], "bound_ms": b6w[0],
                                 "bound_by": b6w[1]},
                          "address_probe_slice_gib": probed}
    rows.append(sweep_row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
