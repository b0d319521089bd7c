"""Benchmark program (port of bench.py): ``python -m starcat_torch bench``.

    python -m starcat_torch bench [--chains 32768] [--leapfrog 20] [--scan 50]
        [--repeats 3] [--full] [--scaling] [--retime-baseline]
        [--device cuda] [--out build/bench_full_torch.json]

The last line printed is bench.py's headline:

    {"metric": "leapfrog_grad_evals_per_sec_per_chip", "value": N,
     "unit": "evals/s", "vs_baseline": R}

N is the rate of gradient evaluations of the fused leapfrog B1
(fused_leapfrog.py) on the flagship 10-star 32x32 scene (cfg2's, which is
cfg6's): --chains chains, --scan trajectories of --leapfrog steps a timed
call, the entry gradient carried between trajectories, so that a
trajectory costs exactly L evaluations.  R is N over the NumPy oracle's
rate on the same scene, NUMPY_BASELINE_EVALS_PER_SEC (bench.py:39) or, with
--retime-baseline, the oracle timed on the host's CPU.

Protocol.  The reference scans n_scan trajectories in one ``lax.scan``, one
dispatch; here they are a Python loop of launches.  A leg makes one untimed
warm call, then ``repeats`` timed calls, each opened and closed by a device
synchronisation on the host clock, and counts the best (each repeat's
seconds are printed on a line of their own).  No leg can time the wrong
thing unnoticed: a kernel leg raises unless its wrapper's launch count rose
by exactly n_scan (repeats + 1) on the card (by 0 on the CPU, where the
wrappers run their plain versions), an ESS leg unless it launched its
kernel on the card, every leg unless its final state is finite (a
Riemannian leg: every chain but those the kernel marks as failed, which a
head would reject, and not all), and the headline on the card if it is
above B1's bound rate.

``--full`` adds every secondary leg of bench.py under the port's names
(``pallas_*`` -> ``cuda_*``, ``xla_*`` and the crowded ``mxu`` -> ``cuda``
and ``plain``): the plain leapfrog, B6, B3 and its plain version, B4 beside
its plain version, B5 and the plain crowded leapfrog, NUTS and ChEES ESS
per second, and the chain sweep at 1024, 8192 and --chains with its share
of B1's bound; with the card's name and power limit and the torch and CUDA
versions.  The document is printed as one line before the headline and
written to --out.  A plain leg whose trajectories at bench.py's size would
outlast PLAIN_LEG_SECONDS runs fewer of them, each cut named under
``"reduced"``.

``--scaling`` prints bench_scaling's document instead: samples/s of the
flagship HMC head sharded over 1, 2, 4, ... ranks of a torch.distributed
group (NCCL, one card a rank; gloo on the CPU).

Inputs are drawn on the CPU from torch generators seeded as bench.py numbers
its keys (0 for theta0's jitter, 1 for p0, 2 for the Riemannian xi, ...), so
a leg's inputs are the same on every device; the crowded mutation leg
starts from bench.py's own theta0, JAX's bits through threefry.py
(``crowded_theta0``); the samplers of the ESS legs
and the scaling rows draw from a generator on the chains' device, seeded as
bench.py's key for their chain states.

Not ported:

- ``FLOOR_EVALS_PER_SEC`` and the ``floor_violation`` exit (bench.py:41-44,
  :722-727): the floor is a TPU v5e figure, and no TPU number is a target
  or a floor for the port;
- ``--mxu-repro`` (bench.py:326-340): on ROADMAP's "Do not port" list;
- the ``jax_compilation_cache_dir`` setup (bench.py:53-57): JAX's own;
  build.py caches the kernels' builds.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import diagnostics, dist, driver
from . import fused_leapfrog as fl
from . import fused_leapfrog_crowded as flc
from . import fused_rhmc as fr
from . import fused_rhmc_diag as frd
from . import fused_rhmc_diag_crowded as frdc
from . import threefry
from .chees import ChEESConfig, chees_sample, make_fused_leapfrog_impl, run_chees
from .configs import CONFIGS
from .hmc import HMCConfig, make_hmc_kernel
from .integrators import leapfrog, riemannian_leapfrog
from .metric import make_diag_metric_fn
from .nuts import NUTSConfig, make_nuts_kernel
from .potential import make_potential, make_potential_and_grad
from .rhmc import make_rhmc_diag_functions

# The NumPy oracle's gradient rate on the flagship scene, pinned by the
# reference (bench.py:35-39: best of 5 x 2000 evaluations on its VM's CPU).
NUMPY_BASELINE_EVALS_PER_SEC = 7472.0

# An H100 SXM's float32 rate outside the tensor cores (NVIDIA's data sheet),
# the peak chip_smoke.py's bounds use.
PEAK_FP32 = 67e12

# A plain leg's warm and timed calls together stay under this many seconds.
PLAIN_LEG_SECONDS = 60.0

SCALING_COUNTS = (1, 2, 4, 8, 16, 32, 64)
RANK_TIMEOUT = 900
REPO = Path(__file__).resolve().parents[1]
FULL_OUT = REPO / "build" / "bench_full_torch.json"


def resolve_device(device) -> torch.device:
    """The device a leg runs on; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


def b1_bound_evals_per_sec(spec, kmax: int) -> float:
    """The most gradient evaluations a second B1 could do: the pixel work of
    one evaluation (a render FMA and two contraction FMAs per star and
    pixel, chip_smoke.leapfrog_ops) over PEAK_FP32.  A trajectory's state
    moves far fewer bytes than that work takes, so operations bound it."""
    return PEAK_FP32 / (6.0 * kmax * spec.height * spec.width)


def _normal(seed: int, shape) -> torch.Tensor:
    """bench.py's ``jax.random.normal(jax.random.key(seed), shape)``: a
    float32 draw on the CPU from a generator seeded ``seed``."""
    return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(seed))


def _scene(name: str, device: torch.device):
    cfg = CONFIGS[name]
    truth, img = cfg.make_data()
    return cfg, truth, img.to(device)


def _bench_setup(n_chains: int, device: torch.device):
    """cfg2's scene, truth and image, a shared unit mask, theta0 = truth +
    0.01 N(0, 1) (key 0), p0 ~ N(0, 1) (key 1) and a unit mass, on
    ``device`` (bench.py:47-66)."""
    cfg, truth, img = _scene("cfg2_nuts", device)
    theta0 = truth[None] + 0.01 * _normal(0, (n_chains,) + tuple(truth.shape))
    p0 = _normal(1, theta0.shape)
    return (cfg, truth.to(device), img, torch.ones(cfg.kmax, device=device),
            theta0.to(device), p0.to(device), torch.ones(truth.shape, device=device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(call, repeats: int, device: torch.device, label: str):
    """One untimed warm call, then ``repeats`` calls each opened and closed
    by a device sync on the host clock.  Prints each repeat's seconds;
    returns (the best, the last call's output)."""
    out = call()
    secs = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = call()
        _sync(device)
        secs.append(time.perf_counter() - t0)
    print(f"bench {label}: repeats " + " ".join(f"{s:.6f}" for s in secs) + " s", flush=True)
    return min(secs), out


def _check_launches(label: str, got: int, want: int, device: torch.device) -> None:
    """A kernel leg's launches: ``want`` on the card, none on the CPU."""
    want = want if device.type == "cuda" else 0
    if got != want:
        raise RuntimeError(f"bench {label}: {got} kernel launches, expected {want}: the "
                           "leg did not time its kernel")


def _check_ran(label: str, got: int, device: torch.device) -> None:
    """An ESS leg's launches: some on the card, none on the CPU."""
    if (got > 0) != (device.type == "cuda"):
        raise RuntimeError(f"bench {label}: {got} kernel launches on {device}")


def _check_finite(label: str, *tensors: torch.Tensor) -> None:
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise RuntimeError(f"bench {label}: the final state is not finite")


def _check_trajectories(label: str, out) -> int:
    """A Riemannian leg's last output (theta', p', ..., resid): every
    chain finite but those whose solve failed (resid NaN, the chains a head
    rejects: carried on without accept or reject and kicked by the same xi
    each time, as bench.py's loop does, some lose their metric's
    definiteness), and not all of them.  Returns the failed chains."""
    theta, p, resid = out[0], out[1], out[-1]
    finite = torch.isfinite(theta).all(dim=(-2, -1)) & torch.isfinite(p).all(dim=(-2, -1))
    failed = torch.isnan(resid)
    if bool((~finite & ~failed).any()) or bool(failed.all()):
        raise RuntimeError(f"bench {label}: {int((~finite).sum())} non-finite chains, "
                           f"{int(failed.sum())} of {failed.numel()} marked failed")
    return int(failed.sum())


def _plain_scan(label: str, one, n_scan: int, device: torch.device, repeats: int,
                reduced: dict | None) -> int:
    """How many trajectories a timed call of a plain leg runs: ``n_scan``, or
    fewer where its warm and timed calls would outlast PLAIN_LEG_SECONDS, as
    judged from ``one()``, a single trajectory timed first.  A cut is
    printed and recorded in ``reduced``."""
    _sync(device)
    t0 = time.perf_counter()
    one()
    _sync(device)
    t1 = time.perf_counter() - t0
    n = max(1, min(n_scan, int(PLAIN_LEG_SECONDS / ((repeats + 1) * t1))))
    if n < n_scan:
        print(f"bench {label}: {n} of {n_scan} trajectories a call (one took {t1:.3f} s)",
              flush=True)
        if reduced is not None:
            reduced[label] = {"n_scan": n, "of": n_scan, "one_trajectory_s": round(t1, 4)}
    return n


def _leapfrog_loop(fused, theta, p, grad, eps, inv_mass, mask, n_scan: int):
    """n_scan trajectories on B1's contract, each from the last one's end
    with its gradient carried (bench.py:81-90), so a trajectory costs
    exactly its n_steps evaluations.  Returns the last (theta, p, grad)."""
    for _ in range(n_scan):
        theta, p, _, grad = fused(theta, p, eps, inv_mass, mask, grad=grad)
    return theta, p, grad


def _timed_leapfrog(label, fused, launches, theta0, p0, grad0, eps, inv_mass, mask,
                    n_leapfrog, n_scan, repeats, device):
    """(evals/s, best s) of n_scan trajectories from (theta0, p0, grad0)
    each call; ``launches()`` reads the kernel's count (None: a plain leg)."""
    before = launches() if launches else 0
    best, out = _best_of(lambda: _leapfrog_loop(fused, theta0, p0, grad0, eps, inv_mass,
                                                mask, n_scan), repeats, device, label)
    if launches:
        _check_launches(label, launches() - before, n_scan * (repeats + 1), device)
    _check_finite(label, *out)
    return theta0.shape[0] * n_leapfrog * n_scan / best, best


def bench_fused_grad_evals(n_chains: int, n_leapfrog: int, n_scan: int, repeats: int,
                           device="cuda"):
    """The headline: B1 at a static L, the gradient carried (bench.py:69).
    Returns (evals/s, best s); raises on the card above B1's bound rate."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    fused = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, n_leapfrog)
    _, grad0 = make_potential_and_grad(cfg.scene, img, cfg.prior)(theta0, mask)
    rate, best = _timed_leapfrog(f"fused leapfrog (B1), {n_chains} chains", fused,
                                 lambda: fl.STATIC_LAUNCHES, theta0, p0, grad0, 0.002,
                                 inv_mass, mask, n_leapfrog, n_scan, repeats, device)
    bound = b1_bound_evals_per_sec(cfg.scene, cfg.kmax)
    if device.type == "cuda" and rate > bound:
        raise RuntimeError(f"bench: {rate:.4g} evals/s is above B1's bound {bound:.4g}: "
                           "a timing fault")
    return rate, best


def bench_numpy_baseline(n_evals: int = 2000, repeats: int = 3) -> float:
    """The NumPy oracle's gradient evaluations a second on cfg2's scene at
    the truth, on the host's CPU (bench.py:343, --retime-baseline)."""
    from oracle.numpy_sampler import OracleModel

    cfg = CONFIGS["cfg2_nuts"]
    truth, img = cfg.make_data()
    model = OracleModel(image=img.numpy().astype(np.float64), height=cfg.scene.height,
                        width=cfg.scene.width, psf_sigma=cfg.scene.psf_sigma,
                        background=cfg.scene.background, logf_mean=cfg.prior.logf_mean,
                        logf_sigma=cfg.prior.logf_sigma)
    theta = truth.numpy().astype(np.float64).reshape(-1)
    for _ in range(200):
        model.grad_potential(theta)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_evals):
            model.grad_potential(theta)
        best = min(best, time.perf_counter() - t0)
    return n_evals / best


def _plain_leapfrog(spec, img, prior, mask, n_leapfrog):
    """The plain leapfrog (integrators.leapfrog on the analytic gradient)
    on B1's contract; the entry gradient is always given."""
    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    return lambda th, p, eps, im, m, grad: leapfrog(grad_fn, th, p, None, grad, eps,  # noqa: E731
                                                    n_leapfrog, im)


def _bench_plain_leapfrog(label, cfg, img, mask, theta0, p0, inv_mass, eps, n_leapfrog,
                          n_scan, repeats, device, reduced):
    plain = _plain_leapfrog(cfg.scene, img, cfg.prior, mask, n_leapfrog)
    _, grad0 = make_potential_and_grad(cfg.scene, img, cfg.prior)(theta0, mask)
    n = _plain_scan(label, lambda: plain(theta0, p0, eps, inv_mass, mask, grad0), n_scan,
                    device, repeats, reduced)
    return _timed_leapfrog(label, plain, None, theta0, p0, grad0, eps, inv_mass, mask,
                           n_leapfrog, n, repeats, device)


def bench_plain_grad_evals(n_chains: int, n_leapfrog: int, n_scan: int, repeats: int,
                           device="cuda", reduced: dict | None = None):
    """The plain leapfrog at the headline's shape (bench.py:103); its entry
    gradient is evaluated once, before the timed calls.  Returns (evals/s,
    best s)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    return _bench_plain_leapfrog(f"plain leapfrog, {n_chains} chains", cfg, img, mask,
                                 theta0, p0, inv_mass, 0.002, n_leapfrog, n_scan, repeats,
                                 device, reduced)


def _riemannian_loop(fused, theta, xi, mask, n_scan: int):
    """n_scan Riemannian trajectories on B3's contract at eps 0.02 and beta
    1, theta carried and the same xi each time (bench.py:154-161).  Returns
    the last trajectory's output."""
    out = None
    for _ in range(n_scan):
        out = fused(theta, xi, 0.02, mask, 1.0)
        theta = out[0]
    return out


def _timed_trajectories(fused, theta0, xi, mask, n_steps: int, n_scan: int, repeats: int,
                        device, label: str = "trajectories", launches=None):
    """Time n_scan trajectories a call, each call continuing from the last
    one's theta (bench.py:142).  ``launches()`` reads the kernel's count
    (None: a plain leg).  Returns (steps/s, best s, the last trajectory's
    output)."""
    device = torch.device(device)
    state = [theta0]

    def call():
        out = _riemannian_loop(fused, state[0], xi, mask, n_scan)
        state[0] = out[0]
        return out

    before = launches() if launches else 0
    best, out = _best_of(call, repeats, device, label)
    if launches:
        _check_launches(label, launches() - before, n_scan * (repeats + 1), device)
    failed = _check_trajectories(label, out)
    if failed:
        print(f"bench {label}: {failed} of {theta0.shape[0]} chains failed their solve",
              flush=True)
    return theta0.shape[0] * n_steps * n_scan / best, best, out


def bench_fused_rhmc_steps(n_chains: int = 1024, n_steps: int = 10, fpi: int = 6,
                           repeats: int = 3, n_scan: int = 10, device="cuda"):
    """B6, the full-Fisher trajectory, in generalised-leapfrog steps a second
    (bench.py:174).  Returns (steps/s, best s)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    fused = fr.make_fused_rhmc(cfg.scene, img, cfg.prior, cfg.kmax, n_steps, fpi)
    xi = _normal(2, theta0.shape).to(device)
    return _timed_trajectories(fused, theta0, xi, mask, n_steps, n_scan, repeats, device,
                               f"full-Fisher trajectory (B6), {n_chains} chains",
                               lambda: fr.LAUNCHES)[:2]


def _plain_rhmc_diag(spec, img, prior, n_steps: int, fpi: int):
    """riemannian_leapfrog over rhmc.make_rhmc_diag_functions on the diagonal
    metric, on B3's contract with xi taken as the momentum itself."""
    _, dhdt, dhdp = make_rhmc_diag_functions(make_potential(spec, img, prior),
                                             make_diag_metric_fn(spec, prior))

    def plain(theta, p, eps, mask, beta):
        return riemannian_leapfrog(lambda t, q: dhdt(t, q, mask), lambda t, q: dhdp(t, q, mask),
                                   theta, p, eps, n_steps, fpi)

    return plain


def _bench_plain_riemannian(label, plain, theta0, p, mask, n_steps, n_scan, repeats, device,
                            reduced):
    n = _plain_scan(label, lambda: plain(theta0, p, 0.02, mask, 1.0), n_scan, device,
                    repeats, reduced)
    return _timed_trajectories(plain, theta0, p, mask, n_steps, n, repeats, device, label)[:2]


def bench_plain_rhmc_diag_steps(n_chains: int = 1024, n_steps: int = 10, fpi: int = 6,
                                repeats: int = 3, n_scan: int = 10, device="cuda",
                                reduced: dict | None = None):
    """The plain diagonal-Fisher trajectory (autograd dH/dtheta) at B3's
    bench shape, from p0 (bench.py:191).  Returns (steps/s, best s)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    plain = _plain_rhmc_diag(cfg.scene, img, cfg.prior, n_steps, fpi)
    return _bench_plain_riemannian(f"plain diagonal-Fisher trajectory, {n_chains} chains",
                                   plain, theta0, p0, mask, n_steps, n_scan, repeats, device,
                                   reduced)


def bench_fused_rhmc_diag_steps(n_chains: int = 1024, n_steps: int = 10, fpi: int = 6,
                                repeats: int = 3, n_scan: int = 10, device="cuda"):
    """B3, the diagonal-Fisher trajectory (bench.py:241).  Returns (steps/s,
    best s)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    fused = frd.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, cfg.kmax, n_steps, fpi)
    xi = _normal(2, theta0.shape).to(device)
    return _timed_trajectories(fused, theta0, xi, mask, n_steps, n_scan, repeats, device,
                               f"diagonal-Fisher trajectory (B3), {n_chains} chains",
                               lambda: frd.LAUNCHES)[:2]


def bench_rhmc_diag_crowded(n_chains: int = 256, repeats: int = 3, n_scan: int = 5,
                            n_steps: int | None = None, fpi: int | None = None,
                            device="cuda", reduced: dict | None = None):
    """cfg4's mutation workload (K = 64 with 50 live slots, 128x128, cfg4's
    n_leapfrog and fixed_point_iters unless given): the plain diagonal-Fisher
    trajectory, then B4, in one process (bench.py:260).  Returns (plain
    steps/s, cuda steps/s)."""
    device = resolve_device(device)
    cfg, truth, img = _scene("cfg4_crowded", device)
    kmax = cfg.kmax
    mask = torch.cat([torch.ones(cfg.n_stars), torch.zeros(kmax - cfg.n_stars)]).to(device)
    theta0 = crowded_theta0(cfg, n_chains).to(device)
    n_steps = cfg.smc.n_leapfrog if n_steps is None else n_steps
    fpi = cfg.smc.fixed_point_iters if fpi is None else fpi
    plain = _plain_rhmc_diag(cfg.scene, img, cfg.prior, n_steps, fpi)
    p = _normal(7, theta0.shape).to(device)
    rate_plain, _ = _bench_plain_riemannian(
        f"plain diagonal-Fisher trajectory, crowded, {n_chains} chains", plain, theta0, p,
        mask, n_steps, n_scan, repeats, device, reduced)
    fused = frdc.make_fused_rhmc_diag(cfg.scene, img, cfg.prior, kmax, n_steps, fpi)
    xi = _normal(8, theta0.shape).to(device)
    rate_cuda, _, _ = _timed_trajectories(
        fused, theta0, xi, mask, n_steps, n_scan, repeats, device,
        f"diagonal-Fisher trajectory, crowded (B4), {n_chains} chains",
        lambda: frdc.LAUNCHES)
    return rate_plain, rate_cuda


def crowded_theta0(cfg, n_chains: int) -> torch.Tensor:
    """bench.py:280-281's start of the crowded mutation leg, JAX's bits:
    ``sample_prior(key(5), kmax) + 0.01 normal(key(6), (C, kmax, 3))``."""
    return (threefry.sample_prior(threefry.key(5), cfg.kmax, cfg.prior)[None]
            + 0.01 * threefry.normal(threefry.key(6), (n_chains, cfg.kmax, 3)))


def _crowded_setup(n_chains: int, device: torch.device):
    """cfg4's scene at its true 50 stars, all live, theta0 = truth + 0.01
    N(0, 1) (key 0), p0 (key 1), a unit mass (bench.py:445-453)."""
    cfg, truth, img = _scene("cfg4_crowded", device)
    theta0 = truth[None] + 0.01 * _normal(0, (n_chains,) + tuple(truth.shape))
    return (cfg, img, torch.ones(cfg.n_stars, device=device), theta0.to(device),
            _normal(1, theta0.shape).to(device), torch.ones(truth.shape, device=device))


def bench_fused_crowded(n_chains: int = 1024, n_leapfrog: int = 10, n_scan: int = 5,
                        repeats: int = 3, device="cuda") -> float:
    """B5 on cfg4's scene at K = 50, eps 0.0005, the gradient carried
    (bench.py:436).  Returns evals/s."""
    device = resolve_device(device)
    cfg, img, mask, theta0, p0, inv_mass = _crowded_setup(n_chains, device)
    fused = flc.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.n_stars, n_leapfrog)
    _, grad0 = make_potential_and_grad(cfg.scene, img, cfg.prior)(theta0, mask)
    return _timed_leapfrog(f"crowded leapfrog (B5), {n_chains} chains", fused,
                           lambda: flc.LAUNCHES, theta0, p0, grad0, 0.0005, inv_mass, mask,
                           n_leapfrog, n_scan, repeats, device)[0]


def bench_plain_crowded(n_chains: int = 1024, n_leapfrog: int = 10, n_scan: int = 10,
                        repeats: int = 3, device="cuda", reduced: dict | None = None) -> float:
    """The plain leapfrog at B5's bench shape (bench.py:478).  Returns
    evals/s."""
    device = resolve_device(device)
    cfg, img, mask, theta0, p0, inv_mass = _crowded_setup(n_chains, device)
    return _bench_plain_leapfrog(f"plain crowded leapfrog, {n_chains} chains", cfg, img,
                                 mask, theta0, p0, inv_mass, 0.0005, n_leapfrog, n_scan,
                                 repeats, device, reduced)[0]


def _total_flux_ess(thetas: torch.Tensor) -> float:
    """ESS of the permutation-invariant total flux, pooled over chains."""
    return diagnostics.ess(torch.exp(thetas[..., 2]).sum(-1).cpu().numpy())


def bench_ess_per_sec(n_chains: int = 256, n_samples: int = 200, n_warmup: int = 300,
                      device="cuda"):
    """NUTS total-flux ESS a second of post-warmup wall (bench.py:373): eps
    0.05, max depth 8, every leaf one launch of B1 at L = 1; warmup, one
    untimed sampling leg, then a timed one.  Returns (ESS/s, ESS, s)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    pg = make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    leaf = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, 1)
    kernel = make_nuts_kernel(leaf, mask, NUTSConfig(step_size=0.05, max_depth=8),
                              torch.Generator(device).manual_seed(2))
    wr = driver.warmup(driver.init_chain_states(theta0, grad_fn), kernel, n_warmup,
                       step_size=0.05)
    r = driver.sample(wr.states, kernel, n_samples, wr.step_size, wr.inv_mass)
    _sync(device)
    before = fl.STATIC_LAUNCHES
    t0 = time.perf_counter()
    r = driver.sample(r.final_states, kernel, n_samples, wr.step_size, wr.inv_mass)
    _sync(device)
    dt = time.perf_counter() - t0
    label = f"NUTS ESS, {n_chains} chains"
    _check_ran(label, fl.STATIC_LAUNCHES - before, device)
    _check_finite(label, r.final_states.theta)
    ess = _total_flux_ess(r.thetas)
    return ess / dt, ess, dt


def bench_ess_chees(n_chains: int = 256, n_samples: int = 200, n_warmup: int = 300,
                    device="cuda"):
    """ChEES total-flux ESS a second on NUTS's protocol (bench.py:400):
    ChEESConfig(step_size=0.05) and no relocate, as bench.py:416, each
    iteration one launch of B1's kernel with the adapted step count read
    from the device (B2's contract).  Returns (ESS/s, ESS, s, T)."""
    device = resolve_device(device)
    cfg, truth, img, mask, theta0, p0, inv_mass = _bench_setup(n_chains, device)
    pg = make_potential_and_grad(cfg.scene, img, cfg.prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731
    impl = make_fused_leapfrog_impl(cfg.scene, img, cfg.prior, cfg.kmax)
    ccfg = ChEESConfig(step_size=0.05)
    generator = torch.Generator(device).manual_seed(2)
    res, ad = run_chees(generator, grad_fn, theta0, mask, n_samples, n_warmup, ccfg,
                        leapfrog_impl=impl)
    args = (grad_fn, mask, n_samples, ad["step_size"], ad["inv_mass"], ad["traj_length"],
            ccfg, generator, impl)
    r = chees_sample(res.final_states, *args)
    _sync(device)
    before = fl.DYN_LAUNCHES
    t0 = time.perf_counter()
    r = chees_sample(r.final_states, *args)
    _sync(device)
    dt = time.perf_counter() - t0
    label = f"ChEES ESS, {n_chains} chains"
    _check_ran(label, fl.DYN_LAUNCHES - before, device)
    _check_finite(label, r.final_states.theta)
    ess = _total_flux_ess(r.thetas)
    return ess / dt, ess, dt, float(ad["traj_length"])


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    if device.type != "cuda":
        return {"name": str(device), "power_limit": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    name, limit = (s.strip() for s in smi[device.index or 0].split(","))
    return {"name": name, "power_limit": limit}


def full_document(rate: float, best: float, chains: int, n_leapfrog: int, n_scan: int,
                  repeats: int, np_rate: float, device) -> dict:
    """bench.py --full's document (bench.py:668-711) under the port's keys,
    the headline's (rate, best s) passed in."""
    device = resolve_device(device)
    reduced = {}
    c1k = min(chains, 1024)
    full = {"cuda_fused_leapfrog_evals_per_sec": round(rate, 1),
            "cuda_best_ms": round(best * 1e3, 2), "chains": chains}
    plain_rate, _ = bench_plain_grad_evals(chains, n_leapfrog, n_scan, repeats, device,
                                           reduced)
    full["plain_leapfrog_evals_per_sec"] = round(plain_rate, 1)
    full["cuda_vs_plain"] = round(rate / plain_rate, 2)
    full["cuda_rhmc_steps_per_sec"] = round(bench_fused_rhmc_steps(c1k, device=device)[0], 1)
    diag_rate, _ = bench_plain_rhmc_diag_steps(c1k, device=device, reduced=reduced)
    full["rhmc_diag_steps_per_sec"] = round(diag_rate, 1)
    cdiag_rate, _ = bench_fused_rhmc_diag_steps(c1k, device=device)
    full["cuda_rhmc_diag_steps_per_sec"] = round(cdiag_rate, 1)
    full["cuda_rhmc_diag_vs_plain"] = round(cdiag_rate / diag_rate, 2)
    cr_plain, cr_cuda = bench_rhmc_diag_crowded(device=device, reduced=reduced)
    full["crowded_rhmc_diag_plain_steps_per_sec"] = round(cr_plain, 1)
    full["crowded_rhmc_diag_cuda_steps_per_sec"] = round(cr_cuda, 1)
    full["crowded_rhmc_diag_cuda_vs_plain"] = round(cr_cuda / cr_plain, 2)
    ess_rate, ess, _ = bench_ess_per_sec(device=device)
    full["nuts_ess_per_sec"] = round(ess_rate, 1)
    full["nuts_ess"] = round(float(ess), 1)
    for n, suffix in ((256, ""), (1024, "_1024")):
        ch_rate, ch_ess, _, traj = bench_ess_chees(n_chains=n, device=device)
        full[f"chees_ess_per_sec{suffix}"] = round(ch_rate, 1)
        full[f"chees_ess{suffix}"] = round(float(ch_ess), 1)
        full[f"chees_traj_length{suffix}"] = round(traj, 3)
    full["crowded_field_plain_evals_per_sec"] = round(
        bench_plain_crowded(device=device, reduced=reduced), 1)
    full["crowded_field_cuda_evals_per_sec"] = round(bench_fused_crowded(device=device), 1)
    sweep = {}
    for c in (1024, 8192):
        sweep[str(c)] = round(bench_fused_grad_evals(c, n_leapfrog, n_scan, 2, device)[0], 1)
    sweep[str(chains)] = round(rate, 1)
    full["chain_sweep_evals_per_sec"] = sweep
    cfg = CONFIGS["cfg2_nuts"]
    bound = b1_bound_evals_per_sec(cfg.scene, cfg.kmax)
    full["b1_bound_evals_per_sec"] = round(bound, 1)
    full["chain_sweep_bound_share"] = {c: round(r / bound, 4) for c, r in sweep.items()}
    full["numpy_baseline_evals_per_sec"] = round(np_rate, 1)
    full["device"] = device_info(device)
    full["torch"] = torch.__version__
    full["cuda"] = torch.version.cuda
    full["reduced"] = reduced
    return full


def headline(rate: float, np_rate: float) -> dict:
    """bench.py's last line; vs_baseline from the printed value."""
    value = round(rate, 1)
    return {"metric": "leapfrog_grad_evals_per_sec_per_chip", "value": value,
            "unit": "evals/s", "vs_baseline": round(value / np_rate, 2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(d: int, device: torch.device, n_chains: int, n_samples: int, n_leapfrog: int,
               verify: bool) -> list[dict]:
    """d processes of this module, one rank each of a group with a
    ``tcp://127.0.0.1`` rendezvous; returns each rank's row."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = []
    for r in range(d):
        env = dict(os.environ, LOCAL_RANK=str(r))
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "starcat_torch.bench", "scaling-rank", str(d), str(r), init,
             device.type, str(n_chains), str(n_samples), str(n_leapfrog), str(int(verify))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO))
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"bench scaling: rank {r} of {d} returned {p.returncode}:\n"
                               f"{err[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in logs]


def scaling_rank(d: int, rank: int, init_method: str, device: str, n_chains: int,
                 n_samples: int, n_leapfrog: int, verify: bool) -> dict:
    """One rank of a scaling row: the flagship HMC head (B1, L = n_leapfrog,
    eps 0.02) on this rank's shard of floor(n_chains / d) d chains; a
    barrier, a warm sampling leg, a barrier, then n_samples timed draws.
    ``verify``: the draws hold this rank's c / d chains, and a five-step
    pooled warmup issues collectives exactly when d > 1 (dist.GATHERS)."""
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)   # one core a gloo rank, as a device of its own
    dist.init_distributed(device, init_method=init_method, world_size=d, rank=rank)
    try:
        mesh = dist.make_mesh()
        dev = mesh.device
        cfg, truth, img = _scene("cfg2_nuts", dev)
        mask = torch.ones(cfg.kmax, device=dev)
        c = max(n_chains // d, 1) * d
        theta0 = dist.shard((truth[None] + 0.01 * _normal(0, (c,) + tuple(truth.shape))
                             ).to(dev), mesh)
        pg = make_potential_and_grad(cfg.scene, img, cfg.prior)
        grad_fn = lambda th: pg(th, mask)  # noqa: E731
        fused = fl.make_fused_leapfrog(cfg.scene, img, cfg.prior, cfg.kmax, n_leapfrog)
        kernel = make_hmc_kernel(
            lambda th, p, e, im, m, n, g: fused(th, p, e, im, m, grad=g), mask,
            HMCConfig(step_size=0.02, n_leapfrog=n_leapfrog),
            torch.Generator(dev).manual_seed(1), mesh)
        states = driver.init_chain_states(theta0, grad_fn)
        eps = torch.tensor(0.02, device=dev)
        inv_mass = torch.ones(truth.shape, device=dev)
        collectives = None
        if verify:
            before = dist.GATHERS
            driver.warmup(states, kernel, 5, step_size=0.02, mesh=mesh)
            collectives = dist.GATHERS - before
            if (collectives > 0) != (d > 1):
                raise RuntimeError(f"bench scaling: the pooled warmup issued {collectives} "
                                   f"collectives on {d} ranks")
        dist.barrier(mesh)
        before = fl.STATIC_LAUNCHES
        r = driver.sample(states, kernel, n_samples, eps, inv_mass)
        _sync(dev)
        dist.barrier(mesh)
        t0 = time.perf_counter()
        r = driver.sample(r.final_states, kernel, n_samples, eps, inv_mass)
        _sync(dev)
        dt = time.perf_counter() - t0
        label = f"scaling rank {rank} of {d}"
        _check_launches(label, fl.STATIC_LAUNCHES - before, 2 * n_samples, dev)
        _check_finite(label, r.final_states.theta)
        if verify and r.thetas.shape[0] != c // d:
            raise RuntimeError(f"bench scaling: rank {rank} holds {r.thetas.shape[0]} chains' "
                               f"draws, not {c // d}")
        return {"rank": rank, "devices": d, "chains": c, "local_chains": r.thetas.shape[0],
                "sec": dt, "collectives": collectives}
    finally:
        torch.distributed.destroy_process_group()


def bench_scaling(device_counts=None, n_chains: int = 1024, n_samples: int = 100,
                  n_leapfrog: int = 10, verify: bool = False, device="cuda") -> dict:
    """Barrier-synchronised samples/s of the flagship HMC head over 1, 2, 4,
    ... ranks (bench.py:525): for each device count d (those of
    SCALING_COUNTS the host has cards for, two gloo ranks at most on the
    CPU, or ``device_counts``), d processes of a torch.distributed group,
    NCCL one card a rank or gloo, each run scaling_rank.  A row's seconds
    are its slowest rank's; efficiency is against the first row's rate per
    device.  On the CPU the walls are a plumbing check, not a speed."""
    device = resolve_device(device)
    if device_counts is None:
        avail = torch.cuda.device_count() if device.type == "cuda" else 2
        device_counts = [d for d in SCALING_COUNTS if d <= avail]
    rows = []
    for d in device_counts:
        ranks = _run_ranks(d, device, n_chains, n_samples, n_leapfrog, verify)
        c = ranks[0]["chains"]
        dt = max(r["sec"] for r in ranks)
        rows.append({"devices": d, "chains": c, "samples_per_sec": round(c * n_samples / dt, 1),
                     "sec": round(dt, 4)})
    base = rows[0]["samples_per_sec"] / rows[0]["devices"]
    for row in rows:
        row["efficiency_vs_1dev"] = round(row["samples_per_sec"] / (base * row["devices"]), 4)
    return {
        "metric": "hmc_samples_per_sec_scaling",
        "unit": "chains*draws/s",
        "workload": f"cfg2 scene, {n_leapfrog}-leapfrog HMC, {n_samples} draws, "
                    "barrier-synced",
        "backend": device.type,
        "process_group": "nccl" if device.type == "cuda" else "gloo",
        "device": device_info(device),
        "points": rows,
    }


if __name__ == "__main__":
    if sys.argv[1:2] != ["scaling-rank"]:
        sys.exit("usage: python -m starcat_torch.bench scaling-rank D RANK INIT DEVICE "
                 "CHAINS SAMPLES LEAPFROG VERIFY (one rank of bench_scaling; the "
                 "benchmark is python -m starcat_torch bench)")
    d, rank, init, dev, c, n, lf, ver = sys.argv[2:10]
    print(json.dumps(scaling_rank(int(d), int(rank), init, dev, int(c), int(n), int(lf),
                                  bool(int(ver)))))
