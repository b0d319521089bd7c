"""High-level API (port of starcat/api.py): build the scene and potential
from a RunConfig and run one head on it, on an explicitly named device.

Heads: ``hmc`` (and ``oracle``, the cfg0 preset's name for it), ``nuts``,
``chees``, ``rhmc`` (full or diagonal Fisher metric), ``smc``, ``advi`` and
``transdim``.  ``RunConfig.kernel`` picks the trajectory: the head's CUDA
kernel or its plain torch version.  ``stats["kernel"]`` names what ran:
``cuda_fused`` / ``torch`` for hmc, nuts, chees and advi (nuts's leaves and
advi's gradients are the plain leapfrog kernel's), ``rhmc_full_cuda`` /
``rhmc_full_torch`` or ``rhmc_diag_cuda`` / ``rhmc_diag_torch`` for rhmc,
and ``<mutation>_cuda`` / ``<mutation>_torch`` for smc and transdim (the
smc ``hmc`` mutation has no kernel and is always ``hmc_torch``);
``stats["trajectory_kernel"]``
names the CUDA kernel (B1, B2, B3, B4, B5, B6 or B6c, chosen by
dispatch.trajectory_kernel from the scene's shape; "torch" on the plain
path) and ``stats["kernel_launches"]`` counts the trajectory kernels'
launches.  The smc and transdim heads also give ``stats["sweep_kernel"]``,
the path of their trans-d sweeps (``fused_transdim_sweep`` with
kernel="cuda", else ``torch``), and ``stats["sweep_launches"]``, that
kernel's launches in the run.
The run draws every random number from one ``torch.Generator`` on the
run's device, seeded from ``seed``.

``mesh`` (dist.make_mesh) shards the chain (or particle) axis over the
processes of a torch.distributed group, one device each: every rank runs
this call with the same arguments, holds C / W chains, runs each head on its
shard on its own kernel, and returns the gathered full SampleOutput, the
same bits as the one-process run (dist.py says how).  ADVI, one fit,
ignores the mesh, as the reference does.

``metrics_path`` streams the run's JSONL records (metrics.MetricsLogger);
``checkpoint_path`` writes a checkpoint after every sampling block (SMC:
every temperature step), and ``resume=True`` continues a killed run from it
and returns only the remaining draws, the same bits as the uninterrupted
run's.  ADVI, a seconds-scale fit, takes no checkpoint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import (
    advi,
    diagnostics,
    dispatch,
    dist,
    fused_leapfrog,
    fused_leapfrog_crowded,
    fused_rhmc,
    fused_rhmc_crowded,
    fused_rhmc_diag,
    fused_rhmc_diag_crowded,
    fused_transdim_sweep,
)
from .chees import make_chees_relocate, make_fused_leapfrog_impl, run_chees
from .configs import RunConfig
from .hmc import run_hmc, run_hmc_fused
from .metrics import MetricsLogger
from .nuts import run_nuts
from .potential import constrain, make_potential_and_grad, sample_prior
from .rhmc import check_metric, run_rhmc, run_rhmc_fused
from .smc import MUTATIONS, check_mutation, run_smc
from .transdim_mcmc import TD_MUTATIONS, run_transdim

PORTED_HEADS = ("hmc", "oracle", "nuts", "chees", "rhmc", "smc", "advi", "transdim")
# the ROADMAP.md items that port the reference's other heads: none left
UNPORTED_HEADS: dict[str, str] = {}
ADVI_DRAWS = 1000   # iid draws from the fitted q, as the reference's record
ADVI_WINDOWS = 5    # advi_window records of the ELBO trace
_KERNELS = (fused_leapfrog, fused_leapfrog_crowded, fused_rhmc, fused_rhmc_crowded,
            fused_rhmc_diag, fused_rhmc_diag_crowded)


@dataclass
class SampleOutput:
    config: RunConfig
    thetas: np.ndarray          # (C, N, K, 3) draws
    masks: np.ndarray           # (K,); per particle (P, K) for smc; per draw (C, N, K) for transdim
    stats: dict[str, Any] = field(default_factory=dict)
    inv_mass: np.ndarray | None = None  # the ChEES head's adapted diagonal (K, 3); else None


def _check_head(cfg: RunConfig) -> None:
    """Raise for a head or metric that is not ported yet (the trans-d
    head's mutation is checked where its kernel is made)."""
    if cfg.head not in PORTED_HEADS:
        item = UNPORTED_HEADS.get(cfg.head, "queue A")
        raise ValueError(f"head {cfg.head!r} is not ported yet (ROADMAP.md "
                         f"{item}); ported heads: {', '.join(PORTED_HEADS)}")
    if cfg.head == "rhmc":
        check_metric(cfg.rhmc.metric)
    if cfg.head == "smc":
        check_mutation(cfg.smc.mutation)
    if cfg.head == "transdim" and cfg.tdm.mutation not in TD_MUTATIONS:
        raise ValueError(f"unknown mutation {cfg.tdm.mutation!r}; ported: "
                         f"{', '.join(TD_MUTATIONS)}")


def _metric_of(cfg: RunConfig) -> str | None:
    """The Riemannian metric the head's kernel runs ("full": B6/B6c, "diag":
    B3/B4), or None for the plain leapfrog (B1/B2/B5; the smc hmc mutation)."""
    if cfg.head == "rhmc":
        return cfg.rhmc.metric
    if cfg.head == "smc":
        return MUTATIONS[cfg.smc.mutation]
    if cfg.head == "transdim" and cfg.tdm.mutation != "hmc":
        return "full" if cfg.tdm.mutation == "rhmc" else "diag"
    return None


def resolve_kernel(pref: str, device: torch.device, cfg: RunConfig) -> str:
    """RunConfig.kernel -> "cuda" or "torch".  Nothing falls back: "cuda"
    off a CUDA device or beyond the domains of both kernels of the head's
    pair (dispatch.py: B1/B5, B3/B4, B6/B6c; only K < 1) raises, and
    "auto" on a CUDA device takes the pair's kernel, as the JAX package's
    _select_kernel takes XLA beyond its Pallas kernels' gates."""
    if pref not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be 'auto'|'cuda'|'torch', got {pref!r}")
    metric = _metric_of(cfg)
    no_kernel = cfg.head == "smc" and metric is None
    if pref == "torch" or (pref == "auto" and no_kernel):
        return "torch"
    if pref == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if no_kernel:
        raise ValueError("the smc hmc mutation has no CUDA kernel (the plain "
                         "tempered leapfrog); use kernel=auto or torch")
    dispatch.trajectory_kernel(cfg.head, metric, cfg.scene, cfg.kmax)
    if device.type != "cuda":
        raise ValueError(f"kernel='cuda' needs a CUDA device, got {device}")
    return "cuda"


def sample(cfg: RunConfig, device, seed: int = 0, image=None,
           on_step=None, metrics_path: str | None = None,
           checkpoint_path: str | None = None, resume: bool = False,
           mesh: dist.Mesh | None = None) -> SampleOutput:
    """Run the configured head on the config's mock scene (or ``image``).
    ``on_step(state)``, when given, sees the SMC head's state after every
    temperature step (scripts/smc_trace.py records it).

    metrics_path: JSONL sink for the run's records.  checkpoint_path /
    resume: block checkpoints (SMC: step checkpoints); with resume=True a
    killed run continues from its last completed block and the output holds
    only the remaining draws.  mesh: shard the chains over the processes of
    a torch.distributed group (module docstring); C (SMC: P) must be a
    multiple of the world size."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    if cfg.head == "advi":
        mesh = None
    if mesh is not None:
        mesh.local(cfg.smc.n_particles if cfg.head == "smc" else cfg.n_chains)
    logger = MetricsLogger(metrics_path, cfg.name) if metrics_path is not None else None
    try:
        out = _sample(cfg, device, seed, image, on_step, logger, checkpoint_path, resume,
                      mesh)
    finally:
        if logger is not None:
            logger.close()
    return out


def _sample(cfg: RunConfig, device: torch.device, seed: int, image, on_step, logger,
            checkpoint_path: str | None, resume: bool, mesh) -> SampleOutput:
    if image is None:
        truth_theta, image = cfg.make_data()
    else:
        truth_theta = cfg.make_truth()
    img = torch.as_tensor(image).to(device=device, dtype=torch.float32)
    spec, prior = cfg.scene, cfg.prior
    mask = torch.ones(cfg.kmax, dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731

    _check_head(cfg)
    kernel = resolve_kernel(cfg.kernel, device, cfg)
    stats: dict[str, Any] = {
        "kernel": "cuda_fused" if kernel == "cuda" else "torch",
        "trajectory_kernel": (dispatch.trajectory_kernel(cfg.head, _metric_of(cfg),
                                                         cfg.scene, cfg.kmax)
                              if kernel == "cuda" else "torch")}
    # long runs sample in blocks of 250 draws (the same bits as one loop); a
    # checkpoint implies blocks
    block = 250 if cfg.n_samples > 300 else None
    if checkpoint_path is not None and block is None:
        block = max(1, cfg.n_samples // 4)
    ck = dict(block_size=block, checkpoint_path=checkpoint_path, resume=resume,
              logger=logger, mesh=mesh)
    if cfg.head in ("hmc", "oracle", "nuts", "rhmc"):
        ck["thin"] = cfg.thin
    launches0 = sum(k.LAUNCHES for k in _KERNELS)
    sweeps0 = fused_transdim_sweep.LAUNCHES
    t_start = time.perf_counter()
    theta0 = (dist.shard(_init_chains(generator, cfg, truth_theta.to(device)), mesh)
              if cfg.head not in ("smc", "advi", "transdim") else None)
    masks = mask.cpu().numpy()
    inv_mass = None

    if cfg.head in ("hmc", "oracle"):
        if kernel == "cuda":
            res, wr = run_hmc_fused(generator, spec, img, prior, theta0, mask,
                                    cfg.n_samples, cfg.n_warmup, cfg.hmc, **ck)
        else:
            res, wr = run_hmc(generator, grad_fn, theta0, mask, cfg.n_samples,
                              cfg.n_warmup, cfg.hmc, **ck)
        stats.update(step_size=float(wr.step_size))
    elif cfg.head == "nuts":
        # every leaf is one step of the fused leapfrog, eps signed per chain
        leaf = (dispatch.make_leapfrog(spec, img, prior, cfg.kmax, 1)
                if kernel == "cuda" else None)
        res, wr = run_nuts(generator, grad_fn, theta0, mask, cfg.n_samples, cfg.n_warmup,
                           cfg.nuts, leaf=leaf, **ck)
        stats.update(step_size=float(wr.step_size))
    elif cfg.head == "chees":
        impl = (make_fused_leapfrog_impl(spec, img, prior, cfg.kmax)
                if kernel == "cuda" else None)
        # the relocate move hops metastable star/flux configurations; the
        # scene is known here, so it is on at the preset's cadence
        reloc = (make_chees_relocate(spec, img, prior, generator, mesh=mesh)
                 if cfg.chees.relocate_every > 0 else None)
        res, ad = run_chees(generator, grad_fn, theta0, mask, cfg.n_samples,
                            cfg.n_warmup, cfg.chees, leapfrog_impl=impl,
                            relocate_fn=reloc, **ck)
        inv_mass = ad["inv_mass"].cpu().numpy()
        stats.update(step_size=float(ad["step_size"]),
                     traj_length=float(ad["traj_length"]),
                     warmup_divergences=ad["warmup_divergences"])
        if "traj_converged" in ad:
            # a resumed run restores T from its checkpoint: no warmup to report
            stats.update(traj_drift=ad["traj_drift"],
                         traj_converged=ad["traj_converged"],
                         warmup_extensions=ad["warmup_extensions"],
                         eq_stages=ad["eq_stages"],
                         eq_disagreement=ad["eq_disagreement"])
    elif cfg.head == "rhmc":
        run = run_rhmc_fused if kernel == "cuda" else run_rhmc
        res, wr = run(generator, spec, img, prior, theta0, mask, cfg.n_samples,
                      cfg.n_warmup, cfg.rhmc, **ck)
        stats.update(kernel=f"rhmc_{cfg.rhmc.metric}_{kernel}",
                     step_size=float(wr.step_size),
                     solver_rejections=int(res.solver_fail.sum()))
    elif cfg.head == "smc":
        res = run_smc(generator, spec, img, prior, cfg.kmax, cfg.smc,
                      fused=kernel == "cuda", on_step=on_step,
                      checkpoint_path=checkpoint_path, resume=resume, logger=logger,
                      mesh=mesh)
        beta = float(res.beta)
        stats.update(kernel=f"{cfg.smc.mutation.removesuffix('_pallas')}_{kernel}",
                     log_z=float(res.log_z), n_temp_steps=int(res.n_steps),
                     accept=float(res.mean_accept), step_size=float(res.eps),
                     beta=beta, final_rounds=int(res.final_done),
                     divergences=int(res.divergences),
                     solver_rejections=int(res.solver_rejections))
        if res.island_diag is not None:
            stats.update(res.island_diag)
        if beta < 1.0:
            stats["warning"] = (f"tempering capped at beta={beta:.4f} "
                                f"(max_steps={cfg.smc.max_steps}); raise smc.max_steps")
        thetas = res.theta.cpu().numpy()[:, None]     # (P, 1, K, 3)
        masks = res.mask.cpu().numpy()                # (P, K)
    elif cfg.head == "advi":
        # the draws are iid from q in smc's (P, 1, K, 3) layout
        # (summarize_output moves them onto the draw axis)
        agrad = (dispatch.make_grad_fn(spec, img, prior, mask) if kernel == "cuda"
                 else grad_fn)
        mu0 = sample_prior(generator, cfg.kmax, prior, device)
        n_mc = cfg.advi.n_mc
        if cfg.advi.full_rank:
            xi = torch.randn((cfg.advi.n_steps, n_mc, mu0.numel()), generator=generator,
                             device=device)
            res = advi.fit_advi_fullrank(agrad, mu0, xi, cfg.advi)
            draws = advi.advi_sample_fullrank(generator, res, ADVI_DRAWS)
            stats["family"] = "full_rank"
        else:
            xi = torch.randn((cfg.advi.n_steps, n_mc) + tuple(mu0.shape),
                             generator=generator, device=device)
            res = advi.fit_advi(agrad, mu0, mask, xi, cfg.advi)
            draws = advi.advi_sample(generator, res, mask, ADVI_DRAWS)
            stats["family"] = "mean_field"
        thetas = draws.cpu().numpy()[:, None]
        stats["elbo"] = float(res.elbo_trace[-50:].mean())
        if logger is not None:
            trace = res.elbo_trace.cpu()
            for i in range(ADVI_WINDOWS):
                lo, hi = i * len(trace) // ADVI_WINDOWS, (i + 1) * len(trace) // ADVI_WINDOWS
                if lo < hi:
                    logger.log("advi_window", window=i, step_lo=lo, step_hi=hi,
                               elbo=float(trace[lo:hi].mean()))
    else:  # transdim
        res, eps = run_transdim(generator, spec, img, prior, cfg.kmax,
                                cfg.n_chains, cfg.n_samples, cfg.n_warmup,
                                cfg.tdm, fused=kernel == "cuda", **ck)
        masks = res.masks.cpu().numpy()  # (C, N, K) per-draw alive masks
        stats.update(kernel=f"{cfg.tdm.mutation}_{kernel}",
                     step_size=float(eps), td_accept=float(res.td_accept.mean()),
                     solver_rejections=int(res.solver_fail.sum()))
    if cfg.head not in ("smc", "advi"):
        thetas = res.thetas.cpu().numpy()
        stats.update(accept=float(res.accept_prob.mean()),
                     divergences=int(res.diverged.sum()))
    stats["wall_seconds"] = time.perf_counter() - t_start
    stats["kernel_launches"] = sum(k.LAUNCHES for k in _KERNELS) - launches0
    if logger is not None:
        logger.log("run_complete", head=cfg.head,
                   **{k: v for k, v in stats.items() if isinstance(v, (int, float))})
    if cfg.head in ("smc", "transdim"):
        # set after run_complete: the stream's records keep their keys
        stats["sweep_kernel"] = "fused_transdim_sweep" if kernel == "cuda" else "torch"
        stats["sweep_launches"] = fused_transdim_sweep.LAUNCHES - sweeps0
    stats["device"] = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device))
    stats["truth"] = {k: v.numpy() for k, v in zip("xyf", constrain(truth_theta, spec))}
    return SampleOutput(cfg, thetas, masks, stats, inv_mass)


def _init_chains(generator: torch.Generator, cfg: RunConfig,
                 truth_theta: torch.Tensor) -> torch.Tensor:
    """Chains start near the truth with a small jitter (mock-data runs)."""
    jit = 0.01 * torch.randn((cfg.n_chains,) + tuple(truth_theta.shape),
                             generator=generator, device=truth_theta.device)
    return truth_theta[None] + jit


def summarize_output(out: SampleOutput) -> dict[str, Any]:
    """Permutation-safe posterior summaries: the total flux, per-coordinate
    moments when a fixed-K catalog holds one star, and the star-count
    posterior (mode, mean, sd, pmf) for per-particle (P, K) or per-draw
    (C, N, K) masks.  SMC's (P, 1, K, 3) draws put the particles on the
    draw axis, so the sd and MCSE run across particles."""
    th = out.thetas  # (C, N, K, 3)
    mask = out.masks
    if mask.ndim == 1:
        alive = mask[None, None, :]
    elif mask.ndim == 2:      # per particle (smc)
        alive = mask[:, None, :]
    else:                     # per draw (transdim)
        alive = mask

    def series(a: np.ndarray) -> np.ndarray:
        return a.T if (a.shape[1] == 1 and a.shape[0] > 1) else a

    summ = {"total_flux": diagnostics.summarize(series((np.exp(th[..., 2]) * alive).sum(-1)))}
    if mask.ndim >= 2:
        counts = alive.sum(-1).reshape(-1).astype(int)
        kmax = th.shape[2]
        hist = np.bincount(counts, minlength=kmax + 1)[: kmax + 1]
        pn = hist / max(counts.size, 1)
        summ["star_count"] = {
            "mode": int(np.argmax(hist)),
            "mean": float(counts.mean()),
            "sd": float(counts.std()),
            "pmf": {str(i): round(float(q), 4) for i, q in enumerate(pn) if q > 0},
        }
    if mask.ndim == 1 and th.shape[2] == 1:
        w, h = out.config.scene.width, out.config.scene.height
        summ["x"] = diagnostics.summarize(series(w / (1 + np.exp(-th[:, :, 0, 0]))))
        summ["y"] = diagnostics.summarize(series(h / (1 + np.exp(-th[:, :, 0, 1]))))
        summ["flux"] = diagnostics.summarize(series(np.exp(th[:, :, 0, 2])))
    return summ
