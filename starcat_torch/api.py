"""High-level API (port of starcat/api.py): build the scene and potential
from a RunConfig and run one head on it, on an explicitly named device.

Heads: ``hmc`` (and ``oracle``, the cfg0 preset's name for it) and
``chees``.  ``RunConfig.kernel`` picks the trajectory: the fused CUDA kernel
(``stats["kernel"] == "cuda_fused"``) or the plain torch leapfrog
(``"torch"``); ``stats["kernel_launches"]`` counts the kernel's launches in
the run.  The run draws every random number from one ``torch.Generator`` on
the run's device, seeded from ``seed``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import diagnostics, fused_leapfrog
from .chees import make_chees_relocate, make_fused_leapfrog_impl, run_chees
from .configs import RunConfig
from .hmc import run_hmc, run_hmc_fused
from .potential import constrain, make_potential_and_grad


@dataclass
class SampleOutput:
    config: RunConfig
    thetas: np.ndarray          # (C, N, K, 3) draws
    masks: np.ndarray           # (K,)
    stats: dict[str, Any] = field(default_factory=dict)


def resolve_kernel(pref: str, device: torch.device, cfg: RunConfig) -> str:
    """RunConfig.kernel -> "cuda" or "torch".  Nothing falls back: "cuda"
    off a CUDA device or off the kernel's domain raises, and "auto" on a
    CUDA device takes the kernel (which raises off its domain)."""
    if pref not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be 'auto'|'cuda'|'torch', got {pref!r}")
    if pref == "torch":
        return "torch"
    if pref == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if device.type != "cuda":
        raise ValueError(f"kernel='cuda' needs a CUDA device, got {device}")
    fused_leapfrog.check_domain(cfg.scene, cfg.kmax)
    return "cuda"


def sample(cfg: RunConfig, device, seed: int = 0, image=None) -> SampleOutput:
    """Run the configured head on the config's mock scene (or ``image``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    truth_theta, mock_img = cfg.make_data()
    img = (mock_img if image is None else torch.as_tensor(image)).to(
        device=device, dtype=torch.float32)
    spec, prior = cfg.scene, cfg.prior
    mask = torch.ones(cfg.kmax, dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    pg = make_potential_and_grad(spec, img, prior)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731

    kernel = resolve_kernel(cfg.kernel, device, cfg)
    stats: dict[str, Any] = {"kernel": "cuda_fused" if kernel == "cuda" else "torch"}
    launches0 = fused_leapfrog.LAUNCHES
    t_start = time.perf_counter()
    theta0 = _init_chains(generator, cfg, truth_theta.to(device))

    if cfg.head in ("hmc", "oracle"):
        if kernel == "cuda":
            res, wr = run_hmc_fused(generator, spec, img, prior, theta0, mask,
                                    cfg.n_samples, cfg.n_warmup, cfg.hmc,
                                    thin=cfg.thin)
        else:
            res, wr = run_hmc(generator, grad_fn, theta0, mask, cfg.n_samples,
                              cfg.n_warmup, cfg.hmc, thin=cfg.thin)
        stats.update(step_size=float(wr.step_size))
    elif cfg.head == "chees":
        impl = (make_fused_leapfrog_impl(spec, img, prior, cfg.kmax)
                if kernel == "cuda" else None)
        # the relocate move hops metastable star/flux configurations; the
        # scene is known here, so it is on at the preset's cadence
        reloc = (make_chees_relocate(spec, img, prior, generator)
                 if cfg.chees.relocate_every > 0 else None)
        res, ad = run_chees(generator, grad_fn, theta0, mask, cfg.n_samples,
                            cfg.n_warmup, cfg.chees, leapfrog_impl=impl,
                            relocate_fn=reloc)
        stats.update(step_size=float(ad["step_size"]),
                     traj_length=float(ad["traj_length"]),
                     warmup_divergences=ad["warmup_divergences"],
                     traj_drift=ad["traj_drift"],
                     traj_converged=ad["traj_converged"],
                     warmup_extensions=ad["warmup_extensions"],
                     eq_stages=ad["eq_stages"],
                     eq_disagreement=ad["eq_disagreement"])
    else:
        raise ValueError(f"head {cfg.head!r} is not ported yet "
                         "(ROADMAP.md queue A); ported heads: hmc, chees")
    thetas = res.thetas.cpu().numpy()
    stats.update(accept=float(res.accept_prob.mean()),
                 divergences=int(res.diverged.sum()))
    stats["wall_seconds"] = time.perf_counter() - t_start
    stats["kernel_launches"] = fused_leapfrog.LAUNCHES - launches0
    stats["device"] = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device))
    stats["truth"] = {k: v.numpy() for k, v in zip("xyf", constrain(truth_theta, spec))}
    return SampleOutput(cfg, thetas, mask.cpu().numpy(), stats)


def _init_chains(generator: torch.Generator, cfg: RunConfig,
                 truth_theta: torch.Tensor) -> torch.Tensor:
    """Chains start near the truth with a small jitter (mock-data runs)."""
    jit = 0.01 * torch.randn((cfg.n_chains,) + tuple(truth_theta.shape),
                             generator=generator, device=truth_theta.device)
    return truth_theta[None] + jit


def summarize_output(out: SampleOutput) -> dict[str, Any]:
    """Permutation-safe posterior summaries of a fixed-K run: the total
    flux, and per-coordinate moments when the catalog holds one star."""
    th = out.thetas  # (C, N, K, 3)
    alive = out.masks[None, None, :]
    summ = {"total_flux": diagnostics.summarize((np.exp(th[..., 2]) * alive).sum(-1))}
    if th.shape[2] == 1:
        w, h = out.config.scene.width, out.config.scene.height
        summ["x"] = diagnostics.summarize(w / (1 + np.exp(-th[:, :, 0, 0])))
        summ["y"] = diagnostics.summarize(h / (1 + np.exp(-th[:, :, 0, 1])))
        summ["flux"] = diagnostics.summarize(np.exp(th[:, :, 0, 2]))
    return summ
