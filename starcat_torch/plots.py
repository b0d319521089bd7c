"""Plotting and visual diagnostics (port of starcat/plots.py): trace plots,
pairwise posterior ("corner") panels for single-star runs, posterior-mean
reconstructed scenes and residual maps, from any head's output.

matplotlib is imported lazily, when a figure is made, so the package
imports without it; every function returns the Figure.  The scenes are
rendered on the CPU with the port's own ``constrain`` and ``render_scene``
(the draws are already numpy arrays on the host).
"""
from __future__ import annotations

import numpy as np
import torch

from .potential import constrain
from .scene import SceneSpec, render_scene

REPORT_PLOTS = ("trace", "corner", "reconstruction")


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def trace_plot(thetas: np.ndarray, names=("ux", "uy", "log f"), max_chains: int = 8):
    """Per-coordinate trace plots; thetas (C, N, K, 3) -> first star."""
    plt = _plt()
    th = np.asarray(thetas)[:max_chains, :, 0, :]
    fig, axes = plt.subplots(3, 1, figsize=(8, 6), sharex=True)
    for j, ax in enumerate(axes):
        for c in range(th.shape[0]):
            ax.plot(th[c, :, j], lw=0.5, alpha=0.7)
        ax.set_ylabel(names[j])
    axes[-1].set_xlabel("draw")
    fig.tight_layout()
    return fig


def corner_plot(thetas: np.ndarray, spec: SceneSpec, truth=None):
    """Pairwise posterior panels of (x, y, flux) for a single-star run.

    thetas: (C, N, 1, 3) unconstrained draws; truth: optional (x, y, f).
    """
    th = np.asarray(thetas)
    if th.shape[-2] != 1:
        raise ValueError(
            f"corner_plot is for single-star runs; got K={th.shape[-2]} "
            "(multi-star posteriors are exchangeable — use reconstruction_plot)"
        )
    plt = _plt()
    x, y, f = (a.numpy() for a in constrain(torch.from_numpy(th.reshape(-1, 3)), spec))
    cols = [x, y, f]
    names = ["x [px]", "y [px]", "flux"]
    fig, axes = plt.subplots(3, 3, figsize=(8, 8))
    for i in range(3):
        for j in range(3):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(cols[i], bins=50, color="C0", alpha=0.8)
                if truth is not None:
                    ax.axvline(float(np.asarray(truth[i]).ravel()[0]), color="C3")
            else:
                ax.hist2d(cols[j], cols[i], bins=40, cmap="Blues")
                if truth is not None:
                    ax.plot(
                        float(np.asarray(truth[j]).ravel()[0]),
                        float(np.asarray(truth[i]).ravel()[0]),
                        "x", color="C3", ms=8,
                    )
            if i == 2:
                ax.set_xlabel(names[j])
            if j == 0:
                ax.set_ylabel(names[i])
    fig.tight_layout()
    return fig


def posterior_mean_scene(thetas: np.ndarray, masks: np.ndarray, spec: SceneSpec,
                         n_draws: int = 64) -> np.ndarray:
    """The expected-counts image averaged over ``n_draws`` draws spread
    evenly over the (chain, draw) axes, (H, W) float64: the reference's
    reconstruction_plot loop.  masks: (K,) shared, (C, K) per chain or
    particle, or (C, N, K) per draw."""
    th = np.asarray(thetas)
    if th.ndim == 3:  # (N, K, 3) single chain -> add a chain axis
        th = th[None]
    flat = th.reshape(-1, th.shape[-2], 3)  # (C*N, K, 3)
    m = np.asarray(masks)
    if m.ndim == 1:    # one static mask for every draw
        masks_flat = np.broadcast_to(m, (flat.shape[0],) + m.shape)
    elif m.ndim == 2:  # per-chain/particle masks (C, K): repeat over draws
        masks_flat = np.repeat(m, th.shape[1], axis=0)
    else:              # per-draw masks (C, N, K) — trans-dimensional MCMC
        masks_flat = m.reshape(-1, m.shape[-1])

    idx = np.linspace(0, flat.shape[0] - 1, min(n_draws, flat.shape[0])).astype(int)
    lam = np.zeros((spec.height, spec.width))
    for i in idx:
        x, y, f = constrain(torch.tensor(flat[i]), spec)
        mk = torch.tensor(masks_flat[i], dtype=x.dtype)
        lam += render_scene(x, y, f, mk, spec).numpy()
    return lam / len(idx)


def reconstruction_plot(
    thetas: np.ndarray,
    masks: np.ndarray,
    spec: SceneSpec,
    image: np.ndarray,
    n_draws: int = 64,
):
    """Data | posterior-mean reconstructed scene | Pearson residual map."""
    plt = _plt()
    lam = posterior_mean_scene(thetas, masks, spec, n_draws)
    img = np.asarray(image)
    resid = (img - lam) / np.sqrt(np.maximum(lam, 1e-6))
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, data, title, kw in [
        (axes[0], img, "data", {}),
        (axes[1], lam, "posterior mean scene", {}),
        (axes[2], resid, "Pearson residual", dict(cmap="RdBu_r", vmin=-4, vmax=4)),
    ]:
        im = ax.imshow(data, origin="lower", **kw)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return fig


def report_plots(out) -> tuple[str, ...]:
    """The PNGs save_report writes for a SampleOutput: the corner panels
    only for a single-star run with one shared mask."""
    single = out.thetas.shape[2] == 1 and out.masks.ndim == 1
    return tuple(n for n in REPORT_PLOTS if n != "corner" or single)


def save_report(out, image, path_prefix: str):
    """Write trace/corner/reconstruction PNGs for a SampleOutput; returns
    their paths."""
    figs = {}
    th = out.thetas
    if th.shape[1] == 1 and th.shape[0] > 8:
        # SMC/ADVI pack draws on axis 0 with N=1; transpose so the trace
        # shows the particle population as one pseudo-chain of draws.
        th = th.transpose(1, 0, 2, 3)
    figs["trace"] = trace_plot(th)
    if "corner" in report_plots(out):
        truth = [out.stats["truth"]["x"][0], out.stats["truth"]["y"][0],
                 out.stats["truth"]["f"][0]]
        figs["corner"] = corner_plot(out.thetas, out.config.scene, truth)
    figs["reconstruction"] = reconstruction_plot(
        out.thetas, out.masks, out.config.scene, image
    )
    plt = _plt()
    paths = []
    for name, fig in figs.items():
        p = f"{path_prefix}_{name}.png"
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    return paths
