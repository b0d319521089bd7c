"""Trans-dimensional catalog moves (port of starcat/transdim.py):
birth/death (prior or residual-driven births) and flux-conserving
split/merge on a fixed-capacity masked catalog, and the dimension-preserving
relocate move that the ChEES preset runs on every draw.

Target over the slot representation (K_max slots, n alive):

    pi(mask, theta) ∝ [ p(n) / C(K_max, n) ] * prod_alive p(theta_i) * L(D | theta)

with p(n) a Poisson(Lambda) truncated to [0, K_max]; the acceptance ratios
are the reference's (its module docstring derives them).

Batched over chains.  Each move is a pure function of its random inputs
(Gumbel noise for slot and pixel choices, uniforms, normals), so tests can
feed it the reference's own draws; :func:`draw_sweep` draws them from the
run's generator in a fixed order.  Like the reference, a move computes both
of its branches for every chain and selects per chain, and a slot update is
a one-hot ``torch.where``.

:func:`poisson_sweep` is the sweep at the tempered Poisson likelihood
beta log L, which the SMC and trans-d MCMC heads run: on the card, where
the head runs its kernels, one launch of a hand-written CUDA kernel
(fused_transdim_sweep.py), in which each chain computes only the move it
keeps; otherwise its plain version, :func:`poisson_sweep_reference`, which
is :func:`transdim_sweep` with that likelihood.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import metrics
from .potential import PriorSpec, constrain, log_likelihood, sample_prior, unconstrain
from .scene import SceneSpec, gaussian_profile_1d, pixel_centers, render_scene


class TransDimConfig(NamedTuple):
    lam_count: float = 5.0       # Poisson prior intensity Lambda on n
    split_sigma: float = 1.0     # sd of the split displacement (pixels)
    p_birth_death: float = 0.5   # prob of birth/death vs split/merge
    fmin: float = 1e-3           # floor used only to keep logs finite
    # "prior": birth positions uniform over the image; "residual": drawn
    # ∝ max(D − λ(current model), 0) + resid_floor per pixel
    birth_proposal: str = "prior"
    resid_floor: float = 1e-2


class MoveInfo(NamedTuple):
    accepted: torch.Tensor
    log_alpha: torch.Tensor
    move_type: torch.Tensor  # 0 birth, 1 death, 2 split, 3 merge, 4 relocate


def _gumbel_choice(gumbel: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Uniform choice among slots where weights > 0, given standard Gumbel
    noise of the weights' shape: (..., K) -> (...,) indices."""
    scores = torch.where(weights > 0, gumbel, torch.full_like(gumbel, -math.inf))
    return torch.argmax(scores, dim=-1)


def _set_slot(x: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """x with x[c, slot[c]] = value on every chain c: theta (C, K, 3) with
    value (C, 3), or a mask (C, K) with value a number."""
    hot = torch.nn.functional.one_hot(slot, x.shape[1]).to(torch.bool)
    if x.ndim == 3:
        return torch.where(hot[..., None], value[:, None, :], x)
    return torch.where(hot, value, x)


def _log_flux_prior_constrained(f: torch.Tensor, prior: PriorSpec) -> torch.Tensor:
    """log p_c(f) of the log-normal flux prior (density with respect to df)."""
    s = torch.log(f)
    z = (s - prior.logf_mean) / prior.logf_sigma
    return (-0.5 * z * z - math.log(prior.logf_sigma)
            - 0.5 * math.log(2.0 * math.pi) - s)


def birth_death_step(theta: torch.Tensor, mask: torch.Tensor,
                     loglik: torch.Tensor, loglik_fn: Callable,
                     prior: PriorSpec, cfg: TransDimConfig,
                     u_move: torch.Tensor, g_slot: torch.Tensor,
                     theta_star: torch.Tensor, u_acc: torch.Tensor):
    """One birth-or-death proposal per chain (reference:
    transdim.birth_death_step), births drawn from the prior:
    A_birth = LR Lambda / (n + 1), A_death = LR n / Lambda.

    theta (C, K, 3), mask (C, K), loglik (C,); loglik_fn batched.  Random
    inputs: u_move (C,) uniform (birth when < 1/2), g_slot (C, K) standard
    Gumbel (one draw serves the dead-slot and the alive-slot choice),
    theta_star (C, 3) a prior draw, u_acc (C,) uniform."""
    kmax = mask.shape[1]
    n = mask.sum(-1)
    do_birth = u_move < 0.5

    dead_slot = _gumbel_choice(g_slot, 1.0 - mask)
    theta_b = _set_slot(theta, dead_slot, theta_star)
    mask_b = _set_slot(mask, dead_slot, 1.0)
    loglik_b = loglik_fn(theta_b, mask_b)
    log_alpha_b = (loglik_b - loglik) + math.log(cfg.lam_count) - torch.log(n + 1.0)
    log_alpha_b = torch.where(n < kmax, log_alpha_b, -math.inf)

    alive_slot = _gumbel_choice(g_slot, mask)
    mask_d = _set_slot(mask, alive_slot, 0.0)
    loglik_d = loglik_fn(theta, mask_d)
    log_alpha_d = ((loglik_d - loglik) + torch.log(torch.clamp(n, min=1.0))
                   - math.log(cfg.lam_count))
    log_alpha_d = torch.where(n > 0, log_alpha_d, -math.inf)
    return _birth_death_select(theta, mask, loglik, do_birth, u_acc, theta_b,
                               mask_b, loglik_b, log_alpha_b, mask_d, loglik_d,
                               log_alpha_d)


def _birth_death_select(theta, mask, loglik, do_birth, u_acc, theta_b, mask_b,
                        loglik_b, log_alpha_b, mask_d, loglik_d, log_alpha_d):
    log_alpha = torch.where(do_birth, log_alpha_b, log_alpha_d)
    accept = torch.log(u_acc) < log_alpha
    birth = accept & do_birth
    theta_new = torch.where(birth[:, None, None], theta_b, theta)
    mask_new = torch.where(accept[:, None],
                           torch.where(do_birth[:, None], mask_b, mask_d), mask)
    loglik_new = torch.where(accept, torch.where(do_birth, loglik_b, loglik_d), loglik)
    move = torch.where(do_birth, 0, 1)
    return theta_new, mask_new, loglik_new, MoveInfo(accept, log_alpha, move)


def _residual_log_q(theta: torch.Tensor, mask: torch.Tensor, spec: SceneSpec,
                    image: torch.Tensor, floor: float) -> torch.Tensor:
    """Per-pixel log proposal density (pixel area 1) of a data-driven birth
    position, q ∝ max(D - lam(current model), 0) + floor: (..., H, W)."""
    x, y, f = constrain(theta, spec)
    lam = render_scene(x, y, f, mask, spec)
    logw = torch.log(torch.clamp(image - lam, min=0.0) + floor)
    return logw - torch.logsumexp(logw.flatten(-2), dim=-1)[..., None, None]


def _matched_filter_maps(theta: torch.Tensor, mask: torch.Tensor,
                         spec: SceneSpec, image: torch.Tensor,
                         fmin: float = 1.0):
    """Matched-filter maps of the current residual, each (..., H, W): the
    log-flux estimate ŝ of a star centred at each pixel and the debiased
    PSF-weighted centroids x̂, ŷ of the positive residual around it."""
    x, y, f = constrain(theta, spec)
    lam = render_scene(x, y, f, mask, spec)
    resid = image - lam
    rpos = torch.clamp(resid, min=0.0) + 1e-3
    cw = pixel_centers(spec.width, resid.dtype, resid.device)
    ch = pixel_centers(spec.height, resid.dtype, resid.device)
    gx = gaussian_profile_1d(cw, cw, spec.psf_sigma)  # (W, W)
    gy = gaussian_profile_1d(ch, ch, spec.psf_sigma)  # (H, H)
    num = gy @ resid @ gx.T
    mid = gaussian_profile_1d(ch[ch.shape[0] // 2][None], ch, spec.psf_sigma)[0]
    norm1d = torch.sum(mid * mid)
    den = gy @ rpos @ gx.T
    xhat = (gy @ rpos @ (gx * cw[None, :]).T) / den
    yhat = ((gy * ch[None, :]) @ rpos @ gx.T) / den
    # Gaussian-PSF debias: the raw centroid lands at the midpoint (c + s)/2
    # and the raw flux decays as exp(-|c - s|^2 / (4 sigma^2)); both invert.
    xhat = 2.0 * xhat - cw[None, :]
    yhat = 2.0 * yhat - ch[:, None]
    d2 = (xhat - cw[None, :]) ** 2 + (yhat - ch[:, None]) ** 2
    s4 = 4.0 * spec.psf_sigma * spec.psf_sigma
    shat = torch.log(torch.clamp(num / (norm1d * norm1d), min=fmin)) + d2 / s4
    return shat, xhat, yhat


def _normal_logpdf(x, mu, sigma):
    return -0.5 * (math.log(2.0 * math.pi * sigma * sigma)
                   + (x - mu) ** 2 / (sigma * sigma))


def _tn_logpdf(x, mu, sigma, lo, hi):
    """log density of N(mu, sigma^2) truncated to (lo, hi) at x."""
    z = (torch.special.ndtr((hi - mu) / sigma)
         - torch.special.ndtr((lo - mu) / sigma))
    return _normal_logpdf(x, mu, sigma) - torch.log(torch.clamp(z, min=1e-12))


def _tn_sample(u, mu, sigma, lo, hi):
    """N(mu, sigma^2) truncated to (lo, hi) by inverse CDF of uniforms u.

    The draw is clipped to [lo + 1e-4, hi - 1e-4] while _tn_logpdf scores the
    unclipped density.  That is the reference's behaviour, a detailed-balance
    error of order 1e-4 at the image edges (ROADMAP.md queue C), kept on
    purpose so both packages sample the same chain."""
    a = torch.special.ndtr((lo - mu) / sigma)
    b = torch.special.ndtr((hi - mu) / sigma)
    u = a + (b - a) * torch.clamp(u, 1e-6, 1.0 - 1e-6)
    return torch.clamp(mu + sigma * torch.special.ndtri(u), lo + 1e-4, hi - 1e-4)


def relocate_step(theta: torch.Tensor, mask: torch.Tensor,
                  loglik: torch.Tensor, prior: PriorSpec, spec: SceneSpec,
                  image: torch.Tensor, g_slot: torch.Tensor,
                  g_pix: torch.Tensor, u_sub: torch.Tensor, z: torch.Tensor,
                  u_acc: torch.Tensor, resid_floor: float = 1e-2,
                  flux_sigma: float | None = None, pos_sigma: float = 0.12):
    """One relocate attempt per chain (reference: transdim.relocate_step).

    Pick a uniform alive slot j, remove it virtually, and propose its
    replacement from the post-removal residual.  With ``flux_sigma`` None
    the position is a residual-weighted pixel plus a uniform sub-pixel
    offset and the flux comes from the prior:
        log α = Δloglik + log q(pix_j) - log q(pix*).
    With ``flux_sigma`` set (the data-driven mode the ChEES preset runs), the
    proposal is the residual-weighted mixture over pixels of truncated
    normals at the matched-filter centroids and a normal at the
    matched-filter log flux, scored as the full mixture both ways:
        log α = Δloglik + log q3(x_j, y_j, s_j) - log q3(x*, y*, s*)
                + log p(s*) - log p(s_j).

    theta (C, K, 3); mask (K,) or (C, K); loglik (C,).  Random inputs:
    g_slot (C, K) and g_pix (C, H*W) standard Gumbel; u_sub (C, 2) uniform
    (the sub-pixel offset, or the two truncated-normal draws); z (C,)
    standard normal; u_acc (C,) uniform.
    Returns (theta', mask, loglik', MoveInfo).
    """
    c = theta.shape[0]
    h, w = spec.height, spec.width
    rows = torch.arange(c, device=theta.device)
    mask_c = mask.expand(c, -1) if mask.ndim == 1 else mask
    n = mask_c.sum(-1)

    j = _gumbel_choice(g_slot, mask_c)                     # uniform alive slot
    mask_d = mask_c.clone()
    mask_d[rows, j] = 0.0
    logq = _residual_log_q(theta, mask_d, spec, image, resid_floor)  # (C, H, W)
    logq_flat = logq.reshape(c, -1)
    pix = torch.argmax(g_pix + logq_flat, dim=-1)           # categorical(logq)
    py = (pix // w).to(theta.dtype)
    px = (pix % w).to(theta.dtype)

    th_j = theta[rows, j]                                   # (C, 3)
    xj, yj, _ = constrain(th_j, spec)
    pxj = torch.clamp(torch.floor(xj), 0, w - 1).long()
    pyj = torch.clamp(torch.floor(yj), 0, h - 1).long()
    s_j = th_j[:, 2]

    if flux_sigma is None:  # flux from the prior: its density cancels
        u2 = u_sub * ((1.0 - 1e-4) - 1e-4) + 1e-4
        s_new = prior.logf_mean + prior.logf_sigma * z
        x_new, y_new = px + u2[:, 0], py + u2[:, 1]
        th_star = unconstrain(x_new, y_new, torch.exp(s_new), spec)
        theta_p = theta.clone()
        theta_p[rows, j] = th_star
        loglik_p = log_likelihood(theta_p, mask_c, spec, image)
        log_alpha = ((loglik_p - loglik) + logq_flat[rows, pyj * w + pxj]
                     - logq_flat[rows, pix])
    else:
        shat, xhat, yhat = _matched_filter_maps(theta, mask_d, spec, image)
        mu_x = xhat.reshape(c, -1)[rows, pix]
        mu_y = yhat.reshape(c, -1)[rows, pix]
        x_new = _tn_sample(u_sub[:, 0], mu_x, pos_sigma, 0.0, float(w))
        y_new = _tn_sample(u_sub[:, 1], mu_y, pos_sigma, 0.0, float(h))
        s_new = shat.reshape(c, -1)[rows, pix] + flux_sigma * z

        def q3_log(xq, yq, sq):
            # the full mixture density over all H*W components
            lx = _tn_logpdf(xq[:, None, None], xhat, pos_sigma, 0.0, float(w))
            ly = _tn_logpdf(yq[:, None, None], yhat, pos_sigma, 0.0, float(h))
            ls = _normal_logpdf(sq[:, None, None], shat, flux_sigma)
            return torch.logsumexp((logq + lx + ly + ls).reshape(c, -1), dim=-1)

        th_star = unconstrain(x_new, y_new, torch.exp(s_new), spec)
        theta_p = theta.clone()
        theta_p[rows, j] = th_star
        loglik_p = log_likelihood(theta_p, mask_c, spec, image)
        prior_ratio = -((s_new - prior.logf_mean) ** 2
                        - (s_j - prior.logf_mean) ** 2) / (
            2.0 * prior.logf_sigma * prior.logf_sigma)
        log_alpha = ((loglik_p - loglik)
                     + q3_log(xj, yj, s_j) - q3_log(x_new, y_new, s_new)
                     + prior_ratio)
    log_alpha = torch.where(n > 0, log_alpha, torch.full_like(log_alpha, -math.inf))
    accept = torch.log(u_acc) < log_alpha

    theta_new = torch.where(accept[:, None, None], theta_p, theta)
    loglik_new = torch.where(accept, loglik_p, loglik)
    info = MoveInfo(accept, log_alpha, torch.full_like(pix, 4))
    return theta_new, mask, loglik_new, info


def birth_death_step_residual(theta: torch.Tensor, mask: torch.Tensor,
                              loglik: torch.Tensor, loglik_fn: Callable,
                              prior: PriorSpec, spec: SceneSpec,
                              image: torch.Tensor, cfg: TransDimConfig,
                              u_move: torch.Tensor, g_slot: torch.Tensor,
                              g_pix: torch.Tensor, u_sub: torch.Tensor,
                              z: torch.Tensor, u_acc: torch.Tensor):
    """Birth/death with residual-driven birth positions (reference:
    transdim.birth_death_step_residual): a birth picks a pixel ∝ the
    current residual, a uniform sub-pixel offset and a prior flux, and its
    acceptance carries (1/WH) / q(pix); a death carries the reverse density
    q'(pos_j) of the post-death residual.

    Random inputs as birth_death_step, with g_pix (C, H*W) standard Gumbel,
    u_sub (C, 2) uniform (the sub-pixel offset) and z (C,) standard normal
    (the flux) in place of theta_star."""
    c, kmax = mask.shape
    h, w = spec.height, spec.width
    rows = torch.arange(c, device=theta.device)
    n = mask.sum(-1)
    do_birth = u_move < 0.5
    log_area = math.log(float(w * h))

    logq = _residual_log_q(theta, mask, spec, image, cfg.resid_floor).reshape(c, -1)
    pix = torch.argmax(g_pix + logq, dim=-1)                # categorical(logq)
    py = (pix // w).to(theta.dtype)
    px = (pix % w).to(theta.dtype)
    u2 = u_sub * ((1.0 - 1e-4) - 1e-4) + 1e-4
    s_new = prior.logf_mean + prior.logf_sigma * z
    th_star = unconstrain(px + u2[:, 0], py + u2[:, 1], torch.exp(s_new), spec)
    dead_slot = _gumbel_choice(g_slot, 1.0 - mask)
    theta_b = _set_slot(theta, dead_slot, th_star)
    mask_b = _set_slot(mask, dead_slot, 1.0)
    loglik_b = loglik_fn(theta_b, mask_b)
    log_alpha_b = ((loglik_b - loglik) + math.log(cfg.lam_count)
                   - torch.log(n + 1.0) - log_area - logq[rows, pix])
    log_alpha_b = torch.where(n < kmax, log_alpha_b, -math.inf)

    alive_slot = _gumbel_choice(g_slot, mask)
    mask_d = _set_slot(mask, alive_slot, 0.0)
    loglik_d = loglik_fn(theta, mask_d)
    logq_rev = _residual_log_q(theta, mask_d, spec, image, cfg.resid_floor)
    xj, yj, _ = constrain(theta[rows, alive_slot], spec)
    pxj = torch.clamp(torch.floor(xj), 0, w - 1).long()
    pyj = torch.clamp(torch.floor(yj), 0, h - 1).long()
    log_alpha_d = ((loglik_d - loglik) + torch.log(torch.clamp(n, min=1.0))
                   - math.log(cfg.lam_count) + log_area + logq_rev[rows, pyj, pxj])
    log_alpha_d = torch.where(n > 0, log_alpha_d, -math.inf)
    return _birth_death_select(theta, mask, loglik, do_birth, u_acc, theta_b,
                               mask_b, loglik_b, log_alpha_b, mask_d, loglik_d,
                               log_alpha_d)


def split_merge_step(theta: torch.Tensor, mask: torch.Tensor,
                     loglik: torch.Tensor, loglik_fn: Callable,
                     prior: PriorSpec, spec: SceneSpec, cfg: TransDimConfig,
                     u_move: torch.Tensor, g_j: torch.Tensor, g_d: torch.Tensor,
                     u_u: torch.Tensor, z_delta: torch.Tensor,
                     u_acc: torch.Tensor):
    """One flux-conserving, centroid-preserving split-or-merge proposal per
    chain (reference: transdim.split_merge_step).  Split of parent j into
    j and a dead slot d: f1 = u f, f2 = (1 - u) f, pos1 = pos + (1 - u)
    delta, pos2 = pos - u delta; merge of an ordered alive pair (a, b) into
    a is its exact reciprocal.  Densities are evaluated in constrained
    coordinates, the children clipped 1e-3 inside the image and fluxes
    floored at cfg.fmin as the reference does.

    Random inputs: u_move (C,) uniform (split when < 1/2); g_j, g_d (C, K)
    standard Gumbel (the parent / surviving slot, and the child / dying
    slot); u_u (C,) uniform (the split fraction), z_delta (C, 2) standard
    normal (the displacement in units of split_sigma), u_acc (C,)."""
    c, kmax = mask.shape
    rows = torch.arange(c, device=theta.device)
    n = mask.sum(-1)
    do_split = u_move < 0.5
    sig = cfg.split_sigma
    log_q_norm = -math.log(2.0 * math.pi * sig * sig)
    log_area = math.log(spec.width * spec.height)
    wd, ht = float(spec.width), float(spec.height)

    x, y, f = constrain(theta, spec)
    f = torch.clamp(f, min=cfg.fmin)

    # ---- split
    j = _gumbel_choice(g_j, mask)
    d = _gumbel_choice(g_d, 1.0 - mask)
    u = u_u * ((1.0 - 1e-4) - 1e-4) + 1e-4
    delta = sig * z_delta
    xj, yj, fj = x[rows, j], y[rows, j], f[rows, j]
    x1, y1 = xj + (1.0 - u) * delta[:, 0], yj + (1.0 - u) * delta[:, 1]
    x2, y2 = xj - u * delta[:, 0], yj - u * delta[:, 1]
    f1, f2 = u * fj, (1.0 - u) * fj
    in_bounds = ((x1 > 0.0) & (x1 < wd) & (x2 > 0.0) & (x2 < wd)
                 & (y1 > 0.0) & (y1 < ht) & (y2 > 0.0) & (y2 < ht)
                 & (f1 > cfg.fmin) & (f2 > cfg.fmin))
    th1 = unconstrain(torch.clamp(x1, 1e-3, wd - 1e-3), torch.clamp(y1, 1e-3, ht - 1e-3),
                      torch.clamp(f1, min=cfg.fmin), spec)
    th2 = unconstrain(torch.clamp(x2, 1e-3, wd - 1e-3), torch.clamp(y2, 1e-3, ht - 1e-3),
                      torch.clamp(f2, min=cfg.fmin), spec)
    theta_s = _set_slot(_set_slot(theta, j, th1), d, th2)
    mask_s = _set_slot(mask, d, 1.0)
    loglik_s = loglik_fn(theta_s, mask_s)
    log_prior_ratio_s = (-log_area + _log_flux_prior_constrained(f1, prior)
                         + _log_flux_prior_constrained(f2, prior)
                         - _log_flux_prior_constrained(fj, prior))
    log_q_delta = log_q_norm - 0.5 * torch.sum((delta / sig) ** 2, dim=-1)
    log_alpha_s = ((loglik_s - loglik) + math.log(cfg.lam_count) - torch.log(n + 1.0)
                   + log_prior_ratio_s + torch.log(fj) - log_q_delta)
    log_alpha_s = torch.where((n >= 1) & (n < kmax) & in_bounds, log_alpha_s, -math.inf)

    # ---- merge
    a = _gumbel_choice(g_j, mask)
    b = _gumbel_choice(g_d, mask * (1.0 - torch.nn.functional.one_hot(a, kmax).to(mask.dtype)))
    fa, fb = f[rows, a], f[rows, b]
    fm = fa + fb
    xm = (fa * x[rows, a] + fb * x[rows, b]) / fm
    ym = (fa * y[rows, a] + fb * y[rows, b]) / fm
    um = fa / fm
    delta_m = torch.stack([x[rows, a] - x[rows, b], y[rows, a] - y[rows, b]], dim=-1)
    thm = unconstrain(torch.clamp(xm, 1e-3, wd - 1e-3), torch.clamp(ym, 1e-3, ht - 1e-3),
                      torch.clamp(fm, min=cfg.fmin), spec)
    theta_m = _set_slot(theta, a, thm)
    mask_m = _set_slot(mask, b, 0.0)
    loglik_m = loglik_fn(theta_m, mask_m)
    log_prior_ratio_m = (log_area + _log_flux_prior_constrained(fm, prior)
                         - _log_flux_prior_constrained(fa, prior)
                         - _log_flux_prior_constrained(fb, prior))
    log_q_delta_m = log_q_norm - 0.5 * torch.sum((delta_m / sig) ** 2, dim=-1)
    log_alpha_m = ((loglik_m - loglik) - math.log(cfg.lam_count)
                   + torch.log(torch.clamp(n, min=1.0)) + log_prior_ratio_m
                   - torch.log(torch.clamp(fm, min=cfg.fmin)) + log_q_delta_m)
    # the reverse split's draw u_m must lie inside the forward split's support
    um_ok = (um > 1e-4) & (um < 1.0 - 1e-4)
    log_alpha_m = torch.where((n >= 2) & um_ok, log_alpha_m, -math.inf)

    log_alpha = torch.where(do_split, log_alpha_s, log_alpha_m)
    accept = torch.log(u_acc) < log_alpha
    acc3, split3 = accept[:, None, None], do_split[:, None, None]
    theta_new = torch.where(acc3, torch.where(split3, theta_s, theta_m), theta)
    mask_new = torch.where(accept[:, None],
                           torch.where(do_split[:, None], mask_s, mask_m), mask)
    loglik_new = torch.where(accept, torch.where(do_split, loglik_s, loglik_m), loglik)
    move = torch.where(do_split, 2, 3)
    return theta_new, mask_new, loglik_new, MoveInfo(accept, log_alpha, move)


class SweepDraws(NamedTuple):
    """The random inputs of one transdim_sweep for every chain."""

    u_sel: torch.Tensor   # (C,) uniform: birth/death when < p_birth_death
    bd: tuple             # birth_death_step's (u_move, g_slot, theta_star, u_acc)
                          # or the residual move's (u_move, g_slot, g_pix, u_sub, z, u_acc)
    sm: tuple             # split_merge_step's (u_move, g_j, g_d, u_u, z_delta, u_acc)


def transdim_sweep(theta: torch.Tensor, mask: torch.Tensor,
                   loglik: torch.Tensor, loglik_fn: Callable,
                   prior: PriorSpec, spec: SceneSpec, cfg: TransDimConfig,
                   draws: SweepDraws, image: torch.Tensor | None = None):
    """One trans-dimensional move per chain: birth/death with probability
    p_birth_death, else split/merge (both are computed; each chain keeps
    one).  image: needed when cfg.birth_proposal == "residual"."""
    if cfg.birth_proposal == "residual":
        if image is None:
            raise ValueError("residual birth proposal needs the image")
        bd = birth_death_step_residual(theta, mask, loglik, loglik_fn, prior,
                                       spec, image, cfg, *draws.bd)
    elif cfg.birth_proposal == "prior":
        bd = birth_death_step(theta, mask, loglik, loglik_fn, prior, cfg, *draws.bd)
    else:
        raise ValueError(f"unknown birth_proposal {cfg.birth_proposal!r}")
    sm = split_merge_step(theta, mask, loglik, loglik_fn, prior, spec, cfg, *draws.sm)
    pick = draws.u_sel < cfg.p_birth_death

    def sel(a, b):
        return torch.where(pick.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    th, m, ll = sel(bd[0], sm[0]), sel(bd[1], sm[1]), sel(bd[2], sm[2])
    return th, m, ll, MoveInfo(*(sel(a, b) for a, b in zip(bd[3], sm[3])))


def poisson_sweep_reference(theta: torch.Tensor, mask: torch.Tensor, tll: torch.Tensor,
                            beta, prior: PriorSpec, spec: SceneSpec, image: torch.Tensor,
                            cfg: TransDimConfig, draws: SweepDraws):
    """The plain version of :func:`poisson_sweep`: :func:`transdim_sweep`
    at the tempered likelihood beta * log_likelihood."""
    def tempered(th, m):
        return beta * log_likelihood(th, m, spec, image)

    return transdim_sweep(theta, mask, tll, tempered, prior, spec, cfg, draws, image)


def poisson_sweep(theta: torch.Tensor, mask: torch.Tensor, tll: torch.Tensor, beta,
                  prior: PriorSpec, spec: SceneSpec, image: torch.Tensor,
                  cfg: TransDimConfig, draws: SweepDraws, fused: bool = True):
    """One sweep at the tempered Poisson likelihood: returns what
    :func:`transdim_sweep` returns, (theta, mask, tll, MoveInfo), for tll
    = beta * log L and either birth proposal.  theta (C, K, 3), mask (C, K),
    tll (C,); beta a float or a 0-d tensor.  On CUDA tensors with ``fused``
    the kernel (one launch, or a raise); on CPU tensors, or with
    fused=False, the plain version.  Counts the chains that ran on the
    kernel in ``transdim.kernel_moves`` (0 on the plain version)."""
    if fused and theta.device.type != "cpu":
        from .fused_transdim_sweep import fused_poisson_sweep

        out = fused_poisson_sweep(theta, mask, tll, beta, prior, spec, image, cfg, draws)
        metrics.count("transdim.kernel_moves", theta.shape[0])
        return out
    metrics.count("transdim.kernel_moves", 0)
    return poisson_sweep_reference(theta, mask, tll, beta, prior, spec, image, cfg, draws)


def draw_sweep(generator: torch.Generator, c: int, kmax: int, spec: SceneSpec,
               prior: PriorSpec, cfg: TransDimConfig, device) -> SweepDraws:
    """A sweep's random inputs for c chains, drawn in a fixed order: the
    selector, then birth/death's, then split/merge's."""
    tiny = torch.finfo(torch.float32).tiny

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def gumbel(*shape):
        return -torch.log(-torch.log(rand(*shape).clamp_(min=tiny)))

    u_sel = rand(c)
    if cfg.birth_proposal == "residual":
        bd = (rand(c), gumbel(c, kmax), gumbel(c, spec.height * spec.width),
              rand(c, 2), torch.randn((c,), generator=generator, device=device), rand(c))
    else:
        bd = (rand(c), gumbel(c, kmax),
              sample_prior(generator, c, prior, device), rand(c))
    sm = (rand(c), gumbel(c, kmax), gumbel(c, kmax), rand(c),
          torch.randn((c, 2), generator=generator, device=device), rand(c))
    return SweepDraws(u_sel, bd, sm)
