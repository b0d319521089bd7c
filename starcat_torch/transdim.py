"""The relocate move (port of the part of starcat/transdim.py that the
ChEES preset runs on every draw): a dimension-preserving configuration hop
that fuses a death and a residual-driven birth into one exact MH step.

Batched over chains.  The move is a pure function of its random inputs
(Gumbel noise for the slot and pixel choices, uniforms, a normal), so tests
can feed it the reference's own draws; ``chees.make_chees_relocate`` draws
them from the run's generator.  Birth/death and split/merge come with the
trans-dimensional heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .potential import PriorSpec, constrain, log_likelihood, unconstrain
from .scene import SceneSpec, gaussian_profile_1d, pixel_centers, render_scene


class MoveInfo(NamedTuple):
    accepted: torch.Tensor
    log_alpha: torch.Tensor


def _gumbel_choice(gumbel: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Uniform choice among slots where weights > 0, given standard Gumbel
    noise of the weights' shape: (..., K) -> (...,) indices."""
    scores = torch.where(weights > 0, gumbel, torch.full_like(gumbel, -math.inf))
    return torch.argmax(scores, dim=-1)


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
    info = MoveInfo(accept, log_alpha)
    return theta_new, mask, loglik_new, info
