"""The trans-dimensional moves on a fixed-capacity masked catalog
(birth/death with prior or residual-driven births, flux-conserving
split/merge) and the dimension-preserving relocate move, one proposal a
chain, each a pure function of its random inputs.  The target over slots
is p(n) / C(K_max, n) prod p(theta_i) L(D | theta), p(n) a Poisson
truncated to [0, K_max]; the acceptance ratios are those of the
reference project (starcat's transdim module derives them)."""
from __future__ import annotations

import math

import torch

from .model import Prior, Scene, centers, constrain, hi, lo, log_likelihood, profile, render, unconstrain


def gumbel_choice(g, weights):
    return torch.argmax(torch.where(weights > 0, g, torch.full_like(g, -math.inf)), dim=-1)


def set_slot(x, slot, value):
    hot = torch.nn.functional.one_hot(slot, x.shape[1]).to(torch.bool)
    if x.ndim == 3:
        return torch.where(hot[..., None], value[:, None, :], x)
    return torch.where(hot, torch.as_tensor(value, dtype=x.dtype, device=x.device), x)


def _flux_logpdf(f, pr: Prior):
    s = torch.log(f)
    z = (s - pr.logf_mean) / pr.logf_sigma
    return -0.5 * z * z - math.log(pr.logf_sigma) - 0.5 * math.log(2.0 * math.pi) - s


def residual_log_q(theta, mask, sc: Scene, image, floor):
    lam = render(*constrain(theta, sc), mask, sc)
    logw = torch.log(torch.clamp(image - lam, min=0.0) + floor)
    return logw - torch.logsumexp(logw.flatten(-2), dim=-1)[..., None, None]


def matched_filter(theta, mask, sc: Scene, image, fmin=1.0):
    lam = render(*constrain(theta, sc), mask, sc)
    resid = image - lam
    rpos = torch.clamp(resid, min=0.0) + 1e-3
    cw, ch = centers(sc.width, resid), centers(sc.height, resid)
    gx, gy = profile(cw, cw, sc.psf_sigma), profile(ch, ch, sc.psf_sigma)
    num = gy @ resid @ gx.T
    mid = profile(ch[ch.shape[0] // 2][None], ch, sc.psf_sigma)[0]
    norm1d = torch.sum(mid * mid)
    den = gy @ rpos @ gx.T
    xhat = 2.0 * ((gy @ rpos @ (gx * cw[None, :]).T) / den) - cw[None, :]
    yhat = 2.0 * (((gy * ch[None, :]) @ rpos @ gx.T) / den) - ch[:, None]
    d2 = (xhat - cw[None, :]) ** 2 + (yhat - ch[:, None]) ** 2
    shat = torch.log(torch.clamp(num / (norm1d * norm1d), min=fmin)) + d2 / (4.0 * sc.psf_sigma ** 2)
    return shat, xhat, yhat


def _normal_logpdf(x, mu, sigma):
    return -0.5 * (math.log(2.0 * math.pi * sigma * sigma) + (x - mu) ** 2 / (sigma * sigma))


def _ndtr(x):
    return lo(torch.special.ndtr(hi(x)), x)


def _tn_logpdf(x, mu, sigma, a, b):
    z = _ndtr((b - mu) / sigma) - _ndtr((a - mu) / sigma)
    return _normal_logpdf(x, mu, sigma) - torch.log(torch.clamp(z, min=1e-12))


def _tn_sample(u, mu, sigma, a, b):
    pa, pb = _ndtr((a - mu) / sigma), _ndtr((b - mu) / sigma)
    u = pa + (pb - pa) * torch.clamp(u, 1e-6, 1.0 - 1e-6)
    return torch.clamp(mu + sigma * lo(torch.special.ndtri(hi(u)), u), a + 1e-4, b - 1e-4)


def relocate(theta, mask, loglik, pr: Prior, sc: Scene, image, g_slot, g_pix, u_sub, z,
             u_acc, resid_floor, flux_sigma, pos_sigma):
    """One relocate attempt a chain in the data-driven mode: a uniform alive
    slot j is removed virtually and re-proposed from the residual-weighted
    mixture of truncated normals at the matched-filter centroids and a
    normal at the matched-filter log flux, scored as the full mixture both
    ways.  mask (K,) or (C, K).  Returns (theta', accepted)."""
    c = theta.shape[0]
    h, w = sc.height, sc.width
    rows = torch.arange(c, device=theta.device)
    mask_c = mask.expand(c, -1) if mask.ndim == 1 else mask
    n = mask_c.sum(-1)
    j = gumbel_choice(g_slot, mask_c)
    mask_d = mask_c.clone()
    mask_d[rows, j] = 0.0
    logq = residual_log_q(theta, mask_d, sc, image, resid_floor)
    pix = torch.argmax(g_pix + logq.reshape(c, -1), dim=-1)
    xj, yj, _ = constrain(theta[rows, j], sc)
    s_j = theta[rows, j, 2]
    shat, xhat, yhat = matched_filter(theta, mask_d, sc, image)
    x_new = _tn_sample(u_sub[:, 0], xhat.reshape(c, -1)[rows, pix], pos_sigma, 0.0, float(w))
    y_new = _tn_sample(u_sub[:, 1], yhat.reshape(c, -1)[rows, pix], pos_sigma, 0.0, float(h))
    s_new = shat.reshape(c, -1)[rows, pix] + flux_sigma * z

    def q3_log(xq, yq, sq):
        lx = _tn_logpdf(xq[:, None, None], xhat, pos_sigma, 0.0, float(w))
        ly = _tn_logpdf(yq[:, None, None], yhat, pos_sigma, 0.0, float(h))
        ls = _normal_logpdf(sq[:, None, None], shat, flux_sigma)
        return torch.logsumexp((logq + lx + ly + ls).reshape(c, -1), dim=-1)

    theta_p = theta.clone()
    theta_p[rows, j] = unconstrain(x_new, y_new, torch.exp(s_new), sc)
    loglik_p = log_likelihood(theta_p, mask_c, sc, image)
    prior_ratio = -((s_new - pr.logf_mean) ** 2 - (s_j - pr.logf_mean) ** 2) / (
        2.0 * pr.logf_sigma ** 2)
    log_alpha = ((loglik_p - loglik) + q3_log(xj, yj, s_j) - q3_log(x_new, y_new, s_new)
                 + prior_ratio)
    log_alpha = torch.where(n > 0, log_alpha, torch.full_like(log_alpha, -math.inf))
    accept = torch.log(u_acc) < log_alpha
    return torch.where(accept[:, None, None], theta_p, theta), accept


def _bd_select(theta, mask, loglik, do_birth, u_acc, theta_b, mask_b, ll_b, la_b, mask_d,
               ll_d, la_d):
    la = torch.where(do_birth, la_b, la_d)
    accept = torch.log(u_acc) < la
    theta_new = torch.where((accept & do_birth)[:, None, None], theta_b, theta)
    mask_new = torch.where(accept[:, None], torch.where(do_birth[:, None], mask_b, mask_d), mask)
    ll_new = torch.where(accept, torch.where(do_birth, ll_b, ll_d), loglik)
    return theta_new, mask_new, ll_new


def birth_death_prior(theta, mask, loglik, llf, pr, lam_count, u_move, g_slot, theta_star,
                      u_acc):
    kmax = mask.shape[1]
    n = mask.sum(-1)
    do_birth = u_move < 0.5
    theta_b = set_slot(theta, gumbel_choice(g_slot, 1.0 - mask), theta_star)
    mask_b = set_slot(mask, gumbel_choice(g_slot, 1.0 - mask), 1.0)
    ll_b = llf(theta_b, mask_b)
    la_b = torch.where(n < kmax, (ll_b - loglik) + math.log(lam_count) - torch.log(n + 1.0),
                       -math.inf)
    mask_d = set_slot(mask, gumbel_choice(g_slot, mask), 0.0)
    ll_d = llf(theta, mask_d)
    la_d = torch.where(n > 0, (ll_d - loglik) + torch.log(torch.clamp(n, min=1.0))
                       - math.log(lam_count), -math.inf)
    return _bd_select(theta, mask, loglik, do_birth, u_acc, theta_b, mask_b, ll_b, la_b,
                      mask_d, ll_d, la_d)


def birth_death_residual(theta, mask, loglik, llf, pr, sc: Scene, image, lam_count,
                         resid_floor, u_move, g_slot, g_pix, u_sub, z, u_acc):
    c, kmax = mask.shape
    h, w = sc.height, sc.width
    rows = torch.arange(c, device=theta.device)
    n = mask.sum(-1)
    do_birth = u_move < 0.5
    log_area = math.log(float(w * h))
    logq = residual_log_q(theta, mask, sc, image, resid_floor).reshape(c, -1)
    pix = torch.argmax(g_pix + logq, dim=-1)
    py, px = (pix // w).to(theta.dtype), (pix % w).to(theta.dtype)
    u2 = u_sub * ((1.0 - 1e-4) - 1e-4) + 1e-4
    s_new = pr.logf_mean + pr.logf_sigma * z
    th_star = unconstrain(px + u2[:, 0], py + u2[:, 1], torch.exp(s_new), sc)
    dead = gumbel_choice(g_slot, 1.0 - mask)
    theta_b, mask_b = set_slot(theta, dead, th_star), set_slot(mask, dead, 1.0)
    ll_b = llf(theta_b, mask_b)
    la_b = ((ll_b - loglik) + math.log(lam_count) - torch.log(n + 1.0) - log_area
            - logq[rows, pix])
    la_b = torch.where(n < kmax, la_b, -math.inf)
    alive = gumbel_choice(g_slot, mask)
    mask_d = set_slot(mask, alive, 0.0)
    ll_d = llf(theta, mask_d)
    logq_rev = residual_log_q(theta, mask_d, sc, image, resid_floor)
    xj, yj, _ = constrain(theta[rows, alive], sc)
    pxj = torch.clamp(torch.floor(xj), 0, w - 1).long()
    pyj = torch.clamp(torch.floor(yj), 0, h - 1).long()
    la_d = ((ll_d - loglik) + torch.log(torch.clamp(n, min=1.0)) - math.log(lam_count)
            + log_area + logq_rev[rows, pyj, pxj])
    la_d = torch.where(n > 0, la_d, -math.inf)
    return _bd_select(theta, mask, loglik, do_birth, u_acc, theta_b, mask_b, ll_b, la_b,
                      mask_d, ll_d, la_d)


def split_merge(theta, mask, loglik, llf, pr, sc: Scene, lam_count, split_sigma, fmin,
                u_move, g_j, g_d, u_u, z_delta, u_acc):
    c, kmax = mask.shape
    rows = torch.arange(c, device=theta.device)
    n = mask.sum(-1)
    do_split = u_move < 0.5
    sig = split_sigma
    log_q_norm = -math.log(2.0 * math.pi * sig * sig)
    log_area = math.log(sc.width * sc.height)
    wd, ht = float(sc.width), float(sc.height)
    x, y, f = constrain(theta, sc)
    f = torch.clamp(f, min=fmin)

    j, d = gumbel_choice(g_j, mask), gumbel_choice(g_d, 1.0 - mask)
    u = u_u * ((1.0 - 1e-4) - 1e-4) + 1e-4
    delta = sig * z_delta
    xj, yj, fj = x[rows, j], y[rows, j], f[rows, j]
    x1, y1 = xj + (1.0 - u) * delta[:, 0], yj + (1.0 - u) * delta[:, 1]
    x2, y2 = xj - u * delta[:, 0], yj - u * delta[:, 1]
    f1, f2 = u * fj, (1.0 - u) * fj
    ok = ((x1 > 0.0) & (x1 < wd) & (x2 > 0.0) & (x2 < wd) & (y1 > 0.0) & (y1 < ht)
          & (y2 > 0.0) & (y2 < ht) & (f1 > fmin) & (f2 > fmin))
    th1 = unconstrain(torch.clamp(x1, 1e-3, wd - 1e-3), torch.clamp(y1, 1e-3, ht - 1e-3),
                      torch.clamp(f1, min=fmin), sc)
    th2 = unconstrain(torch.clamp(x2, 1e-3, wd - 1e-3), torch.clamp(y2, 1e-3, ht - 1e-3),
                      torch.clamp(f2, min=fmin), sc)
    theta_s = set_slot(set_slot(theta, j, th1), d, th2)
    mask_s = set_slot(mask, d, 1.0)
    ll_s = llf(theta_s, mask_s)
    lpr_s = (-log_area + _flux_logpdf(f1, pr) + _flux_logpdf(f2, pr) - _flux_logpdf(fj, pr))
    lqd = log_q_norm - 0.5 * torch.sum((delta / sig) ** 2, dim=-1)
    la_s = ((ll_s - loglik) + math.log(lam_count) - torch.log(n + 1.0) + lpr_s
            + torch.log(fj) - lqd)
    la_s = torch.where((n >= 1) & (n < kmax) & ok, la_s, -math.inf)

    a = gumbel_choice(g_j, mask)
    b = gumbel_choice(g_d, mask * (1.0 - torch.nn.functional.one_hot(a, kmax).to(mask.dtype)))
    fa, fb = f[rows, a], f[rows, b]
    fm = fa + fb
    xm = (fa * x[rows, a] + fb * x[rows, b]) / fm
    ym = (fa * y[rows, a] + fb * y[rows, b]) / fm
    um = fa / fm
    dm = torch.stack([x[rows, a] - x[rows, b], y[rows, a] - y[rows, b]], dim=-1)
    thm = unconstrain(torch.clamp(xm, 1e-3, wd - 1e-3), torch.clamp(ym, 1e-3, ht - 1e-3),
                      torch.clamp(fm, min=fmin), sc)
    theta_m = set_slot(theta, a, thm)
    mask_m = set_slot(mask, b, 0.0)
    ll_m = llf(theta_m, mask_m)
    lpr_m = (log_area + _flux_logpdf(fm, pr) - _flux_logpdf(fa, pr) - _flux_logpdf(fb, pr))
    lqm = log_q_norm - 0.5 * torch.sum((dm / sig) ** 2, dim=-1)
    la_m = ((ll_m - loglik) - math.log(lam_count) + torch.log(torch.clamp(n, min=1.0)) + lpr_m
            - torch.log(torch.clamp(fm, min=fmin)) + lqm)
    la_m = torch.where((n >= 2) & (um > 1e-4) & (um < 1.0 - 1e-4), la_m, -math.inf)

    la = torch.where(do_split, la_s, la_m)
    accept = torch.log(u_acc) < la
    acc3, sp3 = accept[:, None, None], do_split[:, None, None]
    theta_new = torch.where(acc3, torch.where(sp3, theta_s, theta_m), theta)
    mask_new = torch.where(accept[:, None], torch.where(do_split[:, None], mask_s, mask_m), mask)
    ll_new = torch.where(accept, torch.where(do_split, ll_s, ll_m), loglik)
    return theta_new, mask_new, ll_new


def sweep(theta, mask, tll, llf, pr, sc: Scene, image, td: dict, draws):
    """One trans-dimensional move a chain: birth/death with probability
    td["p_birth_death"], else split/merge (both computed, one kept).
    draws = (u_sel, bd, sm) as the benchmark drew them."""
    u_sel, bd, sm = draws
    if td["birth_proposal"] == "residual":
        b = birth_death_residual(theta, mask, tll, llf, pr, sc, image, td["lam_count"],
                                 td["resid_floor"], *bd)
    else:
        b = birth_death_prior(theta, mask, tll, llf, pr, td["lam_count"], *bd)
    s = split_merge(theta, mask, tll, llf, pr, sc, td["lam_count"], td["split_sigma"],
                    td["fmin"], *sm)
    pick = u_sel < td["p_birth_death"]

    def sel(a, c):
        return torch.where(pick.reshape((-1,) + (1,) * (a.ndim - 1)), a, c)

    return sel(b[0], s[0]), sel(b[1], s[1]), sel(b[2], s[2])
