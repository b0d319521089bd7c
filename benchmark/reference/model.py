"""The scene model: PSF profiles, the rendered image, the Poisson
log-likelihood and the prior, the potential's closed-form gradient, and
the Fisher metric (dense and diagonal), all batched over leading chain
axes.  theta is (..., K, 3) unconstrained (ux, uy, s) with x = W
sigmoid(ux), y = H sigmoid(uy), f = exp(s); mask is (K,) or (..., K)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

LOW = (torch.bfloat16, torch.float16)


class Scene(NamedTuple):
    height: int
    width: int
    psf_sigma: float
    background: float


class Prior(NamedTuple):
    logf_mean: float
    logf_sigma: float


def hi(x: torch.Tensor) -> torch.Tensor:
    """x in float32 where its dtype is below it (for the few operations
    that have no bfloat16 kernel); the result is rounded back by lo()."""
    return x.float() if x.dtype in LOW else x


def lo(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.dtype)


def centers(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device) + 0.5


def profile(c: torch.Tensor, coords: torch.Tensor, sigma: float) -> torch.Tensor:
    """Unit-integral 1-D Gaussian profiles: c (..., K), coords (N,) -> (..., K, N)."""
    z = (coords - c[..., None]) / sigma
    return torch.exp(-0.5 * z * z) * (1.0 / (math.sqrt(2.0 * math.pi) * sigma))


def profile_grad(c, coords, sigma):
    return profile(c, coords, sigma) * (coords - c[..., None]) / (sigma * sigma)


def constrain(theta, sc: Scene):
    return (sc.width * torch.sigmoid(theta[..., 0]), sc.height * torch.sigmoid(theta[..., 1]),
            torch.exp(theta[..., 2]))


def unconstrain(x, y, f, sc: Scene):
    return torch.stack([lo(torch.logit(hi(x / sc.width)), x), lo(torch.logit(hi(y / sc.height)), y),
                        torch.log(f)], dim=-1)


def render(x, y, f, mask, sc: Scene):
    gx = profile(x, centers(sc.width, x), sc.psf_sigma)
    gy = profile(y, centers(sc.height, y), sc.psf_sigma)
    return sc.background + torch.einsum("...kh,...kw->...hw", gy * (f * mask)[..., None], gx)


def log_likelihood(theta, mask, sc: Scene, image):
    lam = render(*constrain(theta, sc), mask, sc)
    return torch.sum(image * torch.log(lam) - lam, dim=(-2, -1))


def log_prior(theta, mask, pr: Prior):
    u = theta[..., :2]
    lp_pos = -(F.softplus(u) + F.softplus(-u)).sum(-1)
    z = (theta[..., 2] - pr.logf_mean) / pr.logf_sigma
    lp_f = -0.5 * z * z - math.log(pr.logf_sigma) - 0.5 * math.log(2.0 * math.pi)
    return torch.sum(mask * (lp_pos + lp_f), dim=-1)


def log_prior_grad(theta, mask, pr: Prior):
    g_pos = 1.0 - 2.0 * torch.sigmoid(theta[..., :2])
    g_f = -(theta[..., 2] - pr.logf_mean) / (pr.logf_sigma ** 2)
    return torch.cat([g_pos, g_f[..., None]], dim=-1) * mask[..., None]


def potential_and_grad(theta, mask, sc: Scene, pr: Prior, image):
    """(U, dU/dtheta) with U = -(log L + log prior), the gradient in closed
    form: contractions of the residual D / lam - 1 with the profiles."""
    x, y, f = constrain(theta, sc)
    cx, cy = centers(sc.width, theta), centers(sc.height, theta)
    gx, gy = profile(x, cx, sc.psf_sigma), profile(y, cy, sc.psf_sigma)
    w = f * mask
    lam = sc.background + torch.einsum("...kh,...kw->...hw", gy * w[..., None], gx)
    loglik = torch.sum(image * torch.log(lam) - lam, dim=(-2, -1))
    resid = image / lam - 1.0
    sig2 = sc.psf_sigma ** 2
    rgx = torch.einsum("...hw,...kw->...hk", resid, gx)
    d_f = torch.einsum("...kh,...hk->...k", gy, rgx)
    rdgx = torch.einsum("...hw,...kw->...hk", resid, gx * (cx - x[..., None]) / sig2)
    d_x = torch.einsum("...kh,...hk->...k", gy, rdgx) * w
    d_y = torch.einsum("...kh,...hk->...k", gy * (cy - y[..., None]) / sig2, rgx) * w
    sx, sy = torch.sigmoid(theta[..., 0]), torch.sigmoid(theta[..., 1])
    g = torch.stack([d_x * sc.width * sx * (1 - sx), d_y * sc.height * sy * (1 - sy),
                     d_f * mask * f], dim=-1) * mask[..., None]
    return -(loglik + log_prior(theta, mask, pr)), -(g + log_prior_grad(theta, mask, pr))


def prior_information(theta, mask, pr: Prior):
    s = torch.sigmoid(theta[..., :2])
    info_f = torch.full_like(theta[..., 2], 1.0 / pr.logf_sigma ** 2)
    return torch.cat([2.0 * s * (1.0 - s), info_f[..., None]], dim=-1) * mask[..., None]


def _jacobian_terms(theta, mask, sc: Scene):
    x, y, f = constrain(theta, sc)
    cx, cy = centers(sc.width, theta), centers(sc.height, theta)
    gx, gy = profile(x, cx, sc.psf_sigma), profile(y, cy, sc.psf_sigma)
    dgx, dgy = profile_grad(x, cx, sc.psf_sigma), profile_grad(y, cy, sc.psf_sigma)
    w = f * mask
    lam = sc.background + torch.einsum("...kh,...kw->...hw", gy * w[..., None], gx)
    sx, sy = torch.sigmoid(theta[..., 0]), torch.sigmoid(theta[..., 1])
    return gx, gy, dgx, dgy, w, lam, sc.width * sx * (1 - sx), sc.height * sy * (1 - sy)


def diag_metric(theta, mask, sc: Scene, pr: Prior, beta, jitter=1e-3):
    """The diagonal of beta J^T diag(1/lam) J + prior information + jitter,
    (..., K, 3); dead slots exactly 1 + jitter."""
    gx, gy, dgx, dgy, w, lam, dx, dy = _jacobian_terms(theta, mask, sc)
    r = 1.0 / lam
    p1 = torch.einsum("...kh,...hw->...kw", gy * gy, r)
    p2 = torch.einsum("...kh,...hw->...kw", dgy * dgy, r)
    fisher = torch.stack([(w * dx) ** 2 * torch.sum(p1 * dgx * dgx, dim=-1),
                          (w * dy) ** 2 * torch.sum(p2 * gx * gx, dim=-1),
                          w ** 2 * torch.sum(p1 * gx * gx, dim=-1)], dim=-1)
    g = beta * fisher + prior_information(theta, mask, pr)
    m3 = mask[..., None]
    return g * m3 + (1.0 - m3) + jitter


def dense_metric(theta, mask, sc: Scene, pr: Prior, beta, jitter=1e-3):
    """The dense metric (..., 3K, 3K) in star-major order 3 k + t; dead
    slots get identity rows and columns."""
    gx, gy, dgx, dgy, w, lam, dx, dy = _jacobian_terms(theta, mask, sc)
    d = 3 * theta.shape[-2]
    j = torch.stack([(w * dx)[..., None, None] * gy[..., :, None] * dgx[..., None, :],
                     (w * dy)[..., None, None] * dgy[..., :, None] * gx[..., None, :],
                     w[..., None, None] * gy[..., :, None] * gx[..., None, :]], dim=-3)
    jf = j.reshape(*j.shape[:-4], d, -1)
    fisher = torch.einsum("...ap,...bp->...ab", jf / lam.reshape(*lam.shape[:-2], 1, -1), jf)
    info = prior_information(theta, mask, pr).reshape(*theta.shape[:-2], d)
    mp = torch.repeat_interleave(mask, 3, dim=-1)
    g = beta * fisher + torch.diag_embed(info)
    g = g * (mp[..., :, None] * mp[..., None, :]) + torch.diag_embed(1.0 - mp)
    return g + jitter * torch.eye(d, dtype=theta.dtype, device=theta.device)
