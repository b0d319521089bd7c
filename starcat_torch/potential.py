"""Poisson potential, priors and analytic gradients (port of
starcat/potential.py).

    U(theta) = -[ log p(D | theta) + log p(theta) ]
    log p(D | lam) = sum_p [ D_p log lam_p - lam_p ]

theta is (..., K, 3) unconstrained (ux, uy, s) with x = W sigmoid(ux),
y = H sigmoid(uy), f = exp(s); positions are uniform over the image and
s ~ N(logf_mean, logf_sigma^2).  Every function batches over the leading
(chain) axes; ``mask`` is (K,) shared or (..., K) per chain, and dead slots
contribute exactly zero to lam, U and grad U.

The likelihood gradient is the reference's closed form: two contractions of
the Poisson residual R = D/lam - 1 against the separable profiles.  The
tempered potential U_beta = -(beta log L + log prior) serves the
trans-dimensional head's beta path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .scene import SceneSpec, gaussian_profile_1d, pixel_centers

# TF32 keeps ~10 mantissa bits.  A low-precision contraction of the residual
# against the profiles cost a gradient error of 2.2 on the reference
# (BASELINE.md:36-40) against the 0.017 bar of float64, so every float32
# contraction here must run in full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class PriorSpec(NamedTuple):
    """Prior hyperparameters: log f ~ N(logf_mean, logf_sigma^2)."""

    logf_mean: float = 2.0
    logf_sigma: float = 1.0


def constrain(theta: torch.Tensor, spec: SceneSpec):
    """Unconstrained (..., K, 3) -> physical (x, y, flux), each (..., K)."""
    x = spec.width * torch.sigmoid(theta[..., 0])
    y = spec.height * torch.sigmoid(theta[..., 1])
    f = torch.exp(theta[..., 2])
    return x, y, f


def unconstrain(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                spec: SceneSpec) -> torch.Tensor:
    """Physical -> unconstrained (..., K, 3); inverse of :func:`constrain`."""
    ux = torch.logit(x / spec.width)
    uy = torch.logit(y / spec.height)
    return torch.stack([ux, uy, torch.log(flux)], dim=-1)


def log_prior(theta: torch.Tensor, mask: torch.Tensor,
              prior: PriorSpec) -> torch.Tensor:
    """Masked log prior density of the unconstrained params, (...,)."""
    u_pos = theta[..., :2]
    lp_pos = -(F.softplus(u_pos) + F.softplus(-u_pos)).sum(-1)
    z = (theta[..., 2] - prior.logf_mean) / prior.logf_sigma
    lp_flux = (-0.5 * z * z - math.log(prior.logf_sigma)
               - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(mask * (lp_pos + lp_flux), dim=-1)


def log_prior_grad(theta: torch.Tensor, mask: torch.Tensor,
                   prior: PriorSpec) -> torch.Tensor:
    """Analytic d log_prior / d theta, (..., K, 3)."""
    g_pos = 1.0 - 2.0 * torch.sigmoid(theta[..., :2])
    g_flux = -(theta[..., 2] - prior.logf_mean) / (prior.logf_sigma ** 2)
    g = torch.cat([g_pos, g_flux[..., None]], dim=-1)
    return g * mask[..., None]


def sample_prior(generator: torch.Generator, k: int, prior: PriorSpec,
                 device, dtype=torch.float32) -> torch.Tensor:
    """Draw k stars' unconstrained params from the prior, (k, 3)."""
    u = torch.rand((k, 2), generator=generator, device=device, dtype=dtype)
    upos = torch.logit(u.clamp(1e-6, 1.0 - 1e-6))
    s = prior.logf_mean + prior.logf_sigma * torch.randn(
        (k,), generator=generator, device=device, dtype=dtype)
    return torch.cat([upos, s[:, None]], dim=-1)


def _profiles_and_lam(theta: torch.Tensor, mask: torch.Tensor,
                      spec: SceneSpec):
    x, y, f = constrain(theta, spec)
    cx = pixel_centers(spec.width, theta.dtype, theta.device)
    cy = pixel_centers(spec.height, theta.dtype, theta.device)
    gx = gaussian_profile_1d(x, cx, spec.psf_sigma)  # (..., K, W)
    gy = gaussian_profile_1d(y, cy, spec.psf_sigma)  # (..., K, H)
    w = f * mask
    lam = spec.background + torch.einsum("...kh,...kw->...hw",
                                         gy * w[..., None], gx)
    return x, y, f, gx, gy, w, lam, cx, cy


def log_likelihood(theta: torch.Tensor, mask: torch.Tensor, spec: SceneSpec,
                   image: torch.Tensor) -> torch.Tensor:
    """Poisson log-likelihood sum_p [D_p log lam_p - lam_p], (...,)."""
    lam = _profiles_and_lam(theta, mask, spec)[6]
    return torch.sum(image * torch.log(lam) - lam, dim=(-2, -1))


def make_potential(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec):
    """U(theta, mask) = -(log L + log prior), batched over chains."""

    def potential(theta: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return -(log_likelihood(theta, mask, spec, image)
                 + log_prior(theta, mask, prior))

    return potential


def make_tempered_potential_and_grad(spec: SceneSpec, image: torch.Tensor,
                                     prior: PriorSpec):
    """(U_beta, dU_beta/dtheta) of the likelihood-tempered target

        U_beta(theta) = -[ beta * log L(theta) + log prior(theta) ]

    as fn(theta, mask, beta); beta is a float or a 0-d tensor."""
    pg = make_potential_and_grad(spec, image, prior)

    def tempered(theta: torch.Tensor, mask: torch.Tensor, beta):
        u_full, g_full = pg(theta, mask)
        lp = log_prior(theta, mask, prior)
        glp = log_prior_grad(theta, mask, prior)
        ll = -u_full - lp
        gll = -g_full - glp
        return -(beta * ll + lp), -(beta * gll + glp)

    return tempered


def make_potential_and_grad(spec: SceneSpec, image: torch.Tensor,
                            prior: PriorSpec):
    """Analytic (U (...,), dU/dtheta (..., K, 3)) in closed form."""
    sig2 = spec.psf_sigma * spec.psf_sigma

    def potential_and_grad(theta: torch.Tensor, mask: torch.Tensor):
        x, y, f, gx, gy, w, lam, cx, cy = _profiles_and_lam(theta, mask, spec)
        loglik = torch.sum(image * torch.log(lam) - lam, dim=(-2, -1))
        lp = log_prior(theta, mask, prior)
        resid = image / lam - 1.0                                   # (..., H, W)

        rgx = torch.einsum("...hw,...kw->...hk", resid, gx)         # (..., H, K)
        d_flux = torch.einsum("...kh,...hk->...k", gy, rgx)         # gy_k^T R gx_k
        dgx = gx * (cx - x[..., None]) / sig2                       # (..., K, W)
        dgy = gy * (cy - y[..., None]) / sig2                       # (..., K, H)
        rdgx = torch.einsum("...hw,...kw->...hk", resid, dgx)
        d_x = torch.einsum("...kh,...hk->...k", gy, rdgx) * w
        d_y = torch.einsum("...kh,...hk->...k", dgy, rgx) * w

        # chain rule to the unconstrained coordinates
        sx = torch.sigmoid(theta[..., 0])
        sy = torch.sigmoid(theta[..., 1])
        gl_ux = d_x * spec.width * sx * (1.0 - sx)
        gl_uy = d_y * spec.height * sy * (1.0 - sy)
        gl_s = d_flux * mask * f              # df/ds = f; flux grad carries mask
        grad_loglik = torch.stack([gl_ux, gl_uy, gl_s], dim=-1) * mask[..., None]
        grad_logpost = grad_loglik + log_prior_grad(theta, mask, prior)
        return -(loglik + lp), -grad_logpost

    return potential_and_grad
