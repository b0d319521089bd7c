"""Fisher / Riemannian metric (port of starcat/metric.py).

The metric of the Riemannian heads is the Poisson Fisher information in the
unconstrained parameters, tempered by beta, plus the prior's information
and a jitter:

    G(theta) = beta * J^T diag(1/lam) J + diag(info) + jitter I

with J[p, a] = d lam_p / d theta_a.  Dead catalog slots get exact identity
rows and columns (their J rows are zero and their prior term is masked), so
G stays positive definite and the flow leaves them where they are.
``make_metric_fn`` builds the dense (3K, 3K) matrix, in the reference's
star-major order a = 3 k + t; ``make_diag_metric_fn`` its diagonal
(alive slots: beta F_a + info_a; dead slots: 1; plus jitter), kept in the
catalog layout (..., K, 3).  Every function batches over the leading
(chain) axes; ``mask`` is (K,) shared or (..., K) per chain.
"""
from __future__ import annotations

import torch

from .potential import PriorSpec, constrain
from .scene import SceneSpec, gaussian_profile_1d, gaussian_profile_1d_grad, pixel_centers


def prior_information(theta: torch.Tensor, mask: torch.Tensor,
                      prior: PriorSpec) -> torch.Tensor:
    """Negative Hessian of the log prior, diagonal, (..., K, 3)."""
    s_pos = torch.sigmoid(theta[..., :2])
    info_pos = 2.0 * s_pos * (1.0 - s_pos)       # -d2/du2 of the logit-uniform
    info_flux = torch.full_like(theta[..., 2], 1.0 / prior.logf_sigma ** 2)
    info = torch.cat([info_pos, info_flux[..., None]], dim=-1)
    return info * mask[..., None]


def scene_jacobian(theta: torch.Tensor, mask: torch.Tensor, spec: SceneSpec):
    """(lam (..., H, W), J (..., K, 3, H, W)): the expected image and its
    derivative in the unconstrained parameters."""
    x, y, f = constrain(theta, spec)
    cx = pixel_centers(spec.width, theta.dtype, theta.device)
    cy = pixel_centers(spec.height, theta.dtype, theta.device)
    gx = gaussian_profile_1d(x, cx, spec.psf_sigma)          # (..., K, W)
    gy = gaussian_profile_1d(y, cy, spec.psf_sigma)          # (..., K, H)
    dgx = gaussian_profile_1d_grad(x, cx, spec.psf_sigma)
    dgy = gaussian_profile_1d_grad(y, cy, spec.psf_sigma)
    w = f * mask
    lam = spec.background + torch.einsum("...kh,...kw->...hw", gy * w[..., None], gx)
    sx = torch.sigmoid(theta[..., 0])
    sy = torch.sigmoid(theta[..., 1])
    dx_dux = spec.width * sx * (1.0 - sx)                    # (..., K)
    dy_duy = spec.height * sy * (1.0 - sy)
    j_ux = (w * dx_dux)[..., None, None] * gy[..., :, None] * dgx[..., None, :]
    j_uy = (w * dy_duy)[..., None, None] * dgy[..., :, None] * gx[..., None, :]
    j_s = w[..., None, None] * gy[..., :, None] * gx[..., None, :]
    return lam, torch.stack([j_ux, j_uy, j_s], dim=-3)


def make_metric_fn(spec: SceneSpec, prior: PriorSpec, jitter: float = 1e-3):
    """metric(theta (..., K, 3), mask, beta=1.0) -> G (..., 3K, 3K), the
    dense metric in star-major order; ``beta`` tempers the Fisher term."""

    def metric(theta: torch.Tensor, mask: torch.Tensor, beta=1.0) -> torch.Tensor:
        d = 3 * theta.shape[-2]
        lam, j = scene_jacobian(theta, mask, spec)
        jf = j.reshape(*j.shape[:-4], d, -1)                 # (..., 3K, P)
        fisher = torch.einsum("...ap,...bp->...ab",
                              jf / lam.reshape(*lam.shape[:-2], 1, -1), jf)
        info = prior_information(theta, mask, prior).reshape(*theta.shape[:-2], d)
        mask_p = torch.repeat_interleave(mask, 3, dim=-1)    # per-parameter mask
        g = beta * fisher + torch.diag_embed(info)
        # exact identity rows and columns for dead slots
        g = g * (mask_p[..., :, None] * mask_p[..., None, :]) + torch.diag_embed(1.0 - mask_p)
        return g + jitter * torch.eye(d, dtype=theta.dtype, device=theta.device)

    return metric


def make_diag_metric_fn(spec: SceneSpec, prior: PriorSpec, jitter: float = 1e-3):
    """diag_metric(theta (..., K, 3), mask, beta=1.0) -> g (..., K, 3).

    ``beta`` tempers the likelihood's Fisher term (a float or a 0-d
    tensor).  Each entry is the separable bilinear form
    coef_k^2 * (row_k^2 @ (1/lam) @ col_k^2) of the 1-D PSF profiles, so
    the (K, 3, H, W) Jacobian is never formed."""

    def diag_metric(theta: torch.Tensor, mask: torch.Tensor, beta=1.0) -> torch.Tensor:
        x, y, f = constrain(theta, spec)
        cx = pixel_centers(spec.width, theta.dtype, theta.device)
        cy = pixel_centers(spec.height, theta.dtype, theta.device)
        gx = gaussian_profile_1d(x, cx, spec.psf_sigma)          # (..., K, W)
        gy = gaussian_profile_1d(y, cy, spec.psf_sigma)          # (..., K, H)
        dgx = gaussian_profile_1d_grad(x, cx, spec.psf_sigma)
        dgy = gaussian_profile_1d_grad(y, cy, spec.psf_sigma)
        w = f * mask
        lam = spec.background + torch.einsum("...kh,...kw->...hw",
                                             gy * w[..., None], gx)
        r = 1.0 / lam                                            # (..., H, W)
        p1 = torch.einsum("...kh,...hw->...kw", gy * gy, r)
        p2 = torch.einsum("...kh,...hw->...kw", dgy * dgy, r)

        sx = torch.sigmoid(theta[..., 0])
        sy = torch.sigmoid(theta[..., 1])
        dx_dux = spec.width * sx * (1.0 - sx)
        dy_duy = spec.height * sy * (1.0 - sy)

        f_ux = (w * dx_dux) ** 2 * torch.sum(p1 * dgx * dgx, dim=-1)
        f_uy = (w * dy_duy) ** 2 * torch.sum(p2 * gx * gx, dim=-1)
        f_s = w ** 2 * torch.sum(p1 * gx * gx, dim=-1)
        fisher = torch.stack([f_ux, f_uy, f_s], dim=-1)          # (..., K, 3)

        g = beta * fisher + prior_information(theta, mask, prior)
        m3 = mask[..., None]
        g = g * m3 + (1.0 - m3)                                  # dead slots exactly 1
        return g + jitter

    return diag_metric
