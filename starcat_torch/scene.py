"""Scene / PSF model (port of starcat/scene.py).

    lam[h, w] = background + sum_k alive_k * flux_k * g(w + 0.5 - x_k) g(h + 0.5 - y_k)

with a separable, unit-integral Gaussian PSF g of width ``psf_sigma``.
Rendering is a contraction of per-star 1-D profiles, (K, H) x (K, W) ->
(H, W), batched over any leading (chain) axes.  Conventions follow the
reference: x runs along the width axis (columns), y along the height axis
(rows), and pixel (h, w) is centred at (w + 0.5, h + 0.5).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SceneSpec(NamedTuple):
    """Static description of the image and PSF."""

    height: int
    width: int
    psf_sigma: float
    background: float


def pixel_centers(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Coordinates of pixel centres along one axis: 0.5, 1.5, ..., n - 0.5."""
    return torch.arange(n, dtype=dtype, device=device) + 0.5


def gaussian_profile_1d(centers: torch.Tensor, coords: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """Normalised 1-D Gaussian profiles: centers (..., K), coords (N,) ->
    (..., K, N), row k being g(coords - centers[k])."""
    z = (coords - centers[..., None]) / sigma
    norm = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
    return torch.exp(-0.5 * z * z) * norm


def gaussian_profile_1d_grad(centers: torch.Tensor, coords: torch.Tensor,
                             sigma: float) -> torch.Tensor:
    """d/d centre of :func:`gaussian_profile_1d`, (..., K, N)."""
    g = gaussian_profile_1d(centers, coords, sigma)
    return g * (coords - centers[..., None]) / (sigma * sigma)


def render_profiles(x: torch.Tensor, y: torch.Tensor, spec: SceneSpec):
    """Per-star separable profiles (gy, gx): (..., K, H) and (..., K, W)."""
    gx = gaussian_profile_1d(
        x, pixel_centers(spec.width, x.dtype, x.device), spec.psf_sigma)
    gy = gaussian_profile_1d(
        y, pixel_centers(spec.height, y.dtype, y.device), spec.psf_sigma)
    return gy, gx


def render_scene(x: torch.Tensor, y: torch.Tensor, flux: torch.Tensor,
                 mask: torch.Tensor, spec: SceneSpec) -> torch.Tensor:
    """Expected-counts image lam, (..., H, W).  Dead slots (mask == 0)
    contribute exactly zero."""
    gy, gx = render_profiles(x, y, spec)
    w = flux * mask
    img = torch.einsum("...kh,...kw->...hw", gy * w[..., None], gx)
    return spec.background + img


def make_mock_image(generator: torch.Generator, x: torch.Tensor,
                    y: torch.Tensor, flux: torch.Tensor, spec: SceneSpec,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Draw a Poisson mock observation of the scene (float counts image)."""
    if mask is None:
        mask = torch.ones_like(flux)
    lam = render_scene(x, y, flux, mask, spec)
    return torch.poisson(lam, generator=generator)
