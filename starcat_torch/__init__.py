"""starcat_torch: the PyTorch/CUDA port of starcat for one NVIDIA H100.

The JAX package `starcat/` is the reference; every module here has its
counterpart there under the same name.  This package imports torch and
numpy only — never jax, never starcat — so it runs on a machine that has
no JAX installed.  Its hand-written CUDA kernels, built by nvcc at first
use (`build.py`), replace the six Pallas kernels of `starcat/`: the fused
leapfrog trajectory (`fused_leapfrog.py`, `csrc/fused_leapfrog.cu`) the
two of `starcat/pallas_kernels.py` (B1, B2), and on crowded fields
(`fused_leapfrog_crowded.py`) the one of `starcat/pallas_mxu.py` (B5); the
diagonal-Fisher Riemannian trajectory (`fused_rhmc_diag.py`) the one of
`starcat/pallas_rhmc_diag.py` that small scenes run (B3), and on crowded
fields (`fused_rhmc_diag_crowded.py`) its MXU variant (B4); the full-Fisher
Riemannian trajectory (`fused_rhmc.py`) the one of `starcat/pallas_rhmc.py`
(B6), and on crowded fields (`fused_rhmc_crowded.py`, B6c) the XLA route the
JAX package takes beyond that kernel's gate.  `dispatch.py` picks the kernel
of each of the three pairs by the scene's shape.
"""
from .potential import (
    PriorSpec,
    constrain,
    log_likelihood,
    log_prior,
    log_prior_grad,
    make_potential,
    make_potential_and_grad,
    sample_prior,
    unconstrain,
)
from .scene import SceneSpec, make_mock_image, render_scene

__all__ = [
    "PriorSpec",
    "SceneSpec",
    "constrain",
    "log_likelihood",
    "log_prior",
    "log_prior_grad",
    "make_mock_image",
    "make_potential",
    "make_potential_and_grad",
    "render_scene",
    "sample_prior",
    "unconstrain",
]
