"""starcat_torch: the PyTorch/CUDA port of starcat for one NVIDIA H100.

The JAX package `starcat/` is the reference; every module here has its
counterpart there under the same name.  This package imports torch and
numpy only — never jax, never starcat — so it runs on a machine that has
no JAX installed.  Its one hand-written kernel, the fused leapfrog
trajectory (`fused_leapfrog.py`, `csrc/fused_leapfrog.cu`), replaces the
two Pallas trajectory kernels of `starcat/pallas_kernels.py`.
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
