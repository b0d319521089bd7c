"""The operations the algorithm needs, counted from shapes and live stars,
and the card's peak: frozen copies of chip_smoke.py's counters (every
multiply-add two operations; the per-star work and the profiles'
exponentials left out, so a bound is if anything low), and the counts of
the work around the trajectories (the relocate move, the trans-d sweeps)
from the plain reference's algorithm.  Nothing here reads a kernel, so the
counts stay right when a later change fuses or removes one."""
from __future__ import annotations

PEAK_FP32 = 67e12   # H100 SXM, float32 outside the tensor cores (NVIDIA's data sheet)


def leapfrog_ops(c, k, h, w, n_steps, grad_in):
    """B1/B2/B5: the render (one FMA) and the contraction (two FMAs) per
    star and pixel of every gradient evaluation."""
    evals = n_steps + (0 if grad_in and n_steps > 0 else 1)
    return c * evals * 6.0 * k * h * w


def rhmc_diag_ops(c, k, h, w, n_steps, fpi):
    """B3/B4: per star and pixel, a build 22, a momentum sweep 8, a
    position sweep 6; a step is fpi momentum and fpi position sweeps, a
    build and the final momentum half step, the trajectory one build more.
    For B4, which skips dead stars, c = 1 and k the live stars of all
    chains."""
    return c * k * h * w * (22.0 + n_steps * (30.0 + 14.0 * fpi))


def rhmc_full_ops(c, k, h, w, n_steps, fpi):
    """B6: per star pair and pixel, a rebuild's pair contractions (6 FMAs)
    and q field (9 operations), a position sweep's Fisher pairs (i <= j, 4
    FMAs); per star and pixel, a momentum sweep's phi field and psi
    contractions (24 operations) and the renders."""
    pairs = k * k * h * w * (21.0 + n_steps * (4.0 * fpi + 21.0))
    single = k * h * w * (26.0 + n_steps * (26.0 * fpi + 50.0))
    return c * (pairs + single)


def rhmc_full_ops_live(counts_sum, counts_sq_sum, h, w, n_steps, fpi):
    """rhmc_full_ops summed over particles of k_i live stars, from the sum
    of the k_i and of their squares."""
    pairs = counts_sq_sum * h * w * (21.0 + n_steps * (4.0 * fpi + 21.0))
    single = counts_sum * h * w * (26.0 + n_steps * (26.0 * fpi + 50.0))
    return pairs + single


def render_ops(k, h, w):
    """One render of k stars (lambda = sum_k f_k gy_k gx_k^T): an FMA a star
    and pixel."""
    return 2.0 * k * h * w


def relocate_ops(c, k, h, w):
    """One relocate attempt a chain: four renders (the likelihood, the
    post-removal residual, the matched filter's residual, the proposal's
    likelihood) and the matched filter's four separable filters
    gy R gx^T, H^2 W + H W^2 FMAs each."""
    return c * (4.0 * render_ops(k, h, w) + 8.0 * (h * h * w + h * w * w))


def sweep_renders(birth_proposal: str) -> int:
    """Renders of one trans-d sweep a chain: birth, death, split and merge
    likelihoods, and with residual births the two residual proposals."""
    return 6 if birth_proposal == "residual" else 4
