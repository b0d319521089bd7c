"""The two heads' steps as the benchmark follows them: one ChEES
iteration (a jittered leapfrog trajectory at the adapted step size, mass
and length, the Metropolis accept step, then one relocate attempt) and one
likelihood-tempered SMC step (adaptive tempering and log Z, systematic
resampling, trans-dimensional sweeps, Riemannian HMC mutations on the
diagonal or dense Fisher metric), each from a given state and the draws
the benchmark made for it."""
from __future__ import annotations

import math

import torch

from . import moves
from .model import (
    Prior,
    Scene,
    dense_metric,
    diag_metric,
    hi,
    lo,
    log_likelihood,
    log_prior,
    potential_and_grad,
)


def leapfrog(grad_fn, theta, p, grad, eps, n_steps, inv_mass):
    """n_steps of velocity Verlet with a diagonal inverse mass, reusing the
    entry gradient; returns (theta, p, U, grad) at the end.  n_steps is an
    int, or a tensor (R,) of each row's count, at least 1: a row whose
    count is done stays where it ended."""
    per_row = torch.is_tensor(n_steps)
    u = None
    for s in range(int(n_steps.max()) if per_row else n_steps):
        p_n = p - 0.5 * eps * grad
        theta_n = theta + eps * inv_mass * p_n
        u_n, grad_n = grad_fn(theta_n)
        p_n = p_n - 0.5 * eps * grad_n
        if per_row and s > 0:
            on = s < n_steps
            on3 = on[:, None, None]
            theta, p = torch.where(on3, theta_n, theta), torch.where(on3, p_n, p)
            u, grad = torch.where(on, u_n, u), torch.where(on3, grad_n, grad)
        else:
            theta, p, u, grad = theta_n, p_n, u_n, grad_n
    return theta, p, u, grad


def halton2(i: int) -> float:
    """ChEES's trajectory jitter of iteration i: the base-2 radical inverse
    of i (16 bits)."""
    return sum(((i >> b) & 1) * 0.5 ** (b + 1.0) for b in range(16)) + 2.0 ** -17


def chees_steps(u_jit: float, traj: float, eps: float, max_leapfrog: int) -> int:
    """The iteration's leapfrog count, clip(ceil(u T / eps), 1, max), in
    the float32 arithmetic of the adapted (float32) eps and T."""
    t = torch.tensor(u_jit, dtype=torch.float32) * torch.tensor(traj, dtype=torch.float32)
    n = torch.ceil(t / torch.tensor(eps, dtype=torch.float32))
    return int(torch.clamp(n, 1, max_leapfrog))


def chees_iteration(theta, sc: Scene, pr: Prior, image, eps, inv_mass, n_steps,
                    div_threshold, p0, u_acc, reloc_draws, reloc: dict):
    """One ChEES iteration of every chain from theta (C, K, 3), all slots
    alive, n_steps leapfrog steps (an int, or each chain's); returns (theta after the accept step and the relocate move,
    accept_prob, the trajectory's end point)."""
    mask = torch.ones(theta.shape[1], dtype=theta.dtype, device=theta.device)

    def grad_fn(th):
        return potential_and_grad(th, mask, sc, pr, image)

    u0, g0 = grad_fn(theta)
    p = p0 / torch.sqrt(inv_mass)
    h0 = u0 + 0.5 * torch.sum(inv_mass * p * p, dim=(-2, -1))
    th_n, p_n, u_n, _ = leapfrog(grad_fn, theta, p, g0, eps, n_steps, inv_mass)
    e_err = u_n + 0.5 * torch.sum(inv_mass * p_n * p_n, dim=(-2, -1)) - h0
    e_err = torch.where(torch.isfinite(e_err), e_err, torch.full_like(e_err, math.inf))
    accept_prob = torch.exp(torch.clamp(-e_err, max=0.0))
    theta = torch.where((u_acc < accept_prob)[:, None, None], th_n, theta)
    ll = log_likelihood(theta, mask, sc, image)
    theta, _ = moves.relocate(theta, mask, ll, pr, sc, image, *reloc_draws,
                              reloc["resid_floor"], reloc["flux_sigma"], reloc["pos_sigma"])
    return theta, accept_prob, th_n


def _fp_delta(x_new, x_old):
    return torch.amax(torch.abs(x_new - x_old), dim=(-2, -1)) / (
        1.0 + torch.amax(torch.abs(x_new), dim=(-2, -1)))


def riemannian_leapfrog(dhdt, dhdp, theta, p, eps, n_steps, fpi):
    """The generalised leapfrog with fpi Picard sweeps per implicit
    equation; returns (theta, p, the largest last-sweep relative delta)."""
    eps = eps.reshape(-1, 1, 1)
    zero = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)

    def fp(f, x0):
        x, delta = x0, zero
        for _ in range(fpi):
            x_new = f(x)
            x, delta = x_new, _fp_delta(x_new, x)
        return x, delta

    resid = zero
    for _ in range(n_steps):
        p_b, th_b = p, theta
        p_half, d1 = fp(lambda ph: p_b - 0.5 * eps * dhdt(th_b, ph), p_b)
        v0 = dhdp(th_b, p_half)
        theta, d2 = fp(lambda th: th_b + 0.5 * eps * (v0 + dhdp(th, p_half)), th_b + eps * v0)
        p = p_half - 0.5 * eps * dhdt(theta, p_half)
        resid = torch.maximum(resid, torch.maximum(d1, d2))
    return theta, p, resid


def _cholesky_or_nan(g):
    chol, info = torch.linalg.cholesky_ex(hi(g))
    chol = torch.where((info != 0)[..., None, None], torch.full_like(chol, math.nan), chol)
    return lo(chol, g)


def rhmc_trajectory(theta, xi, eps, mask, beta, sc: Scene, pr: Prior, image, metric: str,
                    n_steps, fpi, jitter=1e-3):
    """The tempered Riemannian trajectory: H = U_beta + 1/2 log det G +
    1/2 p^T G^-1 p, U_beta = -(beta log L + log prior), dH/dtheta by
    autograd.  Returns (theta', h0, h1, solver residual)."""
    def potential(th):
        return -(beta * log_likelihood(th, mask, sc, image) + log_prior(th, mask, pr))

    if metric == "diag":
        def g_of(th):
            return diag_metric(th, mask, sc, pr, beta, jitter)

        def ham(th, p):
            g = g_of(th)
            return (potential(th) + 0.5 * torch.sum(torch.log(g), dim=(-2, -1))
                    + 0.5 * torch.sum(p * p / g, dim=(-2, -1)))

        def dhdp(th, p):
            return p / g_of(th)

        p0 = torch.sqrt(g_of(theta)) * xi * mask[..., None]
    else:
        def solve(th, p):
            chol = _cholesky_or_nan(dense_metric(th, mask, sc, pr, beta, jitter))
            pf = p.reshape(p.shape[0], -1, 1)
            return chol, pf, lo(torch.cholesky_solve(hi(pf), hi(chol)), pf)

        def ham(th, p):
            chol, pf, gp = solve(th, p)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
            return potential(th) + 0.5 * logdet + 0.5 * torch.sum(pf * gp, dim=(-2, -1))

        def dhdp(th, p):
            return solve(th, p)[2].reshape(p.shape)

        k = theta.shape[-2]
        perm = torch.arange(3 * k, device=theta.device).reshape(k, 3).T.reshape(-1)
        g = dense_metric(theta, mask, sc, pr, beta, jitter)[..., perm, :][..., :, perm]
        xi_tm = xi.transpose(-1, -2).reshape(xi.shape[0], -1)
        p_tm = (_cholesky_or_nan(g) @ xi_tm[..., None])[..., 0]
        p0 = p_tm.reshape(xi.shape[0], 3, k).transpose(-1, -2) * mask[..., None]

    def dhdt(th, p):
        with torch.enable_grad():
            t = th.detach().requires_grad_(True)
            (gr,) = torch.autograd.grad(ham(t, p.detach()).sum(), t)
        return gr

    th1, p1, resid = riemannian_leapfrog(dhdt, dhdp, theta, p0, eps, n_steps, fpi)
    return th1, ham(theta, p0), ham(th1, p1), resid


def rhmc_transition(theta, mask, beta, eps, noise, u_jit, u_acc, sc, pr, image, mut: dict):
    eps_c = eps * (0.8 + 0.4 * u_jit)
    th_n, h0, h1, resid = rhmc_trajectory(theta, noise, eps_c, mask, beta, sc, pr, image,
                                          mut["metric"], mut["n_leapfrog"],
                                          mut["fixed_point_iters"], mut["jitter"])
    e_err = h1 - h0
    e_err = torch.where(torch.isfinite(e_err), e_err, torch.full_like(e_err, math.inf))
    accept_prob = torch.exp(torch.clamp(-e_err, max=0.0))
    accept_prob = torch.where(~(resid < mut["solver_tol"]), torch.zeros_like(accept_prob),
                              accept_prob)
    return torch.where((u_acc < accept_prob)[:, None, None], th_n, theta)


def ess_from_logw(logw):
    return torch.exp(2.0 * torch.logsumexp(logw, -1) - torch.logsumexp(2.0 * logw, -1))


def next_dbeta(beta, loglik, target_ess, n_bisect=26):
    full = 1.0 - beta
    lo_, hi_ = torch.zeros_like(full), full
    for _ in range(n_bisect):
        mid = 0.5 * (lo_ + hi_)
        ok = ess_from_logw(mid * loglik) >= target_ess
        lo_, hi_ = torch.where(ok, mid, lo_), torch.where(ok, hi_, mid)
    return torch.where(ess_from_logw(full * loglik) >= target_ess, full, lo_)


def systematic_resample(logw, u0):
    n = logw.shape[0]
    w = torch.softmax(logw, dim=-1)
    cum = torch.cumsum(w, dim=-1)
    pos = u0 / n + torch.arange(n, dtype=w.dtype, device=w.device) / n
    return torch.clamp(torch.searchsorted(cum, pos.reshape(-1)), 0, n - 1)


def tempering(loglik, beta, log_z, u_res, ess_target_frac, db=None):
    """Adaptive tempering, log Z and systematic resampling of the whole
    population from its untempered log-likelihoods: (db, log Z', the parent
    of each row).  db: the step to take (the program's, to follow it), or
    None to choose it by the bisection."""
    p = loglik.shape[0]
    if db is None:
        db = next_dbeta(beta, loglik, ess_target_frac * p)
    logw = db * loglik
    log_z = log_z + torch.logsumexp(logw, 0) - math.log(float(p))
    return db, log_z, systematic_resample(logw, u_res)


def tempering_gap(db, loglik, beta, ess_target_frac) -> float:
    """How far a step db misses the tempering rule on these likelihoods:
    the full step to beta = 1 needs ESS(full) >= target (the gap is the
    shortfall); a shorter step is the bisection's root, where the ESS
    share equals the target (the gap is the distance)."""
    p = loglik.shape[0]
    full = 1.0 - beta
    if float(db) >= float(full):
        return max(0.0, ess_target_frac - float(ess_from_logw(full * loglik)) / p)
    return abs(float(ess_from_logw(db * loglik)) / p - ess_target_frac)


def smc_follow(theta, mask, loglik, beta, eps, sweeps, mutation, sc: Scene, pr: Prior,
               image, td: dict, mut: dict):
    """The sweeps and the mutations of the rows given (already resampled):
    theta (R, K, 3), mask (R, K), their untempered log-likelihoods, and the
    draws' rows.  Returns (theta, mask)."""
    def llf(th, m):
        return beta * log_likelihood(th, m, sc, image)

    tll = beta * loglik
    for sd in sweeps:
        theta, mask, tll = moves.sweep(theta, mask, tll, llf, pr, sc, image, td, sd)
    for noise, u_jit, u_acc in mutation:
        theta = rhmc_transition(theta, mask, beta, eps, noise, u_jit, u_acc, sc, pr, image, mut)
    return theta, mask
