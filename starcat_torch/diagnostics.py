"""Convergence diagnostics (port of starcat/diagnostics.py, NumPy only).

ESS via FFT autocorrelation (Geyer initial-positive-sequence truncation),
split-R̂, between-group R̂, and the posterior-moment z-score comparison
against another sampler with Monte-Carlo standard errors.  Every function
takes chains-shaped NumPy arrays (n_chains, n_samples).
"""
from __future__ import annotations

import numpy as np


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance of each row of x (chains, n) via FFT, biased norm."""
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n].real
    return acov / n


def ess(chains: np.ndarray) -> float:
    """Effective sample size of a scalar quantity.

    Args:
      chains: (n_chains, n_samples) array of one scalar parameter.

    Uses the rank-normalized-free classic estimator: mean autocovariance
    across chains + between-chain variance (Stan's combined rho_hat), with
    Geyer's initial monotone positive sequence.
    """
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    m, n = chains.shape
    if n < 4:
        return float(m * n)
    acov = _autocov_fft(chains)  # (m, n)
    chain_var = acov[:, 0] * n / (n - 1)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1) / n
    if m > 1:
        var_plus += chains.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus  # (n,)
    # Geyer: sum consecutive pairs while positive & monotone decreasing.
    t = 1
    tau = 1.0  # = 1 + 2 * sum(rho[1:...])
    prev_pair = np.inf
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)  # enforce monotone
        tau += 2.0 * pair
        prev_pair = pair
        t += 2
    return float(m * n / max(tau, 1e-12))


def split_rhat(chains: np.ndarray) -> float:
    """Split-R̂ of a scalar quantity; chains: (n_chains, n_samples)."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    m, n = chains.shape
    half = n // 2
    sp = np.concatenate([chains[:, :half], chains[:, half : 2 * half]], axis=0)
    mm, nn = sp.shape
    chain_means = sp.mean(axis=1)
    chain_vars = sp.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = nn * chain_means.var(ddof=1)
    var_plus = (nn - 1) / nn * w + b / nn
    if w <= 0:
        return 1.0
    return float(np.sqrt(var_plus / w))


def rhat_groups(groups: np.ndarray) -> float:
    """Between-group R̂ of a scalar over (n_groups, n_per_group) samples.

    The classic potential-scale-reduction ratio sqrt(var_plus / W), with the
    groups playing the role of chains and NO split along the sample axis —
    the members of a group (e.g. one SMC resampling island's particles) are
    exchangeable draws, not a serial chain, so splitting is meaningless.
    Used for the islands convergence gate (VERDICT round-4 item 2): clones
    inside one ancestry agree by construction, so between-ISLAND spread is
    the honest measure of population convergence.
    """
    g = np.atleast_2d(np.asarray(groups, dtype=np.float64))
    m, n = g.shape
    if m < 2 or n < 2:
        return float("nan")
    w = g.var(axis=1, ddof=1).mean()
    b = n * g.mean(axis=1).var(ddof=1)
    var_plus = (n - 1) / n * w + b / n
    if w <= 0:
        return 1.0
    return float(np.sqrt(var_plus / w))


def summarize(chains: np.ndarray) -> dict:
    """Posterior summary of one scalar: mean, sd, mc standard error, ess, rhat."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    if chains.shape[1] < 2:
        # zero/one draws (e.g. resuming an already-complete checkpointed
        # run): no moments to report, and split-R̂/ESS are undefined
        flat = chains.reshape(-1)
        mean = float(flat.mean()) if flat.size else float("nan")
        return {"mean": mean, "sd": float("nan"), "mcse": float("nan"),
                "ess": 0.0, "rhat": float("nan")}
    flat = chains.reshape(-1)
    n_eff = ess(chains)
    sd = flat.std(ddof=1)
    return {
        "mean": float(flat.mean()),
        "sd": float(sd),
        "mcse": float(sd / np.sqrt(max(n_eff, 1.0))),
        "ess": n_eff,
        "rhat": split_rhat(chains),
    }


def compare_moments(chains_a: np.ndarray, chains_b: np.ndarray, name: str = "") -> dict:
    """z-score comparison of posterior means of one scalar between two samplers.

    z = |mu_a - mu_b| / sqrt(mcse_a^2 + mcse_b^2)   (SURVEY.md §3.6)
    """
    sa, sb = summarize(chains_a), summarize(chains_b)
    denom = np.sqrt(sa["mcse"] ** 2 + sb["mcse"] ** 2)
    z = abs(sa["mean"] - sb["mean"]) / max(denom, 1e-12)
    return {"name": name, "z": float(z), "a": sa, "b": sb}


def moments_match(chains_a, chains_b, z_max: float = 4.0) -> bool:
    return compare_moments(chains_a, chains_b)["z"] < z_max
