"""Effective sample size of a scalar over chains: a copy of the port's
diagnostics.ess (FFT autocovariance, Stan's combined rho-hat with the
between-chain variance, Geyer's initial monotone positive sequence)."""
from __future__ import annotations

import numpy as np


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=-1)
    return np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n].real / n


def ess(chains: np.ndarray) -> float:
    """ESS of (n_chains, n_samples) draws of one scalar."""
    chains = np.atleast_2d(np.asarray(chains, dtype=np.float64))
    m, n = chains.shape
    if n < 4:
        return float(m * n)
    acov = _autocov_fft(chains)
    chain_var = acov[:, 0] * n / (n - 1)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1) / n
    if m > 1:
        var_plus += chains.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    t, tau, prev = 1, 1.0, np.inf
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        tau += 2.0 * pair
        prev = pair
        t += 2
    return float(m * n / max(tau, 1e-12))
