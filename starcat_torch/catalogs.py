"""Catalog-level postprocessing (port of starcat/catalogs.py, which is
NumPy only): condensed catalogs and completeness / purity curves.

A probabilistic-cataloging posterior is a distribution over catalogs: each
draw is a set of (x, y, flux) point sources, the alive slots of the masked
fixed-capacity catalog.  Slot indices are not identified across draws
(label switching, birth/death churn), so per-slot moments mean nothing for
trans-dimensional runs.  The summaries of the probabilistic-cataloging
literature (Portillo et al. 2017; Daylan et al. 2017) are:

- **condensed catalog**: cluster the pooled posterior stars across draws
  into sources; report per-source posterior mean/sd of position and flux
  plus *prevalence*, the fraction of draws containing a matched star,
  which is the posterior probability that the source is real.
- **completeness / purity vs flux**: match each posterior draw's catalog
  to the truth catalog within a radius; completeness(f) = P(truth star of
  flux f is recovered), purity(f) = P(posterior star of flux f is real).

Everything here is host-side NumPy on the draws that ``api.sample``
returns (already on the host), and none of it is on the hot path.  The
code is the reference's line for line, with the same deterministic
subsampling (``numpy.random.default_rng(seed)``), so on the same arrays
the port gives the reference's catalogs exactly.  Matching uses a pixel
grid hash so a draw-vs-draw match is O(stars), not O(stars^2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .scene import SceneSpec


# ---------------------------------------------------------------------------
# extraction: (C, N, K, 3) unconstrained draws -> list of per-draw catalogs


def extract_catalogs(thetas: np.ndarray, masks: np.ndarray, spec: SceneSpec,
                     max_draws: int = 512, seed: int = 0):
    """Flatten posterior draws into a list of constrained catalogs.

    thetas: (C, N, K, 3) unconstrained (logit-x, logit-y, log-flux);
    masks: (K,) shared, (C, K) / (P, K) per-chain, or (C, N, K) per-draw.
    Returns a list of (n_i, 3) float arrays [x_pix, y_pix, flux], one per
    kept draw, subsampled deterministically to at most max_draws (the
    condensation cost is O(draws · stars); 512 draws give prevalence a
    ±2% MC error, plenty for a summary table).
    """
    th = np.asarray(thetas, dtype=np.float64)
    c, n, k, _ = th.shape
    m = np.asarray(masks)
    if m.ndim == 1:
        alive = np.broadcast_to(m[None, None, :], (c, n, k))
    elif m.ndim == 2:
        alive = np.broadcast_to(m[:, None, :], (c, n, k))
    else:
        alive = m
    th = th.reshape(c * n, k, 3)
    alive = alive.reshape(c * n, k) > 0.5

    total = c * n
    if total > max_draws:
        idx = np.random.default_rng(seed).choice(total, max_draws, replace=False)
        idx.sort()
        th, alive = th[idx], alive[idx]

    x = spec.width / (1.0 + np.exp(-th[..., 0]))
    y = spec.height / (1.0 + np.exp(-th[..., 1]))
    f = np.exp(th[..., 2])
    cats = []
    for i in range(th.shape[0]):
        a = alive[i]
        cats.append(np.stack([x[i][a], y[i][a], f[i][a]], axis=1))
    return cats


# ---------------------------------------------------------------------------
# grid-hash matching


class _Grid:
    """Pixel-grid hash over star positions for O(1) radius queries."""

    def __init__(self, xy: np.ndarray, cell: float):
        self.cell = cell
        self.xy = xy
        self.buckets: dict[tuple[int, int], list[int]] = {}
        ij = np.floor(xy / cell).astype(int)
        for idx, (i, j) in enumerate(map(tuple, ij)):
            self.buckets.setdefault((i, j), []).append(idx)

    def near(self, x: float, y: float):
        i0, j0 = int(np.floor(x / self.cell)), int(np.floor(y / self.cell))
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                yield from self.buckets.get((i0 + di, j0 + dj), ())


def match_catalogs(cat_a: np.ndarray, cat_b: np.ndarray, radius: float):
    """Greedy nearest-neighbour match a→b within radius, one-to-one.

    Pairs are formed in order of increasing distance (the standard greedy
    matching of completeness studies).  Returns (pairs, unmatched_a,
    unmatched_b) index arrays; pairs is (m, 2) of [ia, ib].
    """
    if len(cat_a) == 0 or len(cat_b) == 0:
        return (np.empty((0, 2), int), np.arange(len(cat_a)),
                np.arange(len(cat_b)))
    grid = _Grid(cat_b[:, :2], max(radius, 1e-6))
    cand = []  # (dist, ia, ib)
    r2 = radius * radius
    for ia, (x, y, _) in enumerate(cat_a):
        for ib in grid.near(x, y):
            d2 = (x - cat_b[ib, 0]) ** 2 + (y - cat_b[ib, 1]) ** 2
            if d2 <= r2:
                cand.append((d2, ia, ib))
    cand.sort()
    used_a = np.zeros(len(cat_a), bool)
    used_b = np.zeros(len(cat_b), bool)
    pairs = []
    for _, ia, ib in cand:
        if not used_a[ia] and not used_b[ib]:
            used_a[ia] = used_b[ib] = True
            pairs.append((ia, ib))
    pairs = np.array(pairs, int).reshape(-1, 2)
    return pairs, np.where(~used_a)[0], np.where(~used_b)[0]


# ---------------------------------------------------------------------------
# condensed catalog


@dataclass
class CondensedSource:
    x: float
    y: float
    flux: float
    x_sd: float
    y_sd: float
    flux_sd: float
    prevalence: float  # fraction of draws containing a matched star

    def as_dict(self):
        return {k: round(float(v), 4) for k, v in self.__dict__.items()}


def condense(cats: list[np.ndarray], radius: float = 1.0,
             min_prevalence: float = 0.1) -> list[CondensedSource]:
    """Seed-based condensation of posterior catalogs into sources.

    Repeatedly: (1) pick the not-yet-claimed posterior star with the most
    support (number of draws having a star within `radius`); (2) claim, in
    every draw, the nearest unclaimed star within `radius` of that seed —
    at most one per draw, so prevalence is a well-defined probability;
    (3) emit the cluster's moments + prevalence.  Stop when the best seed's
    prevalence drops below `min_prevalence`.  This is the Portillo et al.
    (2017) condensed-catalog construction adapted to the masked-slot
    representation.
    """
    n_draws = len(cats)
    if n_draws == 0:
        return []
    stars = np.concatenate([c for c in cats if len(c)], axis=0) \
        if any(len(c) for c in cats) else np.empty((0, 3))
    draw_of = np.concatenate([np.full(len(c), i) for i, c in enumerate(cats)
                              if len(c)]) if len(stars) else np.empty(0, int)
    claimed = np.zeros(len(stars), bool)
    out: list[CondensedSource] = []
    if len(stars) == 0:
        return out
    grid = _Grid(stars[:, :2], max(radius, 1e-6))
    r2 = radius * radius

    def neighbours(idx: int):
        """Unclaimed stars within radius of star idx, as an index array."""
        x, y = stars[idx, 0], stars[idx, 1]
        ns = [j for j in grid.near(x, y)
              if not claimed[j]
              and (x - stars[j, 0]) ** 2 + (y - stars[j, 1]) ** 2 <= r2]
        return np.array(ns, int)

    # support = number of distinct draws with an unclaimed star near idx.
    # Cached per star and invalidated only for stars whose neighbourhood
    # intersects newly claimed members — claiming can only SHRINK a
    # neighbourhood, so untouched caches stay exact and the selection is
    # identical to a full recompute (same lowest-index tiebreak).  This
    # turns the scan from O(sources · pooled_stars · bucket) into
    # O(pooled_stars · bucket) amortized — cfg4-scale reports (512 draws ×
    # ~50 stars) condense in seconds instead of minutes.
    support = np.full(len(stars), -1.0)          # -1 = stale
    while True:
        unclaimed = np.where(~claimed)[0]
        if len(unclaimed) == 0:
            break
        for idx in unclaimed[support[unclaimed] < 0]:
            support[idx] = len(np.unique(draw_of[neighbours(idx)]))
        best_idx = int(unclaimed[np.argmax(support[unclaimed])])
        best_support = support[best_idx]
        if best_support < min_prevalence * n_draws:
            break
        seed = stars[best_idx]
        ns = neighbours(best_idx)
        # one star per draw: nearest to the seed
        d2 = (stars[ns, 0] - seed[0]) ** 2 + (stars[ns, 1] - seed[1]) ** 2
        members = {}
        for j, dj in sorted(zip(ns, d2), key=lambda t: t[1]):
            dr = draw_of[j]
            if dr not in members:
                members[dr] = j
        mem = np.array(list(members.values()), int)
        claimed[mem] = True
        # invalidate cached support of unclaimed stars whose neighbourhood
        # contains a newly claimed member
        for m in mem:
            mx, my = stars[m, 0], stars[m, 1]
            for j in grid.near(mx, my):
                if (not claimed[j]
                        and (mx - stars[j, 0]) ** 2
                        + (my - stars[j, 1]) ** 2 <= r2):
                    support[j] = -1.0
        sx, sy, sf = stars[mem, 0], stars[mem, 1], stars[mem, 2]
        out.append(CondensedSource(
            x=sx.mean(), y=sy.mean(), flux=sf.mean(),
            x_sd=sx.std(), y_sd=sy.std(), flux_sd=sf.std(),
            prevalence=len(mem) / n_draws,
        ))
    out.sort(key=lambda s: -s.flux)
    return out


# ---------------------------------------------------------------------------
# completeness / purity vs truth


def completeness_purity(cats: list[np.ndarray], truth: np.ndarray,
                        radius: float = 1.0, flux_bins: np.ndarray | None = None):
    """Per-flux-bin completeness and purity against a truth catalog.

    truth: (n, 3) [x_pix, y_pix, flux].  For each posterior draw the truth
    is greedy-matched to the draw's catalog within `radius`;
    completeness(bin) = fraction of (truth star, draw) pairs with the truth
    star matched, binned by TRUTH flux; purity(bin) = fraction of
    (posterior star, draw) pairs matched to a truth star, binned by the
    POSTERIOR star's flux.  Returns a dict with bin edges, curves, counts,
    and the mean matched-flux relative error.
    """
    truth = np.asarray(truth, dtype=np.float64)
    if flux_bins is None:
        lo = max(truth[:, 2].min() / 2.0, 1e-3) if len(truth) else 1e-3
        hi = truth[:, 2].max() * 2.0 if len(truth) else 1.0
        flux_bins = np.geomspace(lo, hi, 8)
    nb = len(flux_bins) - 1
    t_match = np.zeros(nb)
    t_total = np.zeros(nb)
    p_match = np.zeros(nb)
    p_total = np.zeros(nb)
    flux_err = []
    # stars whose flux falls outside the bin range are EXCLUDED (not lumped
    # into the edge bins, which would distort the faintest/brightest
    # completeness and purity values)
    t_bin = (np.digitize(truth[:, 2], flux_bins) - 1
             if len(truth) else np.empty(0, int))
    t_in = (t_bin >= 0) & (t_bin < nb)
    for cat in cats:
        pairs, un_t, un_p = match_catalogs(truth, cat, radius)
        np.add.at(t_total, t_bin[t_in], 1.0)
        if len(pairs):
            sel = pairs[:, 0][t_in[pairs[:, 0]]]
            np.add.at(t_match, t_bin[sel], 1.0)
            flux_err.append(
                (cat[pairs[:, 1], 2] - truth[pairs[:, 0], 2])
                / truth[pairs[:, 0], 2])
        if len(cat):
            p_bin = np.digitize(cat[:, 2], flux_bins) - 1
            p_in = (p_bin >= 0) & (p_bin < nb)
            np.add.at(p_total, p_bin[p_in], 1.0)
            if len(pairs):
                psel = pairs[:, 1][p_in[pairs[:, 1]]]
                np.add.at(p_match, p_bin[psel], 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        completeness = np.where(t_total > 0, t_match / t_total, np.nan)
        purity = np.where(p_total > 0, p_match / p_total, np.nan)
    fe = np.concatenate(flux_err) if flux_err else np.empty(0)
    return {
        "flux_bins": flux_bins.tolist(),
        "completeness": [None if np.isnan(v) else round(float(v), 4)
                         for v in completeness],
        "purity": [None if np.isnan(v) else round(float(v), 4)
                   for v in purity],
        "n_truth_per_bin": t_total.tolist(),
        "n_posterior_per_bin": p_total.tolist(),
        "matched_flux_rel_err_mean": float(fe.mean()) if len(fe) else None,
        "matched_flux_rel_err_sd": float(fe.std()) if len(fe) else None,
    }


def catalog_report(out, truth_theta=None, radius: float = 1.0,
                   max_draws: int = 512) -> dict:
    """One-call catalog summary for a SampleOutput: condensed catalog +
    (if truth is provided) completeness/purity.  truth_theta is the
    unconstrained (K, 3) truth used by cfg.make_data()."""
    spec = out.config.scene
    cats = extract_catalogs(out.thetas, out.masks, spec, max_draws=max_draws)
    cond = condense(cats, radius=radius)
    rep = {
        "n_draws_used": len(cats),
        "match_radius_pix": radius,
        "condensed": [s.as_dict() for s in cond],
        "n_condensed_ge_half": sum(1 for s in cond if s.prevalence >= 0.5),
    }
    if truth_theta is not None:
        th = np.asarray(truth_theta, dtype=np.float64)
        tx = spec.width / (1.0 + np.exp(-th[:, 0]))
        ty = spec.height / (1.0 + np.exp(-th[:, 1]))
        tf = np.exp(th[:, 2])
        truth = np.stack([tx, ty, tf], axis=1)
        rep["completeness_purity"] = completeness_purity(cats, truth, radius)
    return rep
