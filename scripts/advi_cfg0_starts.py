"""ADVI on cfg0's single-star scene, as `validate` runs it (2000 steps), from
the prior draws that start it: which starts reach the posterior.

    python scripts/advi_cfg0_starts.py --device cuda --seeds 0 1 2 3
    JAX_PLATFORMS=cpu python scripts/advi_cfg0_starts.py --package jax \\
        --mu0 -0.3005 1.5895 7.2669 --seeds 0 1 2 3 4 5

The port (default): for each seed, api.sample's head=advi run on --device
with kernel=auto and kernel=torch (the same draws: the start mu0, the first
draw of the run's generator, and every xi), and the fit of its q: mean and
sd of ux, uy and log f over its 1000 draws.  With --package jax: the JAX
package's fit_advi under the keys --seeds, from the start --mu0 (K = 1:
ux, uy, log f) or, without it, from each key's own prior draw as the JAX
package's api draws it.  The posterior (the NumPy oracle, `validate`'s
reference): log f mean 5.1317, sd about 0.11.  One JSON line a fit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _port(args) -> None:
    import torch

    from starcat_torch import api
    from starcat_torch.configs import CONFIGS
    from starcat_torch.potential import sample_prior

    cfg = dataclasses.replace(CONFIGS["cfg0_single_star"], head="advi")
    for seed in args.seeds:
        gen = torch.Generator(device=args.device)
        gen.manual_seed(seed)
        mu0 = sample_prior(gen, cfg.kmax, cfg.prior, args.device)
        for kernel in ("auto", "torch"):
            out = api.sample(dataclasses.replace(cfg, kernel=kernel), args.device, seed=seed)
            th = out.thetas[:, 0, 0]
            print(json.dumps({"package": "starcat_torch", "device": out.stats["device"],
                              "seed": seed, "kernel": out.stats["kernel"],
                              "mu0": mu0[0].tolist(), "mean": th.mean(0).tolist(),
                              "sd": th.std(0).tolist(), "elbo": out.stats["elbo"]}),
                  flush=True)


def _jax(args) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import starcat
    from starcat.advi import ADVIConfig, fit_advi
    from starcat.configs import CONFIGS
    from starcat.potential import sample_prior

    cfg = CONFIGS["cfg0_single_star"]
    _, img = cfg.make_data()
    pg = starcat.make_potential_and_grad(cfg.scene, img, cfg.prior)
    mask = jnp.ones(1)
    grad_fn = lambda th: pg(th, mask)  # noqa: E731  (one function: one jit build)
    for seed in args.seeds:
        key = jax.random.key(seed)
        mu0 = (jnp.asarray([args.mu0], jnp.float32) if args.mu0
               else sample_prior(jax.random.fold_in(key, 2), 1, cfg.prior))
        res = fit_advi(key, grad_fn, mu0, mask, ADVIConfig())
        print(json.dumps({"package": "starcat", "key": seed,
                          "mu0": [float(x) for x in mu0[0]],
                          "mu": [float(x) for x in res.mu[0]],
                          "sd": [float(x) for x in jnp.exp(res.log_sigma[0])],
                          "elbo": float(res.elbo_trace[-50:].mean())}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--mu0", type=float, nargs=3, help="the start (jax): ux uy log_f")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    _jax(args) if args.package == "jax" else _port(args)


if __name__ == "__main__":
    main()
