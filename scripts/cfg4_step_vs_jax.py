"""One cfg4_crowded temperature step, full scene (128x128, K_max 64, twelve
residual-birth sweeps, two diagonal-Fisher mutations of 6 x 4), in both
packages on the CPU on the JAX keys' own draws, at a small population.

    JAX_PLATFORMS=cpu python scripts/cfg4_step_vs_jax.py [--particles 8] [--steps 2]

The JAX step runs the preset's ``rhmc_diag_pallas`` mutation (Pallas B4 in
interpret mode off the TPU); the port's step runs B4's plain version.  From
the prior population, each step's beta, log Z, star counts, theta and
log-likelihoods are compared; each next step starts both packages from
the JAX state.  Prints one JSON line per step with the largest
differences.  The JAX keys' draws are built by tests/jax_draws.py's
``jax_step_draws``.  About a minute per step on one CPU core.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from starcat import smc as jsmc
    from starcat.configs import CONFIGS as JAX_CONFIGS
    from starcat_torch import smc
    from starcat_torch.convert import (
        prior_from_jax,
        smc_config_from_jax,
        smc_state_from_numpy,
        spec_from_jax,
    )
    from jax_draws import jax_step_draws

    jcfg = JAX_CONFIGS["cfg4_crowded"]
    k = jcfg.kmax
    hw = jcfg.scene.height * jcfg.scene.width
    cfg_j = jcfg.smc._replace(n_particles=args.particles)
    _, img = jcfg.make_data()
    img_t = torch.from_numpy(np.array(img, dtype=np.float32))

    st = jsmc.init_smc(jax.random.key(args.seed), jcfg.scene, img, jcfg.prior, k, cfg_j)
    jstep = jax.jit(jsmc.make_smc_step(jcfg.scene, img, jcfg.prior, cfg_j))
    tstep = smc.make_smc_step(spec_from_jax(jcfg.scene), img_t, prior_from_jax(jcfg.prior), k,
                              smc_config_from_jax(cfg_j))
    for i in range(args.steps):
        nxt = jstep(st)
        ts = smc_state_from_numpy(st.theta, st.mask, st.loglik, st.beta, st.log_z, st.eps,
                                  st.n_steps, st.mean_accept, st.final_done, "cpu")
        tn = tstep(ts, jax_step_draws(st.key, cfg_j, k, hw))
        print(json.dumps({
            "step": i + 1, "beta": [float(nxt.beta), float(tn.beta)],
            "log_z": [float(nxt.log_z), float(tn.log_z)],
            "mean_n": [float(np.asarray(nxt.mask).sum(-1).mean()), float(tn.mask.sum(-1).mean())],
            "masks_equal": bool(np.array_equal(np.asarray(nxt.mask), tn.mask.numpy())),
            "theta_max_diff": float(np.abs(np.asarray(nxt.theta) - tn.theta.numpy()).max()),
            "loglik_max_rel": float((np.abs(np.asarray(nxt.loglik) - tn.loglik.numpy())
                                     / np.abs(np.asarray(nxt.loglik))).max()),
            "accept": [float(nxt.mean_accept), float(tn.mean_accept)]}), flush=True)
        st = nxt


if __name__ == "__main__":
    main()
