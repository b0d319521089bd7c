"""Write starcat_torch/data/scenes.npz: the mock truth and image that the
JAX package's ``RunConfig.make_data()`` draws for the presets the PyTorch
port runs, so both packages sample the same image.

    JAX_PLATFORMS=cpu python scripts/export_torch_scenes.py

Entries: ``cfg0_single_star`` and ``flagship`` (the 10-star 32x32 scene
that cfg2_nuts and cfg6_chees share, with the same prior and seeds).  Each
entry holds ``theta`` (n_stars, 3) and ``image`` (H, W) as float32, and
``meta`` = (height, width, psf_sigma, background, logf_mean, logf_sigma,
n_stars, truth_seed, data_seed), which starcat_torch.configs matches.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "starcat_torch" / "data" / "scenes.npz"
ENTRIES = {"cfg0_single_star": "cfg0_single_star", "flagship": "cfg6_chees"}


def _meta(cfg) -> np.ndarray:
    return np.array([cfg.scene.height, cfg.scene.width, cfg.scene.psf_sigma,
                     cfg.scene.background, cfg.prior.logf_mean,
                     cfg.prior.logf_sigma, cfg.n_stars, cfg.truth_seed,
                     cfg.data_seed], dtype=np.float64)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    from starcat.configs import CONFIGS

    arrays = {}
    for entry, name in ENTRIES.items():
        cfg = CONFIGS[name]
        theta, image = cfg.make_data()
        arrays[f"{entry}/theta"] = np.asarray(theta, dtype=np.float32)
        arrays[f"{entry}/image"] = np.asarray(image, dtype=np.float32)
        arrays[f"{entry}/meta"] = _meta(cfg)
    # the flagship entry stands for cfg2 too: same scene, prior and seeds
    cfg2 = CONFIGS["cfg2_nuts"]
    if not np.array_equal(_meta(cfg2), arrays["flagship/meta"]):
        raise SystemExit("cfg2_nuts no longer shares the flagship scene")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
