"""Typed run configs and the presets whose heads are ported (port of
starcat/configs.py): ``cfg0_single_star`` (the oracle's single-star scene,
sampled by the HMC head) and ``cfg6_chees`` (the flagship 10-star 32x32
scene under ChEES).  Other presets join as their heads land.

The mock data are the reference's own: ``data/scenes.npz`` holds the truth
and image that ``starcat.configs.RunConfig.make_data`` draws at the default
seeds, written by scripts/export_torch_scenes.py.  A config whose scene,
prior, star count or seeds differ from every exported entry raises instead
of drawing different data.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .chees import ChEESConfig
from .hmc import HMCConfig
from .potential import PriorSpec
from .scene import SceneSpec

SCENES = Path(__file__).resolve().parent / "data" / "scenes.npz"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    scene: SceneSpec
    prior: PriorSpec
    n_stars: int            # true star count of the mock scene
    kmax: int               # catalog capacity (== n_stars for fixed-K heads)
    head: str               # "hmc" | "chees" | "oracle" (-> the HMC head)
    n_chains: int = 64
    n_samples: int = 1000   # recorded draws
    n_warmup: int = 500
    # trajectory implementation of the hmc/chees heads:
    #   "auto"  — the fused CUDA kernel on a CUDA device, plain torch on the CPU
    #   "cuda"  — the fused CUDA kernel; raises off its domain or device
    #   "torch" — the plain torch leapfrog (an explicit request, for measuring)
    kernel: str = "auto"
    thin: int = 1           # transitions per recorded draw (HMC head)
    truth_seed: int = 11
    data_seed: int = 12
    hmc: HMCConfig = HMCConfig()
    chees: ChEESConfig = ChEESConfig()
    notes: str = ""

    def make_data(self):
        """(truth_theta (n_stars, 3), image (H, W)), float32 CPU tensors:
        the reference's mock scene for this config, from data/scenes.npz."""
        key = (self.scene.height, self.scene.width, self.scene.psf_sigma,
               self.scene.background, self.prior.logf_mean,
               self.prior.logf_sigma, self.n_stars, self.truth_seed,
               self.data_seed)
        with np.load(SCENES) as data:
            for entry in sorted({k.split("/")[0] for k in data.files}):
                if tuple(data[f"{entry}/meta"].tolist()) == key:
                    return (torch.from_numpy(data[f"{entry}/theta"].copy()),
                            torch.from_numpy(data[f"{entry}/image"].copy()))
        raise ValueError(
            f"{self.name}: no exported mock scene for (scene, prior, n_stars, "
            f"truth_seed, data_seed) = {key}; run "
            "scripts/export_torch_scenes.py with the JAX package to add it")


CONFIGS: dict[str, RunConfig] = {}


def _register(cfg: RunConfig) -> RunConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# config 0: single star, fixed PSF; the oracle's validation target
cfg0_single_star = _register(RunConfig(
    name="cfg0_single_star",
    scene=SceneSpec(16, 16, 1.5, 5.0),
    prior=PriorSpec(5.0, 1.0),
    n_stars=1, kmax=1,
    head="oracle",
    n_chains=4, n_samples=2000, n_warmup=500,
    hmc=HMCConfig(step_size=0.05, n_leapfrog=15),
    notes="NumPy-oracle scene; `run` maps it onto the HMC head",
))

# config 6: the flagship 10-star 32x32 scene under ChEES-HMC
cfg6_chees = _register(RunConfig(
    name="cfg6_chees",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="chees",
    n_chains=1024, n_samples=1000, n_warmup=500,
    chees=ChEESConfig(step_size=0.05),
    notes="ChEES on the fused CUDA leapfrog with a runtime step count",
))


def _coerce(cur: Any, val: Any) -> Any:
    """Cast a CLI string to the type of the current value."""
    if isinstance(cur, bool):
        return str(val).lower() in ("1", "true", "yes")
    return type(cur)(val) if cur is not None else val


def _set_dotted(obj: Any, path: list[str], val: Any) -> Any:
    """Immutably set a (possibly nested) field on a dataclass/NamedTuple."""
    field, rest = path[0], path[1:]
    cur = getattr(obj, field)
    new = _set_dotted(cur, rest, val) if rest else _coerce(cur, val)
    if isinstance(obj, tuple) and hasattr(obj, "_replace"):  # NamedTuple
        return obj._replace(**{field: new})
    return dataclasses.replace(obj, **{field: new})


def apply_overrides(cfg: RunConfig, overrides: dict[str, Any]) -> RunConfig:
    """key=value overrides; dotted keys reach nested configs
    (e.g. chees.max_leapfrog=256, hmc.n_leapfrog=10)."""
    for key, val in overrides.items():
        cfg = _set_dotted(cfg, key.split("."), val)
    return cfg
