"""Typed run configs and the reference's presets (port of
starcat/configs.py): ``cfg0_single_star`` (the oracle's single-star scene,
sampled by the HMC head), ``cfg1_rhmc`` (the flagship 10-star 32x32 scene
under RHMC on the full Fisher metric, kernel B6; ``rhmc.metric=diag`` runs
its diagonal on B3), ``cfg2_nuts`` (the flagship scene under NUTS, 1024
chains, every leaf one step of kernel B1), ``cfg3_transdim_smc`` (trans-dimensional SMC on the
same scene, full-metric RHMC mutations on B6), ``cfg4_crowded`` (the
50-star 128x128 crowded field under trans-dimensional SMC, diagonal-Fisher
RHMC mutations on B4; ``head=hmc kmax=50`` samples the same scene at the
true star count on B5), ``cfg5_transdim_mcmc`` (the trans-dimensional MCMC
chain on the flagship scene, diagonal-Fisher RHMC moves), ``cfg6_chees``
(the flagship scene under ChEES) and ``cfg7_advi`` (the flagship scene
under mean-field ADVI, its gradients from B1 at n_steps = 0;
``advi.full_rank=true`` fits the full-rank family).

The mock data are the reference's own: ``RunConfig.make_data`` draws the
truth and image that ``starcat.configs.RunConfig.make_data`` draws, from
the same seeds through the port of JAX's threefry draws (threefry.py), for
any scene, prior, star count and seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .advi import ADVIConfig
from .chees import ChEESConfig
from .hmc import HMCConfig
from .nuts import NUTSConfig
from .potential import PriorSpec
from .rhmc import RHMCConfig
from .scene import SceneSpec
from .smc import SMCConfig
from .threefry import constrain, key, make_mock_image, sample_prior
from .transdim import TransDimConfig
from .transdim_mcmc import TransDimMCMCConfig


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    scene: SceneSpec
    prior: PriorSpec
    n_stars: int            # true star count of the mock scene
    kmax: int               # catalog capacity (== n_stars for fixed-K heads)
    head: str               # "hmc" | "nuts" | "chees" | "rhmc" | "smc" | "advi" | "transdim"
    #                         | "oracle" (-> hmc)
    n_chains: int = 64
    n_samples: int = 1000   # recorded draws
    n_warmup: int = 500
    # trajectory implementation of every head:
    #   "auto"  — the head's CUDA kernel on a CUDA device, plain torch on the CPU
    #   "cuda"  — the CUDA kernel; raises off its domain or device
    #   "torch" — the plain torch trajectory (an explicit request, for measuring)
    kernel: str = "auto"
    thin: int = 1           # transitions per recorded draw (hmc, nuts and rhmc heads)
    truth_seed: int = 11
    data_seed: int = 12
    hmc: HMCConfig = HMCConfig()
    nuts: NUTSConfig = NUTSConfig()
    rhmc: RHMCConfig = RHMCConfig()
    smc: SMCConfig = SMCConfig()
    tdm: TransDimMCMCConfig = TransDimMCMCConfig()
    chees: ChEESConfig = ChEESConfig()
    advi: ADVIConfig = ADVIConfig()
    notes: str = ""

    def make_truth(self) -> torch.Tensor:
        """The mock truth, (n_stars, 3) float32: the prior's draw from
        key(truth_seed)."""
        return sample_prior(key(self.truth_seed), self.n_stars, self.prior)

    def make_data(self):
        """(truth_theta (n_stars, 3), image (H, W)), float32 CPU tensors:
        the truth, then a Poisson draw of its render from key(data_seed),
        JAX's bits for any scene, prior, star count and seeds."""
        theta = self.make_truth()
        x, y, f = constrain(theta, self.scene)
        return theta, make_mock_image(key(self.data_seed), x, y, f, self.scene)


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

# config 1: the flagship scene under RHMC, 64 chains, on the reference's
# default metric, the full Fisher matrix (kernel B6); rhmc.metric=diag runs
# its diagonal on kernel B3.  The reference's record runs it with thin=4.
cfg1_rhmc = _register(RunConfig(
    name="cfg1_rhmc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="rhmc",
    n_chains=64, n_samples=1000, n_warmup=400,
    rhmc=RHMCConfig(step_size=0.3, n_leapfrog=16, fixed_point_iters=6),
    notes="RHMC on the full Fisher metric (kernel B6); record run: thin=4",
))

# config 2: the flagship scene under NUTS with dual-averaging step-size
# adaptation, 1024 chains; every leaf is one step of the fused leapfrog
cfg2_nuts = _register(RunConfig(
    name="cfg2_nuts",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="nuts",
    n_chains=1024, n_samples=1000, n_warmup=500,
    nuts=NUTSConfig(step_size=0.05, max_depth=8),
    notes="NUTS, each leaf one step of kernel B1 with a signed per-chain eps",
))

# config 3: trans-dimensional cataloging by SMC on the flagship scene:
# 4096 particles, K_max 16, adaptive tempering to beta = 1, each step two
# birth/death + split/merge sweeps and two full-metric RHMC mutations
cfg3_transdim_smc = _register(RunConfig(
    name="cfg3_transdim_smc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=16,
    head="smc",
    smc=SMCConfig(
        n_particles=4096, mutation="rhmc", n_mutation_steps=2, n_leapfrog=6,
        fixed_point_iters=4, n_transdim_sweeps=2, step_size0=0.3,
        transdim=TransDimConfig(lam_count=8.0, split_sigma=1.0),
    ),
    notes="trans-d SMC, full-metric RHMC mutations on kernel B6",
))

# config 4: the crowded field, 50 stars on 128x128 at K_max 64, by
# trans-dimensional SMC: 4096 particles, twelve birth/death (residual-driven
# births) + split/merge sweeps and two diagonal-Fisher RHMC mutations per
# temperature step (kernel B4), then plateau-stopped posterior rounds
cfg4_crowded = _register(RunConfig(
    name="cfg4_crowded",
    scene=SceneSpec(128, 128, 1.5, 20.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=50, kmax=64,
    head="smc",
    smc=SMCConfig(
        n_particles=4096, mutation="rhmc_diag", n_mutation_steps=2, n_leapfrog=6,
        fixed_point_iters=4, n_transdim_sweeps=12, step_size0=0.2, max_steps=250,
        plateau_window=50, plateau_tol=0.25, max_final_rounds=1500,
        mutation_chunk=256,
        transdim=TransDimConfig(lam_count=40.0, split_sigma=1.0,
                                birth_proposal="residual"),
    ),
    notes="trans-d SMC on the crowded field, diagonal-Fisher mutations on kernel B4",
))

# config 5: the reference's own sampler shape, a trans-dimensional MCMC
# chain: birth/death + split/merge sweeps interleaved with within-model
# diagonal-Fisher RHMC moves at per-chain alive masks
cfg5_transdim_mcmc = _register(RunConfig(
    name="cfg5_transdim_mcmc",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=16,
    head="transdim",
    n_chains=256, n_samples=1000, n_warmup=400,
    tdm=TransDimMCMCConfig(
        step_size=0.15, mutation="rhmc_diag", n_leapfrog=6,
        fixed_point_iters=4, n_transdim_sweeps=2, target_accept=0.8,
        divergence_penalty=8.0,
        transdim=TransDimConfig(lam_count=8.0, split_sigma=1.0),
    ),
    notes="trans-d chain, diagonal-Fisher RHMC moves on kernel B3",
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

# config 7: ADVI on the flagship scene, the variational baseline.  Mean-field
# by default (advi.full_rank=true fits N(mu, L L^T)); n_chains and n_samples
# are unused, and the output is 1000 iid draws from the fitted q.
cfg7_advi = _register(RunConfig(
    name="cfg7_advi",
    scene=SceneSpec(32, 32, 1.5, 10.0),
    prior=PriorSpec(5.0, 0.7),
    n_stars=10, kmax=10,
    head="advi",
    advi=ADVIConfig(n_steps=3000),
    notes="variational baseline, gradients from kernel B1 at n_steps = 0",
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
    """key=value overrides; dotted keys reach nested configs to any depth
    (e.g. chees.max_leapfrog=256, rhmc.metric=diag,
    tdm.transdim.lam_count=3.0)."""
    for key, val in overrides.items():
        cfg = _set_dotted(cfg, key.split("."), val)
    return cfg
