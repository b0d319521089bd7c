"""Which CUDA kernel runs a trajectory, chosen by the scene's shape and the
catalog capacity alone.

Two kernels share each of four call contracts: the plain leapfrog (B1 on
small scenes, fused_leapfrog.py; B5 on crowded fields,
fused_leapfrog_crowded.py), the same with a runtime step count for ChEES
(B2, the B1 kernel; B5 again), the diagonal-Fisher Riemannian trajectory
(B3, fused_rhmc_diag.py; B4, fused_rhmc_diag_crowded.py) and the
full-Fisher one (B6, fused_rhmc.py; B6c, fused_rhmc_crowded.py): three
pairs of kernels, the leapfrog's serving two contracts.  The small-scene
kernel takes what its domain holds (its shared memory, its star counts:
H W <= 48^2 and K <= 16), the crowded-field kernel every other scene and
catalog, as the JAX package's _select_kernel sends every scene beyond its
Pallas kernels' VMEM gates to XLA (starcat/api.py:44-53): B5, B4 and B6c
take every scene and K >= 1.  So the choice raises only for K < 1, naming
both kernels.  Where a launch's workspace does not fit the card (B6c's
beyond about K = 21,300 on 128x128), its allocation raises PyTorch's
out-of-memory error; nothing falls back.  The heads do not care which
kernel of a pair runs: the contracts are the same, and on the CPU both
wrappers run the same plain version.

The crowded-field kernels also run small scenes.  On an NVIDIA H100 80GB
HBM3 at 700 W (chip_smoke.py) a 6 x 4 diagonal-Fisher trajectory of 256
chains at K = 16 on 32x32 takes 0.295 ms on B3 and 0.971 ms on B4, whose
GEMM tiles span 128 x 128 pixels, so B3 stays.  On the same card
(scripts/b1_before_after.py, kernel time in turns) an L = 20 leapfrog of
1024 chains at K = 10 on 32x32 takes 0.122 ms on B1 and 0.198 ms on B5,
whose tile follows the scene, and ChEES's adapted 1024 steps 6.04 ms
against 9.87; cfg0's 4 chains (K = 1, 16x16), the trans-d hmc move's 256
(K = 16, per-chain masks) and 1024 chains at K = 16 on 48x48 run faster on
B1 than on B5 too, the last by 2%: B1 stays in its domain.
"""
from __future__ import annotations

import torch

from . import (
    fused_leapfrog,
    fused_leapfrog_crowded,
    fused_rhmc,
    fused_rhmc_crowded,
    fused_rhmc_diag,
    fused_rhmc_diag_crowded,
)

LEAPFROG = ((fused_leapfrog, "B1"), (fused_leapfrog_crowded, "B5"))
RHMC_DIAG = ((fused_rhmc_diag, "B3"), (fused_rhmc_diag_crowded, "B4"))
RHMC_FULL = ((fused_rhmc, "B6"), (fused_rhmc_crowded, "B6c"))


def _choose(pair, spec, kmax: int):
    errs = []
    for module, name in pair:
        err = module.domain_error(spec, kmax)
        if err is None:
            return module, name
        errs.append(err)
    raise ValueError("; and ".join(errs))


def leapfrog_module(spec, kmax: int):
    """(module, name) of the leapfrog kernel for this scene: B1 or B5."""
    return _choose(LEAPFROG, spec, kmax)


def rhmc_diag_module(spec, kmax: int):
    """(module, name) of the diagonal-Fisher kernel for this scene: B3 or B4."""
    return _choose(RHMC_DIAG, spec, kmax)


def rhmc_full_module(spec, kmax: int):
    """(module, name) of the full-Fisher kernel for this scene: B6 or B6c."""
    return _choose(RHMC_FULL, spec, kmax)


def make_leapfrog(spec, image, prior, kmax: int, n_steps: int):
    """B1's contract on the kernel that takes this scene."""
    return leapfrog_module(spec, kmax)[0].make_fused_leapfrog(spec, image, prior, kmax,
                                                              n_steps)


def make_grad_fn(spec, image, prior, mask):
    """A batched (U (N,), grad U (N, K, 3)) at theta (N, K, 3) with the
    catalog ``mask``, one launch of B1's contract at n_steps = 0 (the kernel
    that takes this scene; its plain version on the CPU)."""
    kmax = int(mask.shape[-1])
    fused = make_leapfrog(spec, image, prior, kmax, 0)
    unit = torch.ones((kmax, 3), dtype=torch.float32, device=image.device)
    return lambda theta: fused(theta, torch.zeros_like(theta), 0.0, unit, mask)[2:]  # noqa: E731


def make_leapfrog_dyn(spec, image, prior, kmax: int):
    """B2's contract (a runtime step count) on the kernel that takes this
    scene: B1's kernel inside its domain, B5 beyond it."""
    return leapfrog_module(spec, kmax)[0].make_fused_leapfrog_dyn(spec, image, prior, kmax)


def make_rhmc_diag(spec, image, prior, kmax: int, n_steps: int, fixed_point_iters: int,
                   jitter: float = 1e-3):
    """B3's contract on the kernel that takes this scene."""
    return rhmc_diag_module(spec, kmax)[0].make_fused_rhmc_diag(
        spec, image, prior, kmax, n_steps, fixed_point_iters, jitter)


def make_rhmc_full(spec, image, prior, kmax: int, n_steps: int, fixed_point_iters: int,
                   jitter: float = 1e-3):
    """B6's contract on the kernel that takes this scene."""
    return rhmc_full_module(spec, kmax)[0].make_fused_rhmc(
        spec, image, prior, kmax, n_steps, fixed_point_iters, jitter)


def trajectory_kernel(head: str, metric: str | None, spec, kmax: int) -> str:
    """The name of the kernel a head's trajectory runs on ("B1".."B6",
    "B6c"): ``metric`` "full" (B6/B6c) or "diag" (B3/B4) for the Riemannian
    heads and mutations, None for the plain leapfrog (chees: B2's runtime
    step count, on B1's kernel ("B2") or on B5; otherwise, hmc's
    trajectories, nuts's one-step leaves and advi's gradients at n_steps =
    0, B1/B5).  Raises beyond both kernels' domains."""
    if metric == "full":
        return rhmc_full_module(spec, kmax)[1]
    if metric == "diag":
        return rhmc_diag_module(spec, kmax)[1]
    name = leapfrog_module(spec, kmax)[1]
    return "B2" if head == "chees" and name == "B1" else name
