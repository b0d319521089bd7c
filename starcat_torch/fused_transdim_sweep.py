"""One trans-dimensional sweep at the tempered Poisson likelihood as one
launch of a hand-written CUDA kernel (csrc/fused_transdim_sweep.cu) behind
transdim.poisson_sweep's contract:

    fused_poisson_sweep(theta, mask, tll, beta, prior, spec, image, cfg, draws)
        -> (theta' (C, K, 3), mask' (C, K), tll' (C,),
            MoveInfo(accepted bool (C,), log_alpha (C,), move_type int64 (C,)))

tll is the tempered log-likelihood beta * log L of each chain's catalog;
beta is a float or one float32 on the device, which the kernel reads
without a host sync; draws is a transdim.SweepDraws of either birth
proposal, read as draw_sweep made it.  Each chain computes only the move
its draws select, with the plain version's rules
(transdim.poisson_sweep_reference, the same mathematics): one render a
chain where the plain version renders six (four with prior births).

The kernel replaces no TPU kernel: the JAX package's sweep is XLA.  It
takes every scene and every K >= 1 (regions of the field and chunks of the
catalog; :func:`launch_layout` reads the build's layout); a residual-birth
sweep takes a workspace of C H W floats for the current lam of its birth
chains (:func:`workspace_floats`).  The wrapper checks every tensor's device,
dtype, shape and contiguity and raises on what the kernel does not take;
it launches only on a CUDA device, and counts its launches in LAUNCHES.
transdim.poisson_sweep runs the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .potential import PriorSpec
from .scene import SceneSpec
from .transdim import MoveInfo

N_SCALARS = 20        # kScalars in the source

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def workspace_floats(c: int, height: int, width: int, birth_proposal: str) -> int:
    """The workspace a launch takes: lam of every chain for residual births
    (a birth chain keeps its current lam between its three pixel passes),
    nothing for prior births."""
    return c * height * width if birth_proposal == "residual" else 0


@functools.cache
def library() -> ctypes.CDLL:
    """csrc/fused_transdim_sweep.cu's library (built at first use), typed."""
    lib = ctypes.CDLL(str(build.build_kernel("fused_transdim_sweep")[0]))
    return type_library(lib)


def type_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build's entries typed: the sweep and its layout query."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.starcat_fused_transdim_sweep
    fn.argtypes = [vp] * 26 + [ci] * 5 + [ctypes.POINTER(ctypes.c_float), ci, vp]
    fn.restype = ci
    lay = lib.starcat_fused_transdim_sweep_layout
    lay.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
    lay.restype = ci
    lib.starcat_cuda_error_string.argtypes = [ci]
    lib.starcat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_layout(c: int, kmax: int, height: int, width: int, lib=None) -> dict:
    """The layout a build (``lib``, default this checkout's) gives a launch,
    from its layout entry (layout_of in the source): a field that pads to
    less area in 32 x 32 regions than in 128 x 128 ones takes 64 threads a
    chain and four chains a block, else 256 threads and one chain; the
    chunk is min(K, 64) slots; the dynamic shared memory holds, for each
    chain of a block, a chunk's star list and its profiles over a region's
    rows and columns."""
    out = (ctypes.c_int * 7)()
    rc = (lib or library()).starcat_fused_transdim_sweep_layout(c, kmax, height, width, out)
    if rc != 0:
        raise RuntimeError(f"starcat_fused_transdim_sweep_layout failed ({rc})")
    return dict(zip(("threads_per_chain", "chains_per_block", "region_rows", "region_cols",
                     "chunk", "smem_bytes", "blocks"), list(out)))


def scalars(spec: SceneSpec, prior: PriorSpec, cfg) -> tuple:
    """The kernel's float constants, in the source's order: the scene's and
    the prior's, and the sweep's as the plain code writes them (each a
    Python float there, rounded to float32 where it meets a tensor)."""
    sig = float(spec.psf_sigma)
    w, h = float(spec.width), float(spec.height)
    return (sig, 1.0 / (math.sqrt(2.0 * math.pi) * sig), float(spec.background),
            float(prior.logf_mean), float(prior.logf_sigma), math.log(prior.logf_sigma),
            0.5 * math.log(2.0 * math.pi), math.log(cfg.lam_count), math.log(w * h),
            float(cfg.split_sigma),
            -math.log(2.0 * math.pi * cfg.split_sigma * cfg.split_sigma),
            float(cfg.p_birth_death), float(cfg.fmin), float(cfg.resid_floor),
            (1.0 - 1e-4) - 1e-4, 1e-4, 1.0 - 1e-4, 1e-3, w - 1e-3, h - 1e-3)


def check_inputs(theta, mask, tll, beta, image, draws, spec: SceneSpec, cfg) -> torch.Tensor:
    """Raise unless every tensor is what the kernel reads: float32,
    contiguous, on theta's device, of the sweep's shapes (theta (C, K, 3),
    mask (C, K), tll (C,), image (H, W), the draws of cfg's birth
    proposal); returns beta as one float32 on that device."""
    if theta.ndim != 3 or theta.shape[0] < 1 or theta.shape[1] < 1:
        raise ValueError(f"theta must be (C, K, 3) with C, K >= 1, got {tuple(theta.shape)}")
    c, k = theta.shape[:2]
    h, w = spec.height, spec.width
    dev = theta.device
    check = build.check_tensor
    check("theta", theta, (c, k, 3), dev)
    check("mask", mask, (c, k), dev)
    check("tll", tll, (c,), dev)
    check("image", image, (h, w), dev)
    check("u_sel", draws.u_sel, (c,), dev)
    if cfg.birth_proposal == "residual":
        names = ("u_move", "g_slot", "g_pix", "u_sub", "z", "u_acc")
        shapes = ((c,), (c, k), (c, h * w), (c, 2), (c,), (c,))
    elif cfg.birth_proposal == "prior":
        names = ("u_move", "g_slot", "theta_star", "u_acc")
        shapes = ((c,), (c, k), (c, 3), (c,))
    else:
        raise ValueError(f"unknown birth_proposal {cfg.birth_proposal!r}")
    if len(draws.bd) != len(names) or len(draws.sm) != 6:
        raise ValueError(f"the draws do not match birth_proposal={cfg.birth_proposal!r}")
    for name, t, shape in zip(names, draws.bd, shapes):
        check(f"bd.{name}", t, shape, dev)
    for name, t, shape in zip(("u_move", "g_j", "g_d", "u_u", "z_delta", "u_acc"), draws.sm,
                              ((c,), (c, k), (c, k), (c,), (c, 2), (c,))):
        check(f"sm.{name}", t, shape, dev)
    if isinstance(beta, torch.Tensor):
        if beta.dtype != torch.float32 or beta.numel() != 1 or beta.device != dev:
            raise ValueError("beta must be one float32 on the chains' device")
        return beta.reshape(1).contiguous()
    return torch.full((1,), float(beta), dtype=torch.float32, device=dev)


def run(lib: ctypes.CDLL, stream, theta, mask, tll, beta_dev, image, draws, spec: SceneSpec,
        prior: PriorSpec, cfg):
    """One launch of ``lib``'s sweep on checked tensors (check_inputs),
    outputs allocated here; raises if the launch fails."""
    c, k = theta.shape[:2]
    dev = theta.device
    residual = cfg.birth_proposal == "residual"
    theta_out, mask_out = torch.empty_like(theta), torch.empty_like(mask)
    tll_out, log_alpha = torch.empty_like(tll), torch.empty_like(tll)
    accepted = torch.empty((c,), dtype=torch.bool, device=dev)
    move = torch.empty((c,), dtype=torch.int64, device=dev)
    work = (torch.empty(workspace_floats(c, spec.height, spec.width, cfg.birth_proposal),
                        dtype=torch.float32, device=dev) if residual else None)
    if residual:
        u_move, g_slot, g_pix, u_sub, z, u_acc = draws.bd
        star = None
    else:
        u_move, g_slot, star, u_acc = draws.bd
        g_pix = u_sub = z = None
    consts = (ctypes.c_float * N_SCALARS)(*scalars(spec, prior, cfg))

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.starcat_fused_transdim_sweep(
        *(ptr(t) for t in (theta, mask, tll, beta_dev, image, draws.u_sel, u_move, g_slot,
                           star, g_pix, u_sub, z, u_acc, *draws.sm, theta_out, mask_out,
                           tll_out, log_alpha, accepted, move, work)),
        c, k, spec.height, spec.width, int(residual), consts, N_SCALARS, stream)
    if rc != 0:
        msg = lib.starcat_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_transdim_sweep launch failed: {msg} ({rc})")
    return theta_out, mask_out, tll_out, MoveInfo(accepted, log_alpha, move)


def fused_poisson_sweep(theta, mask, tll, beta, prior: PriorSpec, spec: SceneSpec,
                        image: torch.Tensor, cfg, draws):
    """transdim.poisson_sweep on the card: one launch, or a raise."""
    global LAUNCHES
    beta_dev = check_inputs(theta, mask, tll, beta, image, draws, spec, cfg)
    if theta.device.type != "cuda":
        raise ValueError(f"the fused trans-d sweep needs CUDA tensors, got {theta.device}")
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        out = run(library(), stream, theta, mask, tll, beta_dev, image, draws, spec, prior, cfg)
    LAUNCHES += 1
    return out
