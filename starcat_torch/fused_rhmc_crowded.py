"""Fused full-Fisher Riemannian trajectory on crowded fields: the
hand-written CUDA kernel B6c (csrc/fused_rhmc_crowded.cu) behind B6's call
contract (fused_rhmc.py) for the scenes B6 does not take:

    make_fused_rhmc(spec, image, prior, kmax, n_steps, fixed_point_iters,
                    jitter)
        -> fused(theta, xi, eps, mask, beta=1.0)
        -> (theta' (C, K, 3), p' (C, K, 3), h0, h1, u1, resid (C,))

The JAX package has no Pallas kernel here: beyond its B6 gate it runs the
full metric on XLA (starcat/api.py:205), on every scene and catalog.  So
does the kernel, on every scene and K >= 1 up to the card's memory (a
block's workspace is 22 GB at K = 10923 on 128 x 128 and fills an 80 GB
card's free memory near K = 21,300; the kernel addresses it in 64 bits,
:func:`address_probe`);
:func:`dispatch.rhmc_full_module` gives it what B6's domain does not hold.
Inside its first domain (:func:`one_tile`: at most 128 x 128 pixels and
K <= 64, where a chain's field and dense algebra fit one block's shared
memory) a launch takes that one-tile code; beyond it the wide path, which
keeps the fields and the dense algebra in the block's workspace slice and
walks the field in 128 x 128 tiles; beyond K = 347 (:func:`full_panel`) its
Cholesky streams the panel through shared memory in row blocks, and
beyond K = 615 (:func:`vectors_in_shared`) the per-star vectors live in
the slice too.  One launch takes every chain: a persistent grid of at most
one block an SM, whose blocks take the chains from a counter in the
workspace's header, each block in its own slice of that workspace in
device memory, which the wrapper allocates and whose counter it zeroes
before each launch.  The grid is cut where a full one's slices would pass
WORKSPACE_SHARE of the card's free memory (:func:`launch_layout`), so the
memory follows the card, not the chain count; where even one slice does
not fit, the allocation raises PyTorch's out-of-memory error before the
launch.  A chain's bits do not depend on the grid.  A wide launch whose
fields and profiles pass 2^31 floats of a slice (a field of about 10^9
pixels, :func:`wide_fields_in_32_bits`) raises after that allocation.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version, :func:`fused_rhmc.fused_rhmc_reference` (the same function),
only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import MAX_SMEM_BYTES, launch_riemannian, riemannian_library, riemannian_scalars
from .fused_rhmc import fused_rhmc_reference
from .potential import PriorSpec
from .scene import SceneSpec

MAX_STARS = 64    # kMaxStars in the source: the one-tile path's K
MAX_SIDE = 128    # kMaxSide in the source: the one-tile path's H, W <= 128
WIDE_TILE = 128   # wide::kTile: the q and phi fields' pixel tile
THREADS = 512     # kThreads in the source
Q_PAIRS = 8       # kQPairs in the source: star pairs of a q-field chunk
Q_DEPTH = 4 * Q_PAIRS  # kQK: that chunk's GEMM depth
Q_COEF = 12       # kCoef: floats a pair in the q coefficient table
HEADER_FLOATS = 4  # kHeader: the workspace's header, the chain counter first
INT32_MAX = 2**31 - 1
# wide::kProbeCorners in the source, in its order (address_probe)
PROBE_CORNERS = ("pair sums, first", "pair sums, plane 17's last", "packed L, first",
                 "packed L, last (row D of column D - 1)",
                 "packed L, last diagonal by the streamed panel's step", "L^-1, first",
                 "L^-1, last", "G^-1, first", "G^-1, last", "q coefficients, first",
                 "q coefficients, last")
CHOL_PANEL_LD = 36  # kPanelLd: floats a row of the Cholesky's panel by rows
WIDE_PANEL_LD = 33  # wide::kPLd: floats a row of the wide Cholesky's 32-column panel
WIDE_PANEL = 32   # kPanel: the Cholesky's panel columns
WIDE_ROW_BLOCK = 448  # wide::kRowBlock: rows of the streamed Cholesky's row block
WIDE_RING = 2 * Q_PAIRS * Q_COEF  # wide::kRing: the q coefficient ring
# wide::kSmemFloats: the dynamic shared floats a block may take, the card's
# less 1 KB for the static shared memory
WIDE_SMEM_FLOATS = (MAX_SMEM_BYTES - 1024) // 4
# the share of the card's free memory a launch's workspace may take before
# the grid is cut (launch_layout)
WORKSPACE_SHARE = 0.5

# Launch count of the CUDA kernel.
LAUNCHES = 0


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def field_stride(width: int) -> int:
    """The row stride of the kernel's fields and column profiles
    (field_stride in the source): W rounded up to 4."""
    return (width + 3) & ~3


def _round4(n: int) -> int:
    return (n + 3) & ~3


def q_extent(height: int, width: int) -> tuple[int, int]:
    """The q and phi fields' padded extent (q_rows, q_cols in the source):
    rows rounded up to 4, columns to 8."""
    return _round4(height), (width + 7) & ~7


def q_tile(height: int, width: int) -> tuple[int, int]:
    """The pixel tile (rows, columns) a thread holds in the q and phi fields
    (small_tiles in the source): 2 x 4 where those tiles number at most the
    block's threads, else 4 x 8 (at most 512 tiles up to 128 x 128)."""
    hq, wq = q_extent(height, width)
    return (2, 4) if (hq // 2) * (wq // 4) <= THREADS else (4, 8)


def region_floats(kmax: int, height: int, width: int) -> int:
    """The shared phase region (region_floats in the source): the field
    phase's 1/lam slot (H rows at the field stride, or the q field's two
    operand stages of Q_DEPTH rows and columns and their pairs' row ranges,
    where larger), gy and gy' interleaved at the odd star stride H | 1,
    and gx, gx' (or gy'' in a rebuild's pair pass), against the dense
    phase's packed L (D + 1 rows) and then L^-1 or
    the Cholesky's scratch (two column buffers and, 16-byte aligned, a
    panel by rows, CHOL_PANEL_LD floats a row), whichever is larger."""
    fs, hp, d = field_stride(width), height | 1, 3 * kmax
    hq, wq = q_extent(height, width)
    r1 = max(height * fs, 2 * (Q_DEPTH * (hq + wq) + 2 * Q_PAIRS))
    field = r1 + 2 * _round4(kmax * hp) + max(2 * kmax * fs, _round4(kmax * hp))
    packed_l = (d + 1) * (d + 2) // 2
    chol = _round4(packed_l + 2 * (d + 1)) - packed_l + CHOL_PANEL_LD * (d + 1)
    dense = packed_l + max(d * (d + 1) // 2, chol)
    return _round4(max(field, dense))


def smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory one block needs (mirrors smem_floats in the source):
    the phase region, the q coefficient ring (two chunks), 67 floats a star
    and 12 of per-chain scalars."""
    return 4 * (region_floats(kmax, height, width) + 2 * Q_PAIRS * Q_COEF + 67 * kmax + 12)


def workspace_floats(kmax: int, height: int, width: int) -> int:
    """Device memory one block works in, in floats (mirrors work_floats in
    the source): the working field, three column profile sets, gy'', the 18
    K^2 pair sums, G^-1 (D^2) and the q coefficient table (Q_COEF floats a
    star pair, in whole chunks of Q_PAIRS), each a multiple of 4."""
    fs, d = field_stride(width), 3 * kmax
    pairs = (kmax * (kmax + 1) // 2 + Q_PAIRS - 1) // Q_PAIRS * Q_PAIRS
    return (height * fs + 3 * kmax * fs + _round4(kmax * (height | 1))
            + _round4(18 * kmax * kmax) + _round4(d * d) + Q_COEF * pairs)


def one_tile(kmax: int, height: int, width: int) -> bool:
    """Whether a launch takes the one-tile path (one_tile in the source):
    H, W <= 128 and K <= 64; beyond it the wide path."""
    return 1 <= kmax <= MAX_STARS and height <= MAX_SIDE and width <= MAX_SIDE


def _vec_floats(kmax: int) -> int:
    return 67 * kmax + 12


def _panel_region(kmax: int) -> int:
    stage = Q_DEPTH * 2 * WIDE_TILE + 2 * Q_PAIRS
    return _round4(max(2 * stage, WIDE_PANEL_LD * (3 * kmax + 1)))


def full_panel(kmax: int) -> bool:
    """Whether the wide path factors the Cholesky's whole 32-column panel
    (D + 1 rows) in shared memory (wide::full_panel in the source): where
    it, the q coefficient ring and the per-star vectors fit, K <= 347.
    Beyond, the panel streams through a region of fixed size."""
    return _panel_region(kmax) + WIDE_RING + _vec_floats(kmax) <= WIDE_SMEM_FLOATS


def wide_region_floats(kmax: int) -> int:
    """The wide path's shared region (wide::region_floats in the source):
    with the whole panel (:func:`full_panel`) the q field's two operand
    stages over a 128 x 128 tile (depth Q_DEPTH, T and X of 128 each, and
    16 floats of row ranges) or the panel by rows (D + 1 rows of
    WIDE_PANEL_LD floats), whichever is larger; beyond, the stages, which
    hold the streamed panel's top block and a row block of WIDE_ROW_BLOCK
    rows; rounded up to 4."""
    if full_panel(kmax):
        return _panel_region(kmax)
    stage = Q_DEPTH * 2 * WIDE_TILE + 2 * Q_PAIRS
    return _round4(max(2 * stage, WIDE_PANEL_LD * (WIDE_PANEL + WIDE_ROW_BLOCK)))


def vectors_in_shared(kmax: int) -> bool:
    """Whether the wide path keeps its 67 floats a star and 12 of per-chain
    scalars in shared memory beside the region and the ring
    (wide::vec_in_smem in the source), K <= 615; beyond, in the block's
    workspace slice."""
    return wide_region_floats(kmax) + WIDE_RING + _vec_floats(kmax) <= WIDE_SMEM_FLOATS


def wide_smem_bytes(kmax: int) -> int:
    """Shared memory one block of the wide path needs (mirrors
    wide::smem_floats in the source), whatever the scene: the region, the
    q coefficient ring and, where they fit, 67 floats a star and 12 of
    per-chain scalars."""
    vec = _vec_floats(kmax) if vectors_in_shared(kmax) else 0
    return 4 * (wide_region_floats(kmax) + WIDE_RING + vec)


def wide_layout(kmax: int, height: int, width: int) -> dict:
    """The wide path's slice (wide::init_layout in the source), offsets in
    floats from the slice's start: the working field, 1/lam ("r1"), gy and
    gy' interleaved at the odd star stride H | 1, gx, gx', gx'', gy'', the 18
    K^2 pair sums, G^-1 (D^2), the q coefficient table (Q_COEF floats a star
    pair, in whole chunks of Q_PAIRS), packed L (D + 1 rows), L^-1 (D^2) and
    the chain's live slots and mask values (2 K); beyond :func:`full_panel`
    the streamed Cholesky's panel rows (D + 1 rows of 32, which L^-1's 16
    column vectors share), and beyond :func:`vectors_in_shared` the
    per-star vectors; each a multiple of 4.  "end" is the slice's size."""
    fs, hp, d = field_stride(width), height | 1, 3 * kmax
    pairs = (kmax * (kmax + 1) // 2 + Q_PAIRS - 1) // Q_PAIRS * Q_PAIRS
    lay = {"r1": height * fs, "gyy": 2 * height * fs}
    lay["gx"] = lay["gyy"] + _round4(2 * kmax * hp)
    lay["gy2"] = lay["gx"] + 3 * kmax * fs
    lay["sraw"] = lay["gy2"] + _round4(kmax * hp)
    lay["ginv"] = lay["sraw"] + _round4(18 * kmax * kmax)
    lay["qcoef"] = lay["ginv"] + _round4(d * d)
    lay["dense"] = lay["qcoef"] + Q_COEF * pairs
    lay["linv"] = lay["dense"] + _round4((d + 1) * (d + 2) // 2)
    lay["live"] = lay["linv"] + _round4(d * d)
    lay["end"] = lay["live"] + _round4(2 * kmax)
    if not full_panel(kmax):
        lay["end"] += WIDE_PANEL * (d + 1)
    if not vectors_in_shared(kmax):
        lay["end"] += _round4(_vec_floats(kmax))
    return lay


def wide_workspace_floats(kmax: int, height: int, width: int) -> int:
    """Device memory one block of the wide path works in, in floats
    (mirrors wide::work_floats in the source, 64-bit): the end of
    :func:`wide_layout`."""
    return wide_layout(kmax, height, width)["end"]


def wide_fields_in_32_bits(kmax: int, height: int, width: int) -> bool:
    """Whether the wide path's fields and profiles, which its passes address
    in 32 bits from the slice's start, end below 2^31 floats
    (wide::fields_in_32_bits in the source): 2 H W + 3 K (H + W) floats in
    all, rounded up, a field of up to about 10^9 pixels."""
    return wide_layout(kmax, height, width)["sraw"] <= INT32_MAX


def probe_offsets(kmax: int, height: int, width: int) -> tuple[int, ...]:
    """The offsets, in floats from the workspace's start, at which the
    address probe's corners (PROBE_CORNERS) lie in block 0's slice, by
    exact integer arithmetic on :func:`wide_layout`."""
    lay = {k: HEADER_FLOATS + v for k, v in wide_layout(kmax, height, width).items()}
    d = 3 * kmax
    pairs = (kmax * (kmax + 1) // 2 + Q_PAIRS - 1) // Q_PAIRS * Q_PAIRS
    # packed L by columns of d + 1 rows: column c starts at c (d + 1) - c (c - 1) / 2
    last_col = lay["dense"] + (d - 1) * (d + 1) - (d - 1) * (d - 2) // 2 - (d - 1)
    return (lay["sraw"], lay["sraw"] + 18 * kmax * kmax - 1, lay["dense"], last_col + d,
            last_col + d - 1, lay["linv"], lay["linv"] + d * d - 1, lay["ginv"],
            lay["ginv"] + d * d - 1, lay["qcoef"], lay["qcoef"] + Q_COEF * pairs - 1)


def launch_smem_bytes(kmax: int, height: int, width: int) -> int:
    """Shared memory a block of the launch's path takes."""
    if one_tile(kmax, height, width):
        return smem_bytes(kmax, height, width)
    return wide_smem_bytes(kmax)


def launch_workspace_floats(kmax: int, height: int, width: int) -> int:
    """A block's workspace slice on the launch's path, in floats."""
    if one_tile(kmax, height, width):
        return workspace_floats(kmax, height, width)
    return wide_workspace_floats(kmax, height, width)


def workspace_bytes(kmax: int, height: int, width: int, blocks: int = 1) -> int:
    """The workspace a launch of ``blocks`` blocks takes: the header and a
    slice a block, on the launch's path."""
    return 4 * (HEADER_FLOATS + blocks * launch_workspace_floats(kmax, height, width))


def domain_error(spec: SceneSpec, kmax: int) -> str | None:
    """Why the kernel does not take this scene and catalog, or None: it
    takes every scene and K >= 1 (past the card's memory, the workspace's
    allocation raises)."""
    if kmax < 1:
        return f"the crowded-field CUDA full-Fisher trajectory (B6c) takes K >= 1, got K={kmax}"
    return None


def check_domain(spec: SceneSpec, kmax: int) -> None:
    """Raise unless the kernel takes this scene and catalog capacity."""
    err = domain_error(spec, kmax)
    if err is not None:
        raise ValueError(err)


@functools.cache
def _library_layout(device_index: int, kmax: int, height: int, width: int) -> dict:
    """The build's threads a block and blocks an SM on this card, once the
    build's own sizes are found equal to this module's mirrors."""
    from .build import query_layout

    lib = riemannian_library("fused_rhmc_crowded")
    fn = lib.starcat_fused_rhmc_crowded_sizes
    ci, cll = ctypes.c_int, ctypes.c_int64
    fn.argtypes = [ci] * 3 + [ctypes.POINTER(ci), ctypes.POINTER(cll)]
    fn.restype = ci
    lib.starcat_fused_rhmc_crowded_one_tile.argtypes = [ci] * 3
    lib.starcat_fused_rhmc_crowded_one_tile.restype = ci
    lib.starcat_fused_rhmc_crowded_wide_mode.argtypes = [ci]
    lib.starcat_fused_rhmc_crowded_wide_mode.restype = ci
    smem, work = ci(), cll()
    want = (int(one_tile(kmax, height, width)), launch_smem_bytes(kmax, height, width),
            launch_workspace_floats(kmax, height, width),
            int(full_panel(kmax)) | 2 * int(vectors_in_shared(kmax)))
    with torch.cuda.device(device_index):
        rc = fn(kmax, height, width, ctypes.byref(smem), ctypes.byref(work))
        if rc != 0:
            raise RuntimeError(f"starcat_fused_rhmc_crowded_sizes failed ({rc})")
        got = (lib.starcat_fused_rhmc_crowded_one_tile(kmax, height, width), smem.value,
               work.value, lib.starcat_fused_rhmc_crowded_wide_mode(kmax))
        if got != want:
            raise RuntimeError(
                f"B6c's build takes (one-tile path, shared bytes, workspace floats a block, "
                f"wide mode) {got}; fused_rhmc_crowded.py says {want}")
        lay = query_layout(lib, "starcat_fused_rhmc_crowded_layout", 1, kmax, height, width)
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return dict(threads=lay["threads"], blocks_per_sm=lay["blocks_per_sm"], sms=sms)


def memory_grid(kmax: int, height: int, width: int, free_bytes: int) -> int:
    """The most blocks whose workspace slices take at most WORKSPACE_SHARE
    of ``free_bytes``, and at least 1 (whose allocation then raises where
    one slice does not fit)."""
    slice_bytes = 4 * launch_workspace_floats(kmax, height, width)
    return max(1, int(WORKSPACE_SHARE * free_bytes) // slice_bytes)


def largest_kmax(height: int, width: int, free_bytes: int) -> int:
    """The largest K whose one-block workspace (:func:`workspace_bytes`)
    fits ``free_bytes`` on an H x W scene (0 where none does): the most
    slots one chain of the full metric can take on a card with that much
    free memory."""
    lo, hi = 0, 1
    while workspace_bytes(hi, height, width, 1) <= free_bytes:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if workspace_bytes(mid, height, width, 1) <= free_bytes else (lo, mid)
    return lo


def launch_layout(c: int, kmax: int, height: int, width: int, device=None) -> dict:
    """How the kernel lays out a launch of c chains on the card: threads a
    block, the blocks an SM holds, the grid (at most the SMs times that,
    and at most memory_grid over the memory the card has free now, the
    CUDA driver's free memory and the allocator's cached blocks), its blocks
    taking the chains from the workspace's counter, the chains a block
    takes on average, rounded up, and the workspace's bytes."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    lay = _library_layout(index, kmax, height, width)
    free = (torch.cuda.mem_get_info(index)[0] + torch.cuda.memory_reserved(index)
            - torch.cuda.memory_allocated(index))
    grid = min(c, lay["blocks_per_sm"] * lay["sms"], memory_grid(kmax, height, width, free))
    if grid < 1:
        raise RuntimeError(f"B6c fits no block on this card ({lay})")
    return dict(threads=lay["threads"], blocks_per_sm=lay["blocks_per_sm"], grid=grid,
                chains_per_block=-(-c // grid),
                workspace_bytes=workspace_bytes(kmax, height, width, grid))


def make_fused_rhmc(spec: SceneSpec, image: torch.Tensor, prior: PriorSpec,
                    kmax: int, n_steps: int, fixed_point_iters: int = 6,
                    jitter: float = 1e-3):
    """B6's contract on B6c: fused(theta, xi, eps, mask, beta=1.0) ->
    (theta', p', h0, h1, u1, resid), one launch per call on a CUDA device."""
    if int(n_steps) < 0 or int(fixed_point_iters) < 0:
        raise ValueError(f"n_steps and fixed_point_iters must be >= 0, got "
                         f"{n_steps} and {fixed_point_iters}")
    n_steps, fpi = int(n_steps), int(fixed_point_iters)
    image = image.to(torch.float32).contiguous()
    if tuple(image.shape) != (spec.height, spec.width):
        raise ValueError(f"image must be ({spec.height}, {spec.width}), "
                         f"got {tuple(image.shape)}")
    if image.device.type == "cuda":
        check_domain(spec, kmax)
    scalars = riemannian_scalars(spec, prior, jitter)

    def fused(theta, xi, eps, mask, beta=1.0):
        global LAUNCHES
        if theta.device.type == "cpu":
            return fused_rhmc_reference(spec, image.to(theta.device), prior, theta,
                                        xi, eps, mask, beta, n_steps, fpi, jitter)
        if theta.device.type != "cuda":
            raise ValueError(f"no fused RHMC trajectory for device {theta.device}")
        if theta.ndim != 3 or theta.shape[0] < 1:
            raise ValueError(f"theta must be (C, {kmax}, 3) with C >= 1, "
                             f"got {tuple(theta.shape)}")
        lay = launch_layout(theta.shape[0], kmax, spec.height, spec.width, theta.device)
        work = torch.empty(lay["workspace_bytes"] // 4, dtype=torch.float32,
                           device=theta.device)
        work[:HEADER_FLOATS].zero_()  # the chain counter
        if not wide_fields_in_32_bits(kmax, spec.height, spec.width) and not one_tile(
                kmax, spec.height, spec.width):
            raise ValueError(f"B6c's wide path addresses a slice's fields in 32 bits: "
                             f"{spec.height}x{spec.width} at K={kmax} passes them")
        out = launch_riemannian("fused_rhmc_crowded", image, kmax, n_steps, fpi, scalars,
                                theta, xi, eps, mask, beta, workspace=(work, lay["grid"]))
        LAUNCHES += 1
        return out

    return fused


def address_probe(kmax: int, height: int, width: int, device=None) -> dict:
    """The wide path's addressing at K slots on an H x W scene, on the card:
    a workspace of one block's slice is allocated (after _library_layout
    holds the build's sizes to this module's mirrors at that K), the
    probe's corners (PROBE_CORNERS) set to NaN at their exact offsets
    (:func:`probe_offsets`), then one block of
    starcat_fused_rhmc_crowded_addr_probe writes a sentinel -(n + 1) at
    corner n through the kernel's own index helpers and returns the 64-bit
    offsets it took.  Returns each corner's offset, the exact one and the
    value read back at the returned offset (None outside the workspace),
    the slice's bytes and "ok": every offset exact and every sentinel read
    back."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    dev = torch.device("cuda", index)
    _library_layout(index, kmax, height, width)
    lib = riemannian_library("fused_rhmc_crowded")
    fn = lib.starcat_fused_rhmc_crowded_addr_probe
    ci, vp = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [ci] * 3 + [vp] * 3
    fn.restype = ci
    lib.starcat_fused_rhmc_crowded_probe_corners.restype = ci
    if lib.starcat_fused_rhmc_crowded_probe_corners() != len(PROBE_CORNERS):
        raise RuntimeError("B6c's build probes another number of corners than PROBE_CORNERS")
    want = probe_offsets(kmax, height, width)
    work = torch.empty(workspace_bytes(kmax, height, width, 1) // 4, dtype=torch.float32,
                       device=dev)
    work[torch.tensor(want, dtype=torch.int64, device=dev)] = float("nan")
    offsets = torch.full((len(want),), -1, dtype=torch.int64, device=dev)
    with torch.cuda.device(index):
        rc = fn(kmax, height, width, work.data_ptr(), offsets.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"starcat_fused_rhmc_crowded_addr_probe failed ({rc}): "
                           f"{lib.starcat_cuda_error_string(rc).decode()}")
    got = offsets.tolist()
    inside = [0 <= g < work.numel() for g in got]
    read = work[torch.tensor([g if ok else 0 for g, ok in zip(got, inside)],
                             device=dev)].tolist()
    corners = [dict(name=name, offset=g, exact=w, value=v if ok else None,
                    ok=g == w and ok and v == -(n + 1))
               for n, (name, g, w, v, ok) in enumerate(zip(PROBE_CORNERS, got, want, read,
                                                          inside))]
    return dict(kmax=kmax, height=height, width=width, slice_bytes=4 * work.numel() - 4 *
                HEADER_FLOATS, corners=corners, ok=all(c["ok"] for c in corners))
