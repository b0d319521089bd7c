"""Chain-sharded runs over ``torch.distributed`` (port of starcat/dist.py).

The reference shards the chain (or particle) axis with GSPMD: one program,
a device mesh, and the chain-pooled reductions turned into collectives.
Here one process runs per device, each holding a contiguous shard of C / W
chains (W = world size), and a :class:`Mesh` names its shard.

Usage, one process per device (``torchrun --nproc_per_node=N`` or explicit
arguments)::

    init_distributed(device="cuda")            # NCCL on CUDA, gloo on the CPU
    out = api.sample(cfg, device, mesh=make_mesh("cuda"))

A sharded run gives the same bits as the one-process run, chain for chain:

- every rank draws each random tensor at full width from the run's one
  generator, seeded as in one process, and keeps its rows (:func:`shard`),
  so the generators stay in step and every chain sees its own draws;
- a chain's transition is computed on its rank alone: the kernels run a
  chain a warp or a block a chain, and the plain torch path is batched
  over chains;
- every pooled statistic (the mean acceptance of dual averaging, the
  Welford moments, ChEES's criterion, SMC's weights, log Z, resampling
  and step-size controller, NUTS's "any chain still building") reduces the
  gathered full tensor (:func:`gather`) with the op the one-process code
  uses, never an ``all_reduce`` of partial sums, which would reorder the
  float sums;
- checkpoints hold the gathered full state, written by rank 0
  (checkpoint.save_state), so a checkpoint written under any world size
  resumes under any other.

Not ported: the reference's ``make_pixel_sharded_loglik`` (an H100 holds a
128x128 scene whole) and ``constrain_chains`` (a jit-time constraint).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as tdist


def init_distributed(device, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> bool:
    """Start the process group: NCCL for a CUDA device, gloo for the CPU.

    World size and rank come from the arguments or else from torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``
    through ``init_method="env://"``).  A CUDA process takes the card
    ``LOCAL_RANK`` (default: its rank) as its current device.  A single
    process with no ``init_method`` starts nothing (returns False); an
    explicit ``init_method`` starts even a group of one."""
    world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              if device.index is None else device.index)
    tdist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                             init_method=init_method or "env://",
                             world_size=world, rank=rank)
    return True


@dataclass(frozen=True)
class Mesh:
    """This process's place on the chain axis: its rank, the world size and
    its device.  Rank r holds chains [r C / W, (r + 1) C / W)."""

    rank: int
    world: int
    device: torch.device

    def local(self, n: int) -> slice:
        """This rank's rows of an axis of n (chains or particles)."""
        if n % self.world:
            raise ValueError(f"{n} chains/particles do not split over {self.world} "
                             "devices; choose a multiple of the world size")
        m = n // self.world
        return slice(self.rank * m, (self.rank + 1) * m)


def make_mesh(device=None) -> Mesh:
    """The mesh of the started process group (init_distributed): every rank
    on one chain axis.  ``device`` defaults to the current CUDA device under
    NCCL and to the CPU under gloo."""
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if tdist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(tdist.get_rank(), tdist.get_world_size(), torch.device(device))


def n_global(n_local: int, mesh: Mesh | None) -> int:
    """The full length of a chain axis of which this rank holds n_local."""
    return n_local if mesh is None else n_local * mesh.world


def draw(fn, n_local: int, mesh: Mesh | None):
    """The random inputs of this rank's n_local chains.  ``fn(n)`` draws a
    tree of tensors for n chains, chain axis leading, from the run's
    generator; under a mesh it is called at the full width and this rank
    keeps its rows, so every rank's generator stays in step and each chain
    gets the draws it gets in one process.  Every per-step draw of a head
    goes through here; the draws sized by a config's full count (the
    initial chains and particles, SMC's step draws, whose resampling
    uniform every rank shares) are made at that count and passed to
    :func:`shard`."""
    return shard(fn(n_global(n_local, mesh)), mesh)


def _map(fn, tree):
    """fn over the tensors of a tree of tuples and NamedTuples; other
    leaves (None, ints, floats, generators) pass as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def shard(tree, mesh: Mesh | None):
    """This rank's rows of the leading (chain/particle) axis of every tensor
    in ``tree``; 0-d tensors are replicated.  Identity without a mesh."""
    if mesh is None:
        return tree
    return _map(lambda x: x if x.ndim == 0 else x[mesh.local(x.shape[0])], tree)


def _gather(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 0:
        return x
    # NCCL and gloo move bytes, not bools
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, y)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather(tree, mesh: Mesh | None):
    """The full tensors, on every rank: the ranks' shards of the leading
    axis of every tensor in ``tree`` concatenated in rank order (0-d
    tensors are replicated and pass).  Identity without a mesh."""
    if mesh is None:
        return tree
    return _map(_gather, tree)


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (no-op without a mesh)."""
    if mesh is not None:
        tdist.barrier()
