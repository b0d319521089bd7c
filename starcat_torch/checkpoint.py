"""Checkpoint / resume (port of starcat/checkpoint.py): ``torch.save`` of a
sampler's state and the run generator's state, in place of orbax.

A checkpoint is a NamedTuple (``driver.BlockCheckpoint``,
``chees.ChEESBlockCheckpoint``, ``transdim_mcmc.TDBlockCheckpoint``,
``smc.SMCCheckpoint``) whose fields are tensors, ints, nested NamedTuples
(the chain or population state) and the run's ``torch.Generator``.  On
disk it is a plain dict of tensors, ints and strings under dotted keys
(``states.theta``, ``done``, ``generator``, ``generator.device``), so
``torch.load(weights_only=True)`` reads it with no class allow-listed.

The reference keeps its PRNG keys inside the state; the port draws every
random number of a run from one generator, so the generator's state is
saved with the chains and restored onto the run's own generator object (the
heads and the relocate move close over it): that is what makes a resume give
the same bits as an uninterrupted run.

A save writes ``path + ".tmp"`` and renames it over ``path`` with
``os.replace``, so a process killed during a save leaves the previous
checkpoint whole, never a half-written one.

Under a device mesh (dist.py) the heads pass the gathered full state:
rank 0 writes it and every rank waits at a barrier, so the file is the one
a single process writes, and on resume every rank reads it whole and takes
its own chains.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from . import dist


class CheckpointError(RuntimeError):
    """A checkpoint that does not load or does not fit the run."""


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """NamedTuple (nested) -> {dotted key: leaf}."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out: dict[str, Any] = {}
        for name, value in zip(tree._fields, tree):
            out.update(_flatten(value, f"{prefix}{name}."))
        return out
    return {prefix[:-1]: tree}


def _rebuild(like, flat: dict[str, Any], prefix: str = ""):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, flat, f"{prefix}{n}.")
                            for n, v in zip(like._fields, like)))
    return flat[prefix[:-1]]


def _to_disk(flat: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, leaf in flat.items():
        if isinstance(leaf, torch.Generator):
            out[key] = leaf.get_state()
            out[key + ".device"] = leaf.device.type
        elif isinstance(leaf, torch.Tensor):
            out[key] = leaf.detach().cpu()
        elif isinstance(leaf, int):
            out[key] = int(leaf)
        else:
            raise TypeError(f"checkpoint field {key!r}: cannot save a {type(leaf).__name__}")
    return out


def save_state(path: str, payload, mesh=None) -> None:
    """Write ``payload`` (a checkpoint NamedTuple) to ``path`` atomically;
    with a ``mesh`` (dist.Mesh), rank 0 writes and every rank waits."""
    if mesh is not None:
        if mesh.rank == 0:
            save_state(path, payload)
        dist.barrier(mesh)
        return
    path = os.path.abspath(os.fspath(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        torch.save(_to_disk(_flatten(payload)), fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def restore_state(path: str, like, device):
    """Read a checkpoint written by :func:`save_state` into the structure of
    ``like`` (a checkpoint of the same run's shapes, e.g. one built from a
    fresh state).  Tensors go to ``device`` (the generator's state stays a
    CPU byte tensor); the generator field of ``like`` gets the saved state
    and is returned as it is.

    Raises :class:`CheckpointError`, naming the path, for a file that does
    not load, keys, shapes or dtypes that differ from ``like``'s, and a
    generator state of another device type than ``like``'s generator."""
    path = os.path.abspath(os.fspath(path))
    try:
        disk = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 — any failure to read is reported with the path
        raise CheckpointError(f"checkpoint {path!r} does not load: {e!r}") from e
    if not isinstance(disk, dict):
        raise CheckpointError(f"checkpoint {path!r} holds a {type(disk).__name__}, "
                              "not a checkpoint dict")
    want = _to_disk(_flatten(like))
    if set(disk) != set(want):
        raise CheckpointError(
            f"checkpoint {path!r} does not fit this run: keys missing "
            f"{sorted(set(want) - set(disk))}, unexpected {sorted(set(disk) - set(want))}")
    gens = {k: g for k, g in _flatten(like).items() if isinstance(g, torch.Generator)}
    for key in gens:
        if disk[key + ".device"] != want[key + ".device"]:
            raise CheckpointError(
                f"checkpoint {path!r} holds a {disk[key + '.device']} generator state; "
                f"this run's generator is on {want[key + '.device']}")
    flat: dict[str, Any] = {}
    for key, ref in want.items():
        got = disk[key]
        if key.endswith(".device") and key[:-len(".device")] in gens:
            continue
        if isinstance(ref, torch.Tensor):
            if (not isinstance(got, torch.Tensor) or got.shape != ref.shape
                    or got.dtype != ref.dtype):
                what = (f"{tuple(got.shape)} {got.dtype}" if isinstance(got, torch.Tensor)
                        else type(got).__name__)
                raise CheckpointError(
                    f"checkpoint {path!r}: {key!r} is {what}, this run needs "
                    f"{tuple(ref.shape)} {ref.dtype}")
            flat[key] = got if key in gens else got.to(device)
        elif not isinstance(got, int):
            raise CheckpointError(f"checkpoint {path!r}: {key!r} is a "
                                  f"{type(got).__name__}, this run needs an int")
        else:
            flat[key] = got
    for key, gen in gens.items():
        gen.set_state(flat[key])
        flat[key] = gen
    return _rebuild(like, flat)
