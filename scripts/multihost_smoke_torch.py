"""Multi-process smoke test of starcat_torch's device mesh (the twin of
scripts/multihost_smoke.py): the torch.distributed init, one all_reduce and
one all_gather across the ranks, and one short chain-sharded ``sample``
held bit for bit against the one-process run on rank 0.

Launch it once per process, with a rendezvous all of them can reach:

    python scripts/multihost_smoke_torch.py --world-size 2 --rank 0 \\
        --init-method file://$PWD/build/rdv &
    python scripts/multihost_smoke_torch.py --world-size 2 --rank 1 \\
        --init-method file://$PWD/build/rdv

or through torchrun, which sets the rank and world size:

    torchrun --nproc_per_node=2 scripts/multihost_smoke_torch.py

``--device cuda`` (the default) runs NCCL, one card a rank; ``--device cpu``
runs gloo on the CPU.  Each rank prints one JSON line; exit code 0 on every rank means the
collectives work and the sharded run equals the one-process run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (file://... or tcp://localhost:PORT); "
                         "default: torchrun's environment")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="cfg0_single_star")
    ap.add_argument("overrides", nargs="*", default=["head=hmc", "n_warmup=30", "n_samples=20"])
    args = ap.parse_args(argv)

    import torch.distributed as tdist

    from starcat_torch import api, dist
    from starcat_torch.configs import CONFIGS, apply_overrides

    torch.set_num_threads(1)
    if not dist.init_distributed(args.device, init_method=args.init_method or "env://",
                                 world_size=args.world_size, rank=args.rank):
        raise SystemExit("no process group started")
    mesh = dist.make_mesh()
    world, rank = mesh.world, mesh.rank

    x = torch.tensor([float(rank)], device=mesh.device)
    tdist.all_reduce(x)
    reduce_ok = float(x) == sum(range(world))
    gathered = dist.gather(torch.full((2,), float(rank), device=mesh.device), mesh)
    gather_ok = gathered.tolist() == [float(r) for r in range(world) for _ in range(2)]

    overrides = dict(kv.split("=", 1) for kv in args.overrides)
    overrides.setdefault("n_chains", str(2 * world))
    cfg = apply_overrides(CONFIGS[args.config], overrides)
    sharded = api.sample(cfg, mesh.device, seed=1, mesh=mesh)
    same = None
    if rank == 0:
        single = api.sample(cfg, mesh.device, seed=1)
        same = bool(np.array_equal(sharded.thetas, single.thetas)
                    and np.array_equal(sharded.masks, single.masks))
    dist.barrier(mesh)
    ok = reduce_ok and gather_ok and same is not False
    print(json.dumps({"rank": rank, "world": world, "device": str(mesh.device),
                      "backend": tdist.get_backend(), "all_reduce": reduce_ok,
                      "all_gather": gather_ok, "n_chains": cfg.n_chains,
                      "sharded_equals_one_process": same, "ok": ok}))
    tdist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
