"""Readings for the limits: one process sets a cell up once, then for each
seed runs a short window at the cell's own size and reads every number
the check compares, for the program and for the control (the reference
computed in bfloat16 in the program's place).  One JSON line a seed.

    python benchmark/control.py --workload <name> --seconds 5 --seeds 1 2 3 ...

``--fault unadapted`` plants a fault first (FAULTS below) and reads the
program's numbers under it; ``--set key=value`` (value in JSON) overrides
a key of the traffic file, e.g. the warm-up's seed or the chain count, for
readings of the set-up's adaptation; ``--rehearse`` runs it on the CPU at
the traffic file's rehearsal size."""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _unadapted(head) -> None:
    head.unadapt()


# planted faults whose readings set a number's upper end, by name
FAULTS = {"unadapted": _unadapted}


def readings(workload: str, seeds: list[int], seconds: float, device, overrides=None,
             fault: str | None = None):
    """Yield (seed, program numbers, control numbers, notes) for each seed."""
    from benchmark import core

    cell = core.load_cell(workload)
    head = importlib.import_module(f"benchmark.heads.{cell['traffic_data']['head']}").Head(
        cell, seeds[0], device, overrides)
    head.setup()
    if fault is not None:
        FAULTS[fault](head)
    for seed in seeds:
        head.seed = seed
        head.gen.manual_seed(seed)
        if head.name == "smc":
            head.state = head._fresh(head.gen)
        head.window(seconds, lambda name: contextlib.nullcontext())
        prog = head.check(control=True)
        notes = dict(head.check_notes)
        yield seed, prog, notes.pop("control"), {**notes, "counters": head.counters,
                                                 "adapted": getattr(head, "adapted", None)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--rehearse", action="store_true")
    a = ap.parse_args()
    if a.rehearse:
        from benchmark import core

        device = torch.device("cpu")
        overrides = core.load_cell(a.workload)["traffic_data"].get("rehearsal", {})
    else:
        if not torch.cuda.is_available():
            raise SystemExit("control: no CUDA device")
        device, overrides = torch.device("cuda", 0), {}
    overrides = {**overrides, **{k: json.loads(v) for k, v in (x.split("=", 1) for x in a.set)}}
    t0 = time.perf_counter()
    for seed, prog, ctrl, notes in readings(a.workload, a.seeds, a.seconds, device, overrides,
                                            a.fault):
        print(json.dumps({"workload": a.workload, "seed": seed, "fault": a.fault,
                          "set": a.set, "program": prog, "control": ctrl, "notes": notes,
                          "t": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
