"""The program's spans and counters in a benchmark cell, and what recording
them costs, on the card.

    python scripts/trace_cells.py [--workload crowded.smc ...] [--seed N]
                                  [--seconds 20] [--repeats 3]
                                  [--trace-seconds 10] [--rehearse]

For each cell of BENCHMARK.json named: the cell's head is set up as
``benchmark/run.py`` sets it up, then its window runs ``--repeats`` times
with ``starcat_torch.metrics.tracing()`` off and as often with it on, in
turns (off, on, on, off, off, on), each from the same state and generator,
so every window does the same work; no profiler runs.  Then one window
runs under ``torch.profiler``.  One JSON line a cell (also appended to
``chiprun_out/trace_cells.jsonl``):

- ``rate_off`` / ``rate_on``: the cell's rate (draws or particle-steps a
  second) of each window, and ``cost``: median on / median off - 1;
- ``spans``: from the traced windows without the profiler, per span name
  its count and host and device ms per unit (temperature step or ChEES
  iteration), and ``counters`` per unit;
- ``children_cover``: for each ``smc.step``, the device ms of its child
  spans over its own device ms (smallest, median);
- ``profiled``: from the profiled window, the cell's trajectory kernel's
  time per unit (by its CUDA symbol) beside the device ms per unit of the
  span that launches it (``smc.mutate`` or ``chees.trajectory``), and any
  span name found among the device's kernels (none expected).

``--rehearse`` runs on the CPU at the traffic files' rehearsal sizes: a
check of the script, not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

from profile_torch import span_table

ROOT = Path(__file__).resolve().parents[1]
WINDOW = "trace_cells.window"


def summary(rec: dict, unit: str) -> dict:
    spans = rec["spans"]
    n = max(sum(s["name"] == unit for s in spans), 1)
    out = {"units": n,
           "spans": {k: {"n": v["n"], "host_ms_per_unit": v["host_ms"] / n,
                         "device_ms_per_unit": v["device_ms"] / n}
                     for k, v in span_table(rec).items()},
           "counters": {k: v / n for k, v in rec["counters"].items()}}
    if unit == "smc.step":
        cover = []
        for i, s in enumerate(spans):
            if s["name"] == unit and s.get("device_ms"):
                kids = sum(c.get("device_ms") or 0.0 for c in spans if c["parent"] == i)
                cover.append(kids / s["device_ms"])
        if cover:
            out["children_cover"] = [min(cover), statistics.median(cover)]
    return out


def run_cell(name: str, seed: int, seconds: float, repeats: int, trace_seconds: float,
             rehearse: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import core
    from starcat_torch import metrics

    cell = core.load_cell(name)
    tr = cell["traffic_data"]
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    head = importlib.import_module(f"benchmark.heads.{tr['head']}").Head(cell, seed, dev, tr.get("rehearsal") if rehearse else None)
    t0 = time.perf_counter()
    head.setup()
    setup_s = time.perf_counter() - t0
    smc = tr["head"] == "smc"
    unit, done_key = ("smc.step", "particle_steps") if smc else ("chees.iteration", "draws")
    launcher = "smc.mutate" if smc else "chees.trajectory"
    g0 = head.gen.get_state()
    start = head.state if smc else (head.states, head.done)

    def window(secs, on: bool, span=lambda n: contextlib.nullcontext()):
        head.gen.set_state(g0)
        if smc:
            head.state = start
        else:
            head.states, head.done = start
        metrics.reset_record()
        with metrics.tracing() if on else contextlib.nullcontext():
            w = head.window(secs, span)
        return head.counters[done_key] / w

    rates = {False: [], True: []}
    traced = []
    for on in [False, True, True, False, False, True][: 2 * repeats]:
        rates[on].append(window(seconds, on))
        if on:
            traced.append(summary(metrics.record(), unit))
    metrics.reset_record()
    head.gen.set_state(g0)
    acts = [ProfilerActivity.CPU] + ([] if rehearse else [ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            window(trace_seconds, False, record_function)
    trace = core.reduce_profile(prof, WINDOW)
    prof = None
    rec = metrics.record()
    n = sum(s["name"] == unit for s in rec["spans"])
    names = {s["name"] for s in rec["spans"]} | {WINDOW}
    launch_ms = sum(s.get("device_ms") or 0.0 for s in rec["spans"] if s["name"] == launcher)
    kernel = head.kernel
    symbol = core.KERNEL_SYMBOLS.get(kernel)
    out = {
        "workload": name, "seed": seed,
        "device": "cpu rehearsal, not a measurement" if rehearse else torch.cuda.get_device_name(0),
        "setup_s": setup_s, "seconds": seconds, "kernel": kernel,
        "rate_off": rates[False], "rate_on": rates[True],
        "cost": statistics.median(rates[True]) / statistics.median(rates[False]) - 1.0,
        "traced": traced,
        "profiled": {
            "units": n,
            "kernel_ms_per_unit": symbol and 1e3 * trace.kernel_s(symbol) / max(n, 1),
            f"{launcher}_device_ms_per_unit": launch_ms / max(n, 1),
            "aten_calls_per_unit": trace.aten_calls / max(n, 1),
            "busy_share": trace.union_s() / trace.window_s,
            "span_names_in_device_ops": sorted({k for k, _, _ in trace.kernels if k in names}),
            "summary": summary(rec, unit),
        },
    }
    head.free()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+",
                    default=["flagship.chees", "crowded.smc", "flagship.smc"])
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--repeats", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--trace-seconds", type=float, default=10.0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        raise SystemExit("trace_cells: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    for name in args.workload:
        line = json.dumps(run_cell(name, args.seed, args.seconds, args.repeats,
                                   args.trace_seconds, args.rehearse))
        print(line, flush=True)
        if not args.rehearse:
            with open(outdir / "trace_cells.jsonl", "a") as fh:
                fh.write(line + "\n")
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
