"""Run one cell of BENCHMARK.json once on the card and print its result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel libraries from build/kernels, the mock scene,
the head's warm-up) is timed from the process's start; then the head's own
loop runs for ``--seconds``; then the window's output is held against the
plain reference and the last line of standard output is one JSON object:
correct, attempted, failed, metrics (trace 0: the cell's end-to-end
metrics; trace 1: its per-layer metrics, read from a profiler trace of the
window), device, with trace 1 breakdown, and last the numbers compared
with their limits, which also end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; if, once the check and every metric
reader have run, the process holds jax, jaxlib, flax or the JAX package
starcat (top-level names compared whole), it exits with code 4, naming
them, and prints no result; ``--rehearse`` runs the cell instead on
the CPU at the traffic file's rehearsal size and reports only on standard
error (no device metric comes from the CPU).
"""
from __future__ import annotations

import time

T_TOP = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), 0 where unknown."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE = _process_age()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)


class Run:
    """What a metric reader sees: the head after its window, its counters and
    operation counts, the set-up and window seconds, and the trace (or None)."""

    def __init__(self, head, setup_s: float, window_s: float, trace):
        self.head, self.setup_s, self.window_s, self.trace = head, setup_s, window_s, trace
        self.counters, self.ops = head.counters, head.ops
        self.kernel = getattr(head, "kernel", None)
        self._ess = None

    def ess(self) -> float:
        if self._ess is None:
            self._ess = self.head.ess()
        return self._ess


def _fail(code: int, msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the traffic file's rehearsal size; no result line")
    args = ap.parse_args(argv)

    try:
        from benchmark import core
        import torch
    except ImportError as e:
        _fail(3, f"cannot import the harness: {e}")
    try:
        cell = core.load_cell(args.workload)
    except FileNotFoundError as e:
        _fail(3, f"the checkout is incomplete: {e}")
    if args.rehearse:
        device, overrides = torch.device("cpu"), cell["traffic_data"].get("rehearsal", {})
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            _fail(2, f"{cell['chips']} CUDA device(s) needed, "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        device, overrides = torch.device("cuda", 0), {}
    try:
        importlib.import_module("starcat_torch")
    except ImportError as e:
        _fail(3, f"the program (starcat_torch) is not in the checkout: {e}")

    head = importlib.import_module(f"benchmark.heads.{cell['traffic_data']['head']}").Head(
        cell, args.seed, device, overrides)
    head.setup()
    setup_s = AGE + time.perf_counter() - T_TOP
    seconds = args.seconds
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        seconds = min(seconds, float(head.tr.get("trace_seconds") or seconds))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                window_s = head.window(seconds, record_function)
    else:
        window_s = head.window(seconds, lambda name: contextlib.nullcontext())
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace = core.reduce_profile(prof, "bench.window") if prof is not None else None
    prof = None
    attempted, failed = head.attempted_failed()
    run = Run(head, setup_s, window_s, trace)
    t_read = time.perf_counter()
    metrics = {}
    for m in cell["metrics"][args.trace]:
        value = core.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    head.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = head.check()
    t_done = time.perf_counter()
    checks = [{"name": k, "value": v, "limit": cell["limits"][k]} for k, v in numbers.items()]
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks)
    # after every reader and the check, right before anything is reported
    found = core.forbidden_modules()
    if found:
        _fail(4, f"the run loaded {', '.join(found)} (the JAX package or JAX)")
    print(json.dumps({"workload": args.workload, "seed": args.seed, "counters": head.counters,
                      "adapted": getattr(head, "adapted", None), "check": head.check_notes,
                      "seconds": {"setup": setup_s, "window": window_s,
                                  "readers": t_check - t_read, "check": t_done - t_check,
                                  "process": AGE + t_done - T_TOP}}),
          file=sys.stderr)
    if args.rehearse:
        print(json.dumps({"rehearsal": "cpu, not a device measurement", "correct": correct,
                          "attempted": attempted, "failed": failed,
                          "host_numbers": {k: v["value"] for k, v in metrics.items()}}),
              file=sys.stderr)
    for line in core.check_lines(checks):
        print(line, file=sys.stderr)
    if args.rehearse:
        return 0 if correct else 1
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": core.device_entry(trace, memory_peak, cell["chips"])}
    if trace is not None:
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
