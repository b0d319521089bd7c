"""Metrics, logging and tracing (port of starcat/metrics.py).

``MetricsLogger`` appends one JSON record a line, ``{"t", "run", "event",
...scalars}``, the reference's layout: per warmup phase, per sampling block,
per SMC temperature step, per ADVI window and one at the end of a run.  The
heads read their records back once a block, phase or step, never inside a
transition.  ``timed`` wall-clocks a block of work that ends in a device
sync; ``profile_trace`` wraps ``torch.profiler`` and writes a Chrome trace.

Not ported: the reference's ``cost_analysis`` (XLA's cost model with TPU
peaks); ``chip_smoke.py`` computes the port's kernel bounds.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    """Append-only JSONL metrics sink; a no-op on ranks other than 0 and
    for ``path=None``."""

    def __init__(self, path: str | None, run_name: str = "run"):
        self.run_name = run_name
        self._fh = None
        if path is not None and _rank() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **scalars: Any) -> None:
        if self._fh is None:
            return
        rec = {"t": time.time(), "run": self.run_name, "event": event}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def timed(logger: MetricsLogger | None, event: str, device=None, **extra):
    """Wall-clock a block, synchronizing ``device`` at exit when it is a
    CUDA device, and log it as ``event`` with ``wall_seconds``."""
    t0 = time.perf_counter()
    yield
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log(event, wall_seconds=dt, **extra)


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` over the block (CPU, and CUDA when available),
    exported as a Chrome trace into ``logdir``; a no-op for None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
