"""Metrics, logging and tracing (port of starcat/metrics.py).

``MetricsLogger`` appends one JSON record a line, ``{"t", "run", "event",
...scalars}``, the reference's layout: per warmup phase, per sampling block,
per SMC temperature step, per ADVI window and one at the end of a run.  The
heads read their records back once a block, phase or step, never inside a
transition.

The program's own trace: ``span(name)`` marks a layer boundary and
``count(name, value)`` counts work at one.  Both are off unless the torch
profiler is recording or the caller is inside ``tracing()``; off, a span is
one shared null context and a count returns at once (no profiler range, no
CUDA event, no tensor op).  On, a span opens a ``record_function`` range,
so it stands in the profiler's trace beside the kernels, and appends to an
in-memory record: its name, the span it opened inside (``parent``), host
start and end, and on CUDA a pair of timing events on the current stream.
A count adds a Python int, or a tensor's sum, times a Python int to a
per-name counter; a tensor is kept and summed on its device when the record
is read, so a count costs no sync and no tensor op inside a transition.
Counters count the calling rank's work.
``record()`` resolves the events once (one device sync) and returns
``{"spans": [...], "counters": {...}}``; ``reset_record()`` clears it.
``profile_trace`` wraps ``torch.profiler``, writes the Chrome trace and the
record beside it.

The spans (each opened once, where its work runs):

- ``smc.step``: one temperature step of ``smc.make_smc_step``, with its
  children ``smc.temper`` (Δβ, the reweight, log Z, the resampling plan and
  the gather of the resampled rows), ``smc.sweeps`` (the trans-d sweeps),
  ``smc.mutate`` (the mutations and the step-size controller) and
  ``smc.refresh`` (the closing untempered log-likelihood);
- ``chees.iteration``: one iteration of ``chees.chees_sample``, with
  ``chees.trajectory`` (the leapfrog trajectory) and, on iterations that
  relocate, ``chees.relocate`` (the relocate sweep and the grad refresh).

The counters: ``transdim.moves`` and ``transdim.accepted`` (an SMC step's
trans-d moves kept and accepted), ``transdim.kernel_moves`` (the trans-d
moves that ran on the sweep kernel, chains x launches, counted in
transdim.poisson_sweep), ``chees.relocations`` and
``chees.relocations_accepted``, ``chees.leapfrog_steps`` (chains × each
iteration's step count).

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
import torch.autograd.profiler as _autograd_profiler


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


class _Recorder:
    """The process's spans and counters, kept in memory until read."""

    def __init__(self):
        self.forced = 0   # depth of tracing() blocks
        self.reset()

    def reset(self) -> None:
        # [name, parent, host start ns, host end ns, start event, end event]
        self.spans: list = []
        self.open: list = []
        self.host_counts: dict = {}
        self.tensor_counts: dict = {}
        self.anchor = None   # (host ns, event) after the recording's first sync
        self.resolved = None

    def begin(self, name: str) -> tuple:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        ev = None
        if torch.cuda.is_initialized():
            if self.anchor is None:
                torch.cuda.synchronize()
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
                self.anchor = (time.perf_counter_ns(), anchor)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        i = len(self.spans)
        self.spans.append([name, self.open[-1] if self.open else None,
                           time.perf_counter_ns(), None, ev, None])
        self.open.append(i)
        self.resolved = None
        return self.spans, i, rf

    def end(self, token: tuple) -> None:
        spans, i, rf = token
        if spans is self.spans:   # not reset since the span opened
            s = spans[i]
            s[3] = time.perf_counter_ns()
            if s[4] is not None:
                s[5] = torch.cuda.Event(enable_timing=True)
                s[5].record()
            self.open.pop()
        rf.__exit__(None, None, None)

    def count(self, name: str, value, times: int) -> None:
        if isinstance(value, torch.Tensor):
            # kept as it is and summed when the record is read: no tensor op
            # inside the transition (the program hands fresh tensors)
            self.tensor_counts.setdefault(name, []).append((value, times))
        else:
            self.host_counts[name] = self.host_counts.get(name, 0) + int(value) * times
        self.resolved = None

    def record(self) -> dict:
        if self.resolved is not None:
            return self.resolved
        if self.anchor is not None:
            torch.cuda.synchronize()
        spans = []
        for name, parent, h0, h1, e0, e1 in self.spans:
            s = {"name": name, "parent": parent, "host_start_ns": h0, "host_end_ns": h1,
                 "host_ms": None if h1 is None else (h1 - h0) * 1e-6}
            if e0 is not None and e1 is not None:
                a_ns, a_ev = self.anchor
                d0 = a_ns + round(a_ev.elapsed_time(e0) * 1e6)
                d1 = a_ns + round(a_ev.elapsed_time(e1) * 1e6)
                s.update(device_start_ns=d0, device_end_ns=d1, device_ms=(d1 - d0) * 1e-6)
            spans.append(s)
        counters = dict(self.host_counts)
        for name, parts in self.tensor_counts.items():
            counters[name] = counters.get(name, 0) + sum(int(v.sum()) * k for v, k in parts)
        self.resolved = {"spans": spans, "counters": counters}
        return self.resolved


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.token = _RECORDER.begin(self.name)
        return self

    def __exit__(self, *exc):
        _RECORDER.end(self.token)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as span ``name`` while
    tracing is on, and the shared null context otherwise."""
    if _RECORDER.forced or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, value, times: int = 1) -> None:
    """Add ``value`` × ``times`` to counter ``name`` while tracing is on:
    ``value`` a Python int, or an integer or boolean tensor whose sum is
    taken on its device."""
    if _RECORDER.forced or _autograd_profiler._is_profiler_enabled:
        _RECORDER.count(name, value, times)


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block, without the profiler."""
    _RECORDER.forced += 1
    try:
        yield
    finally:
        _RECORDER.forced -= 1


def record() -> dict:
    """``{"spans": [...], "counters": {...}}`` of everything recorded since
    the last reset: a span's ``name``, ``parent`` (the index of the span it
    opened inside, or None), ``host_start_ns`` / ``host_end_ns`` /
    ``host_ms`` on ``time.perf_counter_ns``'s clock and, on CUDA,
    ``device_start_ns`` / ``device_end_ns`` / ``device_ms`` on the same
    clock (the device's events measured from an anchor event recorded right
    after a sync).  Resolved once (one device sync) and cached."""
    return _RECORDER.record()


def reset_record() -> None:
    """Forget every span and counter recorded so far."""
    _RECORDER.reset()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` over the block (CPU, and CUDA when available),
    exported as a Chrome trace ``trace_<pid>.json`` into ``logdir`` with the
    block's record (spans and counters) beside it as ``spans_<pid>.json``;
    a no-op for None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset_record()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
    with open(os.path.join(logdir, f"spans_{os.getpid()}.json"), "w") as fh:
        json.dump(record(), fh)
