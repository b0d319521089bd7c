"""What every cell shares: finding a cell's configuration, traffic mix and
metric readers by name, the chip and import guards, the reduction of a
profiler trace to kernel intervals, host aten calls, the device's busy
time and the breakdown, and the result line."""
from __future__ import annotations

import bisect
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "starcat")

# The name of each trajectory kernel of the port in a profiler trace, by the
# name dispatch.trajectory_kernel gives it: a substring of the CUDA symbol.
KERNEL_SYMBOLS = {
    "B1": "fused_leapfrog_kernel", "B2": "fused_leapfrog_kernel",
    "B3": "fused_rhmc_diag_kernel", "B4": "fused_rhmc_diag_crowded",
    "B5": "fused_leapfrog_crowded", "B6": "fused_rhmc_kernel", "B6c": "fused_rhmc_crowded",
}


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json (in the checkout ``root``) with its
    configuration, traffic and limits files read, and the metrics it
    reports with trace 0 and trace 1."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {', '.join(sorted(cells))}")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in spec["configs"]}
    cell["config_entry"] = configs[cell["config"]]
    cell["config_data"] = load_json(root / configs[cell["config"]]["file"])
    cell["traffic_data"] = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    cell["limits"] = load_json(root / "benchmark" / "limits" / f"{name}.json")

    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    cell["metrics"] = {0: e2e, 1: per_layer}
    return cell


def load_module(path: Path, name: str):
    """Import a file by its path (metric files carry dots in their names)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str, root: Path = ROOT):
    """The read(run) function of benchmark/metrics/<name>.py."""
    return load_module(root / "benchmark" / "metrics" / f"{metric_name}.py",
                       "benchmark_metric_" + metric_name.replace(".", "_")).read


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: the loaded modules) that are
    the JAX package or JAX, compared whole (starcat_torch is not starcat)."""
    return sorted({m.split(".")[0] for m in list(sys.modules if names is None else names)}
                  & set(FORBIDDEN))


@dataclass
class Trace:
    """A traced window reduced: device intervals (name, start, end) in
    seconds from the window's start, host aten calls, the window's length."""

    window_s: float
    kernels: list = field(default_factory=list)
    aten_calls: int = 0
    host: list = field(default_factory=list)   # (start, end, name) of host ops, by start
    spans: list = field(default_factory=list)  # (start, end, name) of the harness's spans

    def union_s(self, keep=lambda name: True) -> float:
        """Seconds in which some device activity that ``keep`` admits ran."""
        total, cur_lo, cur_hi = 0.0, None, None
        for a, b in sorted((a, b) for n, a, b in self.kernels if keep(n)):
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total

    def kernel_s(self, symbol: str) -> float:
        return sum(b - a for n, a, b in self.kernels if symbol in n)

    def top_ops(self, n=10) -> list:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, starts: list) -> str:
        span = next((s for a, b, s in self.spans if a <= t <= b), "outside spans")
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 5000, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                return f"{span}:{name}"
        return span

    def idle_gaps(self, n=10) -> list:
        """The idle time between device activity in the window, summed by
        what the host was doing at each gap's middle (the harness's span and
        the innermost host op), the largest n."""
        gaps, hi = [], 0.0
        for a, b in sorted((a, b) for _, a, b in self.kernels):
            if a > hi:
                gaps.append((hi, a))
            hi = max(hi, b)
        if self.window_s > hi:
            gaps.append((hi, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        by: dict[str, float] = {}
        starts = [h[0] for h in self.host]
        for a, b in gaps[:2000]:
            label = self._host_at(0.5 * (a + b), starts)
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def reduce_profile(prof, window_span: str) -> Trace:
    """Reduce a torch.profiler run to a Trace over the span ``window_span``
    (recorded by the harness around the measured loop): device kernels,
    copies and sets clipped to the window, every host aten op in it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == window_span and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    t0 = win[0].start_ns()
    t1 = t0 + win[0].duration_ns()
    tr = Trace(window_s=(t1 - t0) * 1e-9)
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if a + d < t0 or a > t1:
            continue
        lo, hi = (max(a, t0) - t0) * 1e-9, (min(a + d, t1) - t0) * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # record_function spans appear on the device too, as annotations
            kind = getattr(e, "activity_type", lambda: "")()
            if not (name.startswith("bench.") or e.is_user_annotation()
                    or "annotation" in str(kind)):
                tr.kernels.append((name, lo, hi))
        elif name.startswith("aten::"):
            tr.aten_calls += 1
            tr.host.append((lo, hi, name))
        elif name.startswith("bench.") and name != window_span:
            tr.spans.append((lo, hi, name))
    tr.host.sort()
    return tr


def device_entry(trace: Trace | None, memory_peak: int, chips: int) -> dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(memory_peak)}
    if trace is not None:
        dev["busy_s"] = trace.union_s()
        dev["window_s"] = trace.window_s
    return dev


def check_lines(checks: list) -> list[str]:
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"({'within' if c['value'] <= c['limit'] else 'OVER'})" for c in checks]
