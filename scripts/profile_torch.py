"""Where the time goes in a short starcat_torch run on the GPU.

    python scripts/profile_torch.py [--config cfg6_chees] [--n-warmup 100]
                                    [--n-samples 50] [key=value ...]

Runs the preset once unprofiled (to build the kernels and warm up), then
once under torch.profiler, and prints one JSON line: the wall time of the
profiled run; the device-busy seconds and share, the union of the device's
kernel, copy and set intervals over the run (the profiler's annotations of
``record_function`` ranges left out, and overlapping kernels counted once:
``benchmark.core.reduce_profile``); the device time by kernel name, largest
first; the number of aten operator calls made on the host (nested calls
included), in all and per transition (per temperature step for the smc
head, e.g. --config cfg3_transdim_smc, whose length --n-warmup and
--n-samples do not set, and per step for the advi head); for the nuts head
(--config cfg2_nuts) also per leaf, a leaf being one launch of the fused
leapfrog; and the program's own spans and counters (starcat_torch.metrics:
the SMC step's and the ChEES sampling iteration's layers), each span's
count and summed host and device milliseconds.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

WINDOW = "profile_torch.window"


def span_table(rec: dict) -> dict:
    """Per span name: how many, and their summed host and device ms."""
    out: dict = {}
    for s in rec["spans"]:
        row = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["n"] += 1
        row["host_ms"] += s["host_ms"] or 0.0
        row["device_ms"] += s.get("device_ms") or 0.0
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cfg6_chees")
    ap.add_argument("--n-warmup", type=int, default=100)
    ap.add_argument("--n-samples", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.core import reduce_profile
    from starcat_torch import metrics
    from starcat_torch.__main__ import _parse_overrides
    from starcat_torch.api import sample
    from starcat_torch.configs import CONFIGS, apply_overrides

    cfg = CONFIGS[args.config]
    over = _parse_overrides(args.overrides)
    if cfg.head not in ("smc", "advi"):
        over = {"n_warmup": args.n_warmup, "n_samples": args.n_samples, **over}
    cfg = apply_overrides(cfg, over)
    sample(cfg, "cuda", seed=0)  # build + warm up
    torch.cuda.synchronize()
    metrics.reset_record()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = sample(cfg, "cuda", seed=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    trace = reduce_profile(prof, WINDOW)
    busy = trace.union_s()
    rec = metrics.record()

    if cfg.head == "smc":
        unit, n_units = "temperature step", out.stats["n_temp_steps"]
    elif cfg.head == "advi":
        unit, n_units = "ADVI step", cfg.advi.n_steps
    else:
        unit, n_units = "transition", cfg.n_warmup + cfg.n_samples * cfg.thin
    print(json.dumps({
        "config": cfg.name, "head": cfg.head,
        **({"n_particles": cfg.smc.n_particles} if cfg.head == "smc" else
           {"n_chains": cfg.n_chains, "n_warmup": cfg.n_warmup, "n_samples": cfg.n_samples}),
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_busy_s": busy,
        "device_busy_share": busy / trace.window_s,
        "kernel": out.stats["kernel"],
        "kernel_launches": out.stats["kernel_launches"],
        "aten_calls": trace.aten_calls,
        "unit": unit, "aten_calls_per_unit": trace.aten_calls / max(n_units, 1),
        "device_busy_s_per_unit": busy / max(n_units, 1),
        **({"leaves_per_transition": out.stats["kernel_launches"] / max(n_units, 1),
            "aten_calls_per_leaf": trace.aten_calls / max(out.stats["kernel_launches"], 1)}
           if cfg.head == "nuts" else {}),
        "top_device_s": dict(trace.top_ops(args.top)),
        "spans": span_table(rec),
        "counters": rec["counters"],
    }))


if __name__ == "__main__":
    main()
