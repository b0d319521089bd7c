"""Where the time goes in a short starcat_torch run on the GPU.

    python scripts/profile_torch.py [--config cfg6_chees] [--n-warmup 100]
                                    [--n-samples 50] [key=value ...]

Runs the preset once unprofiled (to build the kernel and warm up), then once
under torch.profiler, and prints one JSON line: the wall time of the
profiled run, the device time summed over all kernels, the device-busy
share (device time / wall), and the device time by kernel name, largest
first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cfg6_chees")
    ap.add_argument("--n-warmup", type=int, default=100)
    ap.add_argument("--n-samples", type=int, default=50)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: CUDA is not available")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from starcat_torch.__main__ import _parse_overrides
    from starcat_torch.api import sample
    from starcat_torch.configs import CONFIGS, apply_overrides

    over = {"n_warmup": args.n_warmup, "n_samples": args.n_samples,
            **_parse_overrides(args.overrides)}
    cfg = apply_overrides(CONFIGS[args.config], over)
    sample(cfg, "cuda", seed=0)  # build + warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = sample(cfg, "cuda", seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_time(e) -> float:  # microseconds
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    from torch.autograd import DeviceType

    by_name = {}  # device-side kernel and memcpy events only, no CPU ops
    for e in prof.key_averages():
        t = dev_time(e)
        if e.device_type == DeviceType.CUDA and t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]
    print(json.dumps({
        "config": cfg.name, "head": cfg.head, "n_chains": cfg.n_chains,
        "n_warmup": cfg.n_warmup, "n_samples": cfg.n_samples,
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_s": total / 1e6,
        "device_busy_share": total / 1e6 / wall,
        "kernel_launches": out.stats["kernel_launches"],
        "top_device_s": {k: v / 1e6 for k, v in top},
    }))


if __name__ == "__main__":
    main()
