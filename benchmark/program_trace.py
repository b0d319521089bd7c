"""The program's own spans and counters (``starcat_torch.metrics.record()``)
as the per-layer readers take them: None wherever the program recorded
nothing to read, so a program without the recorder, a CPU run without
device intervals or another head leaves the metric out."""
from __future__ import annotations


def record():
    """The program's record of the traced window, or None where it has none."""
    try:
        from starcat_torch import metrics
    except ImportError:
        return None
    read = getattr(metrics, "record", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] or rec["counters"] else None


def ms_per_unit(run, head: str, unit: str, name: str, field: str) -> float | None:
    """The sum of ``field`` (``device_ms`` or ``host_ms``) over the spans
    called ``name``, over the number of ``unit`` spans (steps, iterations)."""
    rec = record() if run.head.name == head else None
    if rec is None:
        return None
    units = sum(s["name"] == unit for s in rec["spans"])
    values = [s.get(field) for s in rec["spans"] if s["name"] == name]
    if not units or not values or any(v is None for v in values):
        return None
    return sum(values) / units


def share(run, head: str, part: str, whole: str) -> float | None:
    """100 × counter ``part`` / counter ``whole``."""
    rec = record() if run.head.name == head else None
    if rec is None or not rec["counters"].get(whole):
        return None
    return 100.0 * rec["counters"].get(part, 0) / rec["counters"][whole]
