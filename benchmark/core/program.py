"""The program's own spans and counters, read after a traced window.

``lipsync_tpu_torch.utils.profiling`` keeps a record of each span the
program opens while a profiler runs (name, parent, root, start and end by
``time.time_ns()``, the clock of the profiler's events, and with a CUDA
device the device seconds between two stream events) and counters. The
readers here keep the spans that start inside the trace's window, on that
shared clock. A program that records none (an older checkout) gives
``None``, so its metrics are left out of the line.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple


def _profiling():
    try:
        from lipsync_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records"):
        return None
    return profiling


def spans(view, name: str) -> Optional[List]:
    """The program's ``name`` spans that start inside the window (None
    where the program keeps no spans or the trace has no window)."""
    prof = _profiling()
    if prof is None or view.trace.window is None:
        return None
    lo, hi = view.trace.window
    return [r for r in prof.records() if r.name == name and lo <= r.t0_ns < hi]


def counter(name: str) -> Optional[int]:
    """The program's counter ``name`` over the profiled session."""
    prof = _profiling()
    if prof is None:
        return None
    return prof.counters().get(name)


def host_s(records: Sequence) -> float:
    return sum(r.t1_ns - r.t0_ns for r in records) / 1e9


def device_s(records: Sequence) -> Optional[float]:
    """Summed device seconds; None if any record has none (no CUDA)."""
    if not records or any(r.device_s is None for r in records):
        return None
    return sum(r.device_s for r in records)


def median_ms_by(records: Sequence, key: str) -> Optional[float]:
    """Median over groups of the records' summed device milliseconds, the
    groups by ``key`` (``"parent"``: one engine group; ``"root"``: one
    train step)."""
    if not records or any(r.device_s is None for r in records):
        return None
    by: Dict[int, float] = {}
    for r in records:
        k = getattr(r, key)
        by[k] = by.get(k, 0.0) + r.device_s
    return 1e3 * statistics.median(by.values())


def idle_inside(view, records: Sequence) -> Optional[float]:
    """Seconds of the window in which the card ran no kernel or copy
    (``view.trace.busy_intervals()``) while the host was inside one of
    ``records``' intervals (None where the trace holds no device work)."""
    if view.trace.busy_s() is None or not records:
        return None
    lo, hi = view.trace.window
    idle: List[Tuple[int, int]] = []
    at = lo
    for s, t in view.trace.busy_intervals():
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    if at < hi:
        idle.append((at, hi))
    inside: List[List[int]] = []
    for s, t in sorted((r.t0_ns, r.t1_ns) for r in records):
        if inside and s <= inside[-1][1]:
            inside[-1][1] = max(inside[-1][1], t)
        else:
            inside.append([s, t])
    total, i, j = 0, 0, 0
    while i < len(idle) and j < len(inside):
        (a, b), (c, d) = idle[i], inside[j]
        total += max(0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return total / 1e9
