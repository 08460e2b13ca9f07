"""The profiler over a traced run's window, and what is read from it.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activities) around the
measured window when tracing is on. Afterwards it holds, on the trace's
own clock (ns): every device kernel's interval and name, the window's
interval (the ``window`` annotation) and each benchmark span. From these:
``busy_s`` (the union of kernel intervals inside the window), the idle
gaps and, by name, each kernel's total time.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "window"


class Trace:
    def __init__(self, enabled: bool, span_names: Sequence[str] = ()):
        self.enabled = enabled
        self.span_names = set(span_names) | {WINDOW}
        self.kernels: List[Tuple[int, int, str]] = []
        self.spans: List[Tuple[int, int, str]] = []
        self.window: Optional[Tuple[int, int]] = None

    @contextlib.contextmanager
    def run(self, spans):
        """Profile the body; ``spans`` is the run's :class:`Spans`, whose
        window span is opened here."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        try:
            with spans.span(WINDOW):
                yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
        self._read(prof)

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        for e in prof.profiler.kineto_results.events():
            start, dur, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == DeviceType.CUDA:
                # Kernels and copies count as busy; the annotations that
                # mirror the benchmark's spans on the device do not.
                if not e.is_user_annotation():
                    self.kernels.append((start, start + dur, name))
            elif name in self.span_names:
                self.spans.append((start, start + dur, name))
        windows = [(s, t) for s, t, n in self.spans if n == WINDOW]
        if windows:
            self.window = windows[0]

    # ---------------------------------------------------------- readings
    def window_s(self) -> Optional[float]:
        if self.window is None:
            return None
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Merged kernel intervals clipped to the window."""
        if self.window is None:
            return []
        lo, hi = self.window
        merged: List[List[int]] = []
        for s, t, _ in sorted(self.kernels):
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> Optional[float]:
        if self.window is None or not self.kernels:
            return None
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def idle_share(self) -> Optional[float]:
        busy, window = self.busy_s(), self.window_s()
        if busy is None or not window:
            return None
        return 100.0 * (window - busy) / window

    def kernel_seconds(self, names: Sequence[str]) -> Tuple[float, int]:
        """Total seconds and launches of kernels whose name holds one of
        ``names``, inside the window."""
        if self.window is None:
            return 0.0, 0
        lo, hi = self.window
        total, count = 0, 0
        for s, t, n in self.kernels:
            if s >= lo and t <= hi and any(k in n for k in names):
                total += t - s
                count += 1
        return total / 1e9, count

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for s, t, n in self.kernels:
            by[n] = by.get(n, 0) + (t - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time inside the window by the innermost benchmark span the
        host was in when each gap began (``window`` where none)."""
        if self.window is None:
            return []
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + \
            [self.window[1]]
        spans = sorted((s, t, n) for s, t, n in self.spans if n != WINDOW)
        by: Dict[str, int] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            inner = [(t - s, n) for s, t, n in spans if s <= a < t]
            name = min(inner)[1] if inner else WINDOW
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]
