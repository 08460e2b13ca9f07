"""Spans and counters recorded from the benchmark's own files.

A span is a host interval around a call into one layer of the program,
recorded only in a traced run: its name, start and end on the host clock,
and, when the profiler runs, a ``record_function`` annotation of the same
name, so that the device trace can say what the host was doing in each
idle gap. Counters count calls and hold what the readers need of them (for
a kernel, the shapes it was given).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Dict, List, Tuple


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: List[Tuple[str, float, float]] = []
        self.counters: Dict[str, Any] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def wrap(self, owner: Any, attr: str, name: str,
             note: Callable[..., Any] = None) -> None:
        """Replace ``owner.attr`` by a wrapper that records a span around
        each call and, with ``note``, appends ``note(*args, **kwargs)`` to
        the counter ``name``. Only in a traced run."""
        if not self.enabled:
            return
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            if note is not None:
                self.counters.setdefault(name, []).append(note(*args,
                                                               **kwargs))
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.records if n == name]
