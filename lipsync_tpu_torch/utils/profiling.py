"""Tracing and profiling spans.

Counterpart of ``utils/profiling.py`` in the JAX package: :class:`SpanTimer`
keeps the reference's manual ``perf_counter`` span log fields, and
:func:`cuda_trace`, the counterpart of ``tpu_trace``, captures a
``torch.profiler`` trace of the host and, where there is one, the CUDA
device, written as a Chrome trace.

The program's own spans and counters (:func:`span`, :func:`count`) record
only while a ``torch.profiler`` session is active; otherwise each costs one
flag check. A recorded span is a ``record_function`` annotation on the
profiler's timeline and a :class:`SpanRecord` kept in memory, timed by
``time.time_ns()``, the clock the profiler's events carry, so that a reader
of the trace can place each record beside the kernels. With ``device=`` a
CUDA device, a span also brackets the work enqueued inside it on that
device's current stream with a pair of timing events, resolved only when
:func:`records` is read; :func:`device_start` moves the first of them to
a later point of the span.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# Set by every ``torch.profiler`` session while it runs, and seen by every
# thread (the C++ profiler's own flag is per thread).
_ap = torch.autograd.profiler
_NULL = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One span: ``parent`` is the id of the span open around it in the
    same thread (or the one a thread adopted), None for a root; every span
    of one tree carries its root's id. ``t0_ns`` / ``t1_ns`` are
    ``time.time_ns()`` readings; ``device_s`` is the device time between
    the span's two stream events (None without ``device=`` on CUDA)."""

    id: int
    parent: Optional[int]
    root: int
    name: str
    t0_ns: int
    t1_ns: int
    device_s: Optional[float]


class _Recorder:
    """What the spans and counters of one process keep."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()
        self.kept: List[list] = []
        self.counters: Dict[str, int] = {}

    def stack(self) -> List["_Span"]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_recorder = _Recorder()


class _Span:
    __slots__ = ("name", "device", "rf", "id", "parent", "root", "t0",
                 "events", "stream")

    def __init__(self, name: str, device):
        self.name = name
        self.device = None
        if device is not None and torch.device(device).type == "cuda":
            self.device = torch.device(device)

    def __enter__(self):
        self.rf = _ap.record_function(self.name)
        self.rf.__enter__()
        stack = _recorder.stack()
        top = stack[-1] if stack else None
        self.id = next(_recorder.ids)
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        stack.append(self)
        self.events = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _recorder.stack().remove(self)
        _recorder.kept.append([self.id, self.parent, self.root, self.name,
                               self.t0, t1, self.events])
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context manager that records ``name`` around its body while a
    ``torch.profiler`` session is active, and does nothing otherwise.
    ``device``: the CUDA device whose current stream the span also times
    (ignored for other devices)."""
    if not _ap._is_profiler_enabled:
        return _NULL
    return _Span(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is
    active."""
    if not _ap._is_profiler_enabled:
        return
    with _recorder.lock:
        _recorder.counters[name] = _recorder.counters.get(name, 0) + int(n)


def device_start() -> None:
    """Start the device time of the innermost span open in this thread
    here, on its stream, while a profiler session is active: what the span
    did on the host before (staging a copy) is not counted as device
    time."""
    if not _ap._is_profiler_enabled:
        return
    stack = _recorder.stack()
    if stack and stack[-1].events is not None:
        stack[-1].events[0].record(stack[-1].stream)


def current() -> Optional[_Span]:
    """The innermost span open in this thread (None when none is, or no
    profiler session is active), for :func:`adopt` in another thread."""
    if not _ap._is_profiler_enabled:
        return None
    stack = _recorder.stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopt(parent: Optional[_Span]) -> Iterator[None]:
    """Make the spans opened in the body children of ``parent``, a span
    held open by this thread or another (from :func:`current`): a worker
    thread's spans then join the tree of the call that started it."""
    if parent is None:
        yield
        return
    _recorder.stack().append(parent)
    try:
        yield
    finally:
        _recorder.stack().remove(parent)


def records() -> List[SpanRecord]:
    """Every span kept since the last :func:`clear`, in the order they
    closed. Device times are resolved here: each waits for its span's end
    event."""
    out = []
    for r in _recorder.kept:
        events = r[6]
        if events is not None and not isinstance(events, float):
            events[1].synchronize()
            r[6] = events[0].elapsed_time(events[1]) / 1e3
        out.append(SpanRecord(*r))
    return out


def counters() -> Dict[str, int]:
    """Every counter kept since the last :func:`clear`."""
    with _recorder.lock:
        return dict(_recorder.counters)


def clear() -> None:
    """Drop the kept spans and counters."""
    with _recorder.lock:
        _recorder.kept.clear()
        _recorder.counters.clear()


class SpanTimer:
    """Collects named wall-clock spans (milliseconds); each also records a
    program :func:`span` of the same name while a profiler is active."""

    def __init__(self):
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.spans[name] = self.spans.get(name, 0.0) + ms

    def log(self, prefix: str = "") -> None:
        parts = " ".join(f"{k}_ms={v:.1f}" for k, v in self.spans.items())
        logger.info("%s%s", prefix, parts)


@contextlib.contextmanager
def cuda_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace when ``log_dir`` is set; no-op
    otherwise. The counterpart of the JAX package's ``tpu_trace``: it
    profiles the CPU, and CUDA when a CUDA device is present, and writes
    ``trace-<pid>-<ns>.json`` (Chrome trace format: chrome://tracing or
    Perfetto) into ``log_dir``. The profiler stops even if the body
    raises."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = out / f"trace-{os.getpid()}-{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        logger.info("Profiler trace written to %s", path)
