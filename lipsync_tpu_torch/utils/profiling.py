"""Tracing and profiling spans.

Counterpart of ``utils/profiling.py`` in the JAX package: :class:`SpanTimer`
keeps the reference's manual ``perf_counter`` span log fields, and
:func:`cuda_trace`, the counterpart of ``tpu_trace``, captures a
``torch.profiler`` trace of the host and, where there is one, the CUDA
device, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class SpanTimer:
    """Collects named wall-clock spans (milliseconds)."""

    def __init__(self):
        self.spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
