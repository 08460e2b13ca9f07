"""The port's layout transposes, profiling spans and trace, and the small
utilities (``split_av_paths``, ``device_summary``) against the JAX
package's. Layouts are numpy transposes on both sides: equal arrays. The
program's own spans and counters (``profiling.span`` / ``count``) are held
against the CPU profiler's events."""

import contextlib
import json
import logging
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu.utils import layout as j_layout
from lipsync_tpu.utils.file_manager import split_av_paths as j_split_av_paths
from lipsync_tpu.utils.profiling import SpanTimer as JSpanTimer
from lipsync_tpu_torch.utils import layout, profiling
from lipsync_tpu_torch.utils.device import device_summary
from lipsync_tpu_torch.utils.file_manager import split_av_paths

torch.set_num_threads(1)

# (from, to, reference layout, channels-last layout)
PAIRS = [("visual_from_torch", "visual_to_torch", (2, 3, 4, 5, 6),
          (2, 4, 5, 6, 3)),
         ("visual_from_torch", "visual_to_torch", (3, 4, 5, 6), (4, 5, 6, 3)),
         ("audio_from_torch", "audio_to_torch", (2, 1, 80, 7), (2, 80, 7, 1)),
         ("audio_from_torch", "audio_to_torch", (1, 80, 7), (80, 7, 1))]


@pytest.mark.parametrize("frm,to,shape,native_shape", PAIRS,
                         ids=["visual", "visual_unbatched", "audio",
                              "audio_unbatched"])
def test_layout_matches_jax_and_round_trips(frm, to, shape, native_shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    native = getattr(layout, frm)(x)
    assert native.shape == native_shape
    np.testing.assert_array_equal(native, getattr(j_layout, frm)(x))
    np.testing.assert_array_equal(getattr(layout, to)(native), x)
    np.testing.assert_array_equal(getattr(layout, to)(native),
                                  getattr(j_layout, to)(native))


@pytest.fixture
def recorder():
    """The program's recorder, empty before and after the test."""
    profiling.clear()
    yield profiling
    profiling.clear()


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("profiled", [False, True],
                         ids=["plain", "profiled"])
def test_span_timer_accumulates_like_jax(monkeypatch, recorder, profiled):
    """Both timers add every span of one name, in milliseconds, on the same
    clock readings; under a profiler the port's timer also records each
    span as a program span, and its milliseconds stay the JAX timer's."""
    ticks = iter([0.0, 0.010, 0.5, 0.503, 1.0, 1.002] * 2)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    import lipsync_tpu.utils.profiling as jp

    monkeypatch.setattr(jp.time, "perf_counter", lambda: next(ticks))
    timers = (profiling.SpanTimer(), JSpanTimer())
    with _cpu_profile() if profiled else contextlib.nullcontext():
        for t in timers:
            with t.span("pre"):
                pass
            with t.span("pre"):
                pass
            with pytest.raises(KeyError):
                with t.span("post"):
                    raise KeyError("a span still closes when its body raises")
    assert [r.name for r in recorder.records()] == (
        ["pre", "pre", "post"] if profiled else [])
    for t in timers:
        assert set(t.spans) == {"pre", "post"}
        assert t.spans["pre"] == pytest.approx(13.0)
        assert t.spans["post"] == pytest.approx(2.0)
    assert timers[0].spans == timers[1].spans


def test_span_timer_log():
    t = profiling.SpanTimer()
    t.spans = {"pre": 1.25, "inference": 10.0}
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    profiling.logger.addHandler(handler)
    try:
        t.log("clip ")
    finally:
        profiling.logger.removeHandler(handler)
    assert [r.getMessage() for r in records] == [
        "clip pre_ms=1.2 inference_ms=10.0"]


@pytest.mark.parametrize("log_dir", [None, ""])
def test_cuda_trace_without_dir_is_a_no_op(log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.cuda_trace(log_dir):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_cuda_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    out = tmp_path / "trace"
    with profiling.cuda_trace(str(out)):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_cuda_trace_stops_the_profiler_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError):
        with profiling.cuda_trace(str(tmp_path)):
            raise ValueError("body failed")
    assert len(list(tmp_path.iterdir())) == 1
    # A new trace can start: the first one was stopped.
    with profiling.cuda_trace(str(tmp_path / "again")):
        torch.ones(2).sum()
    assert len(list((tmp_path / "again").iterdir())) == 1


def test_split_av_paths_matches_jax():
    p = Path("/clips/a.mp4")
    assert split_av_paths(p) == j_split_av_paths(p) == (p, p)


def test_device_summary(monkeypatch):
    assert device_summary("cpu") == "1x cpu (cpu)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert device_summary() == "1x cuda (NVIDIA H100 80GB HBM3)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_summary()


# ── the program's spans and counters ─────────────────────────────────────


def _nest():
    """Three spans (an inner pair under one outer) and a counter."""
    with profiling.span("outer"):
        profiling.count("bytes", 3)
        with profiling.span("inner"):
            torch.ones(8).sum()
        with profiling.span("inner", device="cpu"):
            profiling.count("bytes", 4)
    with profiling.span("second"):
        pass


def test_no_profiler_keeps_nothing(recorder):
    """With no profiler session a span is one shared null context and a
    counter adds nothing."""
    assert profiling.span("a") is profiling.span("b", device="cpu")
    _nest()
    assert recorder.records() == [] and recorder.counters() == {}


def test_spans_nest_and_counters_add_under_a_profiler(recorder):
    with _cpu_profile():
        _nest()
    recs = {(r.name, r.id): r for r in recorder.records()}
    by = {}
    for (name, _), r in sorted(recs.items(), key=lambda kv: kv[0][1]):
        by.setdefault(name, []).append(r)
    outer, second = by["outer"][0], by["second"][0]
    assert outer.parent is None and outer.root == outer.id
    assert second.parent is None and second.root == second.id
    assert [r.parent for r in by["inner"]] == [outer.id, outer.id]
    assert all(r.root == outer.id for r in by["inner"])
    assert all(r.device_s is None for r in recs.values())  # no CUDA here
    assert all(r.t0_ns <= r.t1_ns for r in recs.values())
    assert outer.t0_ns <= by["inner"][0].t0_ns
    assert by["inner"][1].t1_ns <= outer.t1_ns <= second.t0_ns
    assert recorder.counters() == {"bytes": 7}
    recorder.clear()
    assert recorder.records() == [] and recorder.counters() == {}


@pytest.mark.parametrize("sleep_s", [0.0, 0.002])
def test_spans_lie_on_the_profilers_clock(recorder, sleep_s):
    """Each kept span has a ``record_function`` event of its name, and its
    host interval lies within 1 ms of the event's at both ends."""
    with _cpu_profile() as prof:
        for i in range(20):
            with profiling.span(f"clock.{i}"):
                time.sleep(sleep_s)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    kept = recorder.records()
    assert len(kept) == 20
    for r in kept:
        e = events[r.name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert abs(r.t0_ns - start) <= 1_000_000, (r, start)
        assert abs(r.t1_ns - end) <= 1_000_000, (r, end)


def test_threads_keep_their_own_stacks_and_adopt_a_parent(recorder):
    """Spans opened in worker threads are roots of their own unless the
    thread adopts a span the caller holds open."""
    with _cpu_profile():
        with profiling.span("caller"):
            parent = profiling.current()

            def work(adopt):
                with profiling.adopt(parent if adopt else None):
                    with profiling.span(f"worker.{adopt}"):
                        pass

            threads = [threading.Thread(target=work, args=(a,))
                       for a in (True, False)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in recorder.records()}
    caller = recs["caller"]
    assert recs["worker.True"].parent == caller.id
    assert recs["worker.True"].root == caller.root
    assert recs["worker.False"].parent is None
    assert profiling.current() is None


def test_counts_and_ids_survive_many_threads(recorder):
    """More threads than cores, switching often: no count is lost and no
    two spans share an id."""
    import os
    import sys

    n_threads, per = 4 * (os.cpu_count() or 1) + 4, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(per):
                    with profiling.span("stress"):
                        profiling.count("stress", 1)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = recorder.records()
    assert recorder.counters() == {"stress": n_threads * per}
    assert len(recs) == n_threads * per
    assert len({r.id for r in recs}) == len(recs)
    assert all(r.parent is None for r in recs)


def test_device_start_restarts_the_innermost_device_span(recorder):
    """``device_start`` records the first timing event of the innermost
    open span again, on that span's stream, and does nothing to a span
    without events or with no profiler session."""
    log = []

    class Event:
        def __init__(self, name):
            self.name = name

        def record(self, stream):
            log.append((self.name, stream))

    profiling.device_start()  # no session: a no-op
    with _cpu_profile():
        with profiling.span("outer") as outer:
            outer.events, outer.stream = (Event("start"), Event("end")), "s"
            with profiling.span("host"):
                profiling.device_start()  # innermost has no events
            assert log == []
            profiling.device_start()
            assert log == [("start", "s")]
            outer.events = None  # nothing left to resolve on the CPU
