"""The port's layout transposes, profiling spans and trace, and the small
utilities (``split_av_paths``, ``device_summary``) against the JAX
package's. Layouts are numpy transposes on both sides: equal arrays."""

import json
import logging
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


def test_span_timer_accumulates_like_jax(monkeypatch):
    """Both timers add every span of one name, in milliseconds, on the same
    clock readings."""
    ticks = iter([0.0, 0.010, 0.5, 0.503, 1.0, 1.002] * 2)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    import lipsync_tpu.utils.profiling as jp

    monkeypatch.setattr(jp.time, "perf_counter", lambda: next(ticks))
    timers = (profiling.SpanTimer(), JSpanTimer())
    for t in timers:
        with t.span("pre"):
            pass
        with t.span("pre"):
            pass
        with pytest.raises(KeyError):
            with t.span("post"):
                raise KeyError("a span still closes when its body raises")
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
