"""The port's pipelined long-video scoring and request coalescing against
the JAX package's, on the same frames, mel and bridged weights.

Both packages crop each frame with cv2 when it is importable, and with
their numpy branch otherwise (as on a machine without OpenCV). The
comparison runs with cv2 visible on both sides, and once with it hidden on
both.

Tolerances: tracks, window starts and uint8 crops exact; window
probabilities within 1e-5.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.batcher import CoalescingEngine as JCoalescing
from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.pipelined import (
    score_long_video_pipelined as j_score_pipelined,
)
from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu_torch.inference.batcher import CoalescingEngine
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.pipelined import score_long_video_pipelined
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from tests.fixtures import synthetic_frames
from tests.torch_parity import seeded_pair

torch.set_num_threads(1)
BOX = (60, 70, 110, 105)


@pytest.fixture(scope="module")
def engines():
    _, cfg, variables, jcfg = seeded_pair(5, crop_size=48)
    return (ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False),
            JEngine(variables, jcfg, use_bfloat16=False), cfg)


def _script(kind, n):
    if kind == "one":
        return lambda i: [BOX]
    if kind == "dropout":
        return lambda i: [] if 14 <= i < 20 else [BOX]
    if kind == "two":
        return lambda i: [BOX, (10, 10, 50, 40)] if i < n - 6 else [BOX]
    if kind == "short_track":
        return lambda i: [BOX] if 20 <= i < 26 else []
    return lambda i: []


@pytest.mark.parametrize("kind,stride", [("one", 1), ("dropout", 1),
                                         ("two", 1), ("short_track", 1),
                                         ("none", 1), ("dropout", 2)])
def test_pipelined_matches_jax(engines, kind, stride):
    _compare_pipelined(engines, kind, stride)


def test_pipelined_matches_jax_without_cv2(engines):
    """cv2 hidden on both sides: both crop with their numpy branch."""
    with mock.patch.dict(sys.modules, {"cv2": None}):
        _compare_pipelined(engines, "two", 1)


def _compare_pipelined(engines, kind, stride):
    port, jax_engine, cfg = engines
    n = 48
    frames = synthetic_frames(n=n, seed=1)
    mel = (np.random.RandomState(2).rand(80, 1 + n * 100 // 15) * 60
           - 60).astype(np.float32)
    kw = dict(chunk_size=8, stride=4, crop_size=cfg.crop_size,
              audio_frames=cfg.audio_frames, dispatch_batch=3,
              detection_stride=stride)
    got, got_probs = score_long_video_pipelined(
        frames, mel, port, backend=FakeDetector(_script(kind, n)), **kw)
    with jax.default_matmul_precision("highest"):
        want, want_probs = j_score_pipelined(
            frames, mel, jax_engine, backend=JFake(_script(kind, n)), **kw)
    assert len(got) == len(want)
    assert (len(got) == 0) == (kind == "none")
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.track_id, g.chunk_starts, g.abs_chunk_starts, g.chunk_size,
                g.hits, g.total_frames, g.stability, g.consecutive_miss_max,
                g.track_start_frame, g.track_end_frame, g.mean_bbox) == (
            w.track_id, w.chunk_starts, w.abs_chunk_starts, w.chunk_size,
            w.hits, w.total_frames, w.stability, w.consecutive_miss_max,
            w.track_start_frame, w.track_end_frame, w.mean_bbox)
        assert g.crops.dtype == np.uint8
        np.testing.assert_array_equal(g.crops, w.crops)
        assert len(got_probs[i]) == len(want_probs[i]) == g.num_chunks
        np.testing.assert_allclose(got_probs[i], want_probs[i], atol=1e-5,
                                   rtol=0)


def test_coalescing_engine_matches_jax(engines):
    """Concurrent callers share forwards; each gets its own windows'
    logits, equal to the JAX facade's within the engine tolerance."""
    import threading

    port, jax_engine, cfg = engines
    rng = np.random.RandomState(3)
    items = [(rng.rand(k, 8, 48, 48, 3).astype(np.float32),
              (rng.rand(k, 80, 32) * 60 - 60).astype(np.float32))
             for k in (1, 3, 2)]
    facade = CoalescingEngine(port, max_wait_ms=20.0)
    results = [None] * len(items)

    def call(i):
        results[i] = facade.score_logits(*items[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    facade.close()
    j_facade = JCoalescing(jax_engine, max_wait_ms=0.0)
    try:
        for (v, a), got in zip(items, results):
            with jax.default_matmul_precision("highest"):
                want = j_facade.score_logits(v, a)
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    finally:
        j_facade.close()
    assert 1 <= facade.batches_dispatched <= 3
    assert facade.items_coalesced == 3
    with pytest.raises(RuntimeError):
        facade.score_logits(*items[0])
