"""The engine's pinned staging and per-group read-back on a CUDA card, at
the model's published widths: logits bit-equal to the plain blocking
upload for bf16 and int8, the caller's arrays free to reuse once a
dispatch returns, concurrent callers each given their own logits, the
copies running beside the forward, and every byte of a bulk call staged.

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_engine_card.py --noconftest -m card
"""

import threading
import types

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return LipSyncModel(ModelConfig()).state_dict()


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def engine(request, card, weights):
    eng = ScoringEngine(weights, ModelConfig(), device=card,
                        quantized_int8=request.param)
    yield eng
    del eng
    torch.cuda.empty_cache()


def windows(n, seed):
    """``n`` windows: uint8 crops darkened per window, dB log-mel."""
    cfg = ModelConfig()
    rng = np.random.RandomState(seed)
    shape = (n, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3)
    level = rng.randint(64, 257, (n, 1, 1, 1, 1))
    visual = (rng.randint(0, 256, shape) * level // 256).astype(np.uint8)
    mel = (-80 * rng.rand(n, cfg.mel_bins, cfg.audio_frames)).astype(
        np.float32)
    return visual, mel


def plain(engine, monkeypatch):
    """``engine`` with every upload a plain blocking ``.to(device)``."""
    monkeypatch.setattr(engine, "_ring", lambda dev: None)
    return engine


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 7, 256, 1031])
def test_staged_logits_equal_the_plain_upload(engine, monkeypatch, n):
    """Groups of 1, 7 and 256 windows and a call of 1,031 (four groups of
    256 and a ragged seven) score bit for bit as with blocking uploads."""
    visual, mel = windows(n, n)
    staged = engine.score_logits(visual, mel)
    with monkeypatch.context() as m:
        want = plain(engine, m).score_logits(visual, mel)
    np.testing.assert_array_equal(staged, want)


@pytest.mark.card
def test_staged_track_logits_equal_the_plain_upload(engine, monkeypatch):
    """The track path (the crops, then each shard's starts and mel, each
    through a slot of the ring) scores bit for bit as with blocking
    uploads, over three groups of 16 windows."""
    visual, mel = windows(48, 3)
    crops = visual.reshape(-1, *visual.shape[2:])[:200]
    starts = list(range(0, 200 - ModelConfig().video_frames, 4))[:48]
    monkeypatch.setattr(engine, "max_batch", 16)
    staged = engine.score_track_logits(crops, starts, mel)
    with monkeypatch.context() as m:
        want = plain(engine, m).score_track_logits(crops, starts, mel)
    np.testing.assert_array_equal(staged, want)


@pytest.mark.card
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_two_shards_on_one_card_equal_the_plain_upload(card, weights,
                                                       monkeypatch, int8):
    """A mesh of two shards on the card (under int8 in lockstep threads,
    each staging through the device's ring) scores windows and a track
    with shared encoding bit for bit as with blocking uploads."""
    eng = ScoringEngine(weights, ModelConfig(), mesh=[card, card],
                        quantized_int8=int8, shared_visual_encoding=True,
                        max_batch=32)
    visual, mel = windows(70, 4)
    crops = visual.reshape(-1, *visual.shape[2:])[:120]
    starts = list(range(0, 120 - ModelConfig().video_frames, 2))[:40]
    staged = (eng.score_logits(visual, mel),
              eng.score_track_logits(crops, starts, mel[:40]))
    with monkeypatch.context() as m:
        plain(eng, m)
        want = (eng.score_logits(visual, mel),
                eng.score_track_logits(crops, starts, mel[:40]))
    for s, w in zip(staged, want):
        np.testing.assert_array_equal(s, w)
    del eng
    torch.cuda.empty_cache()


@pytest.mark.card
def test_predictor_streams_through_read_back(engine):
    """The predictor's double-buffered window stream reads each group back
    through the engine and gives ``score_probs``' probabilities."""
    from lipsync_tpu_torch.inference.predictor import Predictor

    visual, mel = windows(300, 5)
    host = types.SimpleNamespace(engine=engine, _score_windows=None)
    got = Predictor._score_window_iter(host, zip(visual, mel))
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  engine.score_probs(visual, mel))


@pytest.mark.card
def test_callers_arrays_are_free_once_dispatch_returns(engine):
    """Overwriting the arrays right after ``dispatch_logits`` returns
    leaves the group's logits as they were."""
    visual, mel = windows(256, 1)
    want = engine.score_logits(visual, mel)
    logits = engine.dispatch_logits(visual, mel)
    visual[:] = 0
    mel[:] = 0.0
    np.testing.assert_array_equal(engine.read_back(logits, 256), want)


@pytest.mark.card
def test_concurrent_callers_get_their_own_logits(engine):
    """Four threads, two through ``score_logits`` and two through
    ``dispatch_logits``, at once and three times each: each gets the
    logits of its own windows."""
    inputs = [windows(n, 10 + i) for i, n in enumerate((300, 64, 256, 9))]
    want = [engine.score_logits(v, a) for v, a in inputs]
    got = [[] for _ in inputs]
    errors = []

    def caller(i):
        v, a = inputs[i]
        try:
            for _ in range(3):
                if i % 2:
                    got[i].append(engine.read_back(
                        engine.dispatch_logits(v, a), len(v)))
                else:
                    got[i].append(engine.score_logits(v, a))
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for mine, w in zip(got, want):
        assert len(mine) == 3
        for g in mine:
            np.testing.assert_array_equal(g, w)


@pytest.mark.card
def test_copies_overlap_the_forward_and_all_bytes_are_staged(engine):
    """Under ``torch.profiler`` a call of 1,024 windows runs at least one
    host-to-device copy while a kernel runs, and every byte it uploads
    goes through the pinned ring."""
    from torch.profiler import ProfilerActivity, profile

    visual, mel = windows(1024, 2)
    engine.score_logits(visual, mel)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.score_logits(visual, mel)
        torch.cuda.synchronize()
    counters = profiling.counters()
    profiling.clear()
    assert counters["engine.upload_staged_bytes"] == \
        counters["engine.upload_bytes"] > 0
    copies, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if "Memcpy HtoD" in e.name():
            copies.append(iv)
        elif "Memcpy" not in e.name() and "Memset" not in e.name():
            kernels.append(iv)
    assert copies and kernels
    assert any(s < kt and ks < t for s, t in copies for ks, kt in kernels)
