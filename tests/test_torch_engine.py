"""The port's crop, alignment, calibration and scoring engine against the
JAX package (CPU, fp32).

Tolerances: crops atol 1e-5; alignment exact; calibrated probabilities
1e-7; engine logits atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.calibration import Calibrator as JCalibrator
from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.policy import align_audio_chunk as j_align
from lipsync_tpu.preprocessing.video import (
    crop_track_on_device as j_crop_track,
)
from lipsync_tpu_torch.inference.calibration import Calibrator
from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
from lipsync_tpu_torch.inference.policy import align_audio_chunk
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
from lipsync_tpu_torch.preprocessing.video import _bucket, crop_track_on_device
from lipsync_tpu_torch.utils import synthetic
from tests.torch_parity import seeded_pair

torch.set_num_threads(1)


def _frames_and_boxes(rng, n=20, h=60, w=80):
    frames = rng.randint(0, 256, (n + 5, h, w, 3)).astype(np.uint8)
    boxes = []
    for _ in range(n):
        x1, y1 = rng.randint(-4, w - 10), rng.randint(-4, h - 10)
        bw, bh = rng.randint(1, 40), rng.randint(1, 30)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    return frames, boxes


@pytest.mark.parametrize("start", [0, 3])
def test_crop_track_on_device_matches_jax(start):
    frames, boxes = _frames_and_boxes(np.random.RandomState(start))
    got = crop_track_on_device(frames, boxes, start, crop_size=24,
                               device="cpu")
    want = j_crop_track(frames, boxes, start, crop_size=24)
    assert got.shape == want.shape == (20, 24, 24, 3)
    print(f"max |delta| crops start={start}: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_crop_bucket_and_empty_track():
    assert [_bucket(n) for n in (1, 32, 33, 100)] == [32, 32, 64, 128]
    out = crop_track_on_device(np.zeros((4, 8, 8, 3), np.uint8), [], 0,
                               crop_size=16, device="cpu")
    assert out.shape == (0, 16, 16, 3)


@pytest.mark.parametrize("reference_slice", [False, True])
@pytest.mark.parametrize("v_start,total_v", [(0, 150), (64, 150), (140, 150),
                                             (0, 20), (9, 12)])
def test_align_audio_chunk_matches_jax(reference_slice, v_start, total_v):
    mel = np.random.RandomState(v_start).randn(80, 1 + total_v * 100 // 15)
    got = align_audio_chunk(mel, v_start, total_v,
                            reference_slice=reference_slice)
    want = j_align(mel, v_start, total_v, reference_slice=reference_slice)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(method="none"),
    dict(method="temperature", temperature=1.7),
    dict(method="platt", platt_a=0.8, platt_b=-0.3),
])
def test_calibrator_matches_jax(kwargs):
    logits = np.linspace(-6, 6, 25).astype(np.float32)
    got = Calibrator.from_config(**kwargs)(logits)
    want = JCalibrator.from_config(**kwargs)(logits)
    print(f"max |delta| calibrator {kwargs['method']}: "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.fixture(scope="module")
def engines():
    model, cfg, variables, jcfg = seeded_pair(5)
    port = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False)
    jax_engine = JEngine(variables, jcfg, use_bfloat16=False)
    return port, jax_engine, cfg


def test_score_logits_matches_jax(engines):
    port, jax_engine, cfg = engines
    rng = np.random.RandomState(11)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)  # bucket 4
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    got = port.score_logits(vis, aud)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.score_logits(vis, aud)
    assert got.shape == want.shape == (3,)
    print(f"max |delta| score_logits: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.score_probs(vis, aud),
                               port.calibrator(got), atol=0, rtol=0)


def test_score_track_logits_matches_jax(engines):
    port, jax_engine, cfg = engines
    rng = np.random.RandomState(12)
    crops = rng.rand(19, 32, 32, 3).astype(np.float32)
    starts = [0, 5, 11]  # odd count: bucket 4, crop span padded to 32
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    got = port.score_track_logits(crops, starts, aud)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.score_track_logits(crops, starts, aud)
    assert got.shape == want.shape == (3,)
    print(f"max |delta| score_track_logits: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.score_track_probs(crops, starts, aud),
                               port.calibrator(got), atol=0, rtol=0)


def test_warmup_runs_the_canonical_shapes(engines):
    port, _, _ = engines
    port.warmup()


def test_track_windows_equal_direct_windows(engines):
    """The on-device gather scores the same windows as score_logits, and
    groups of max_batch stream back in order."""
    port, _, cfg = engines
    rng = np.random.RandomState(13)
    crops = (rng.rand(14, 32, 32, 3) * 255).astype(np.uint8)
    starts = [0, 2, 6]
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    direct = port.score_logits(
        np.stack([crops[s : s + 8] for s in starts]), aud)
    port.max_batch = 2
    try:
        tracked = port.score_track_logits(crops, starts, aud)
    finally:
        port.max_batch = 256
    np.testing.assert_allclose(tracked, direct, atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", ["mesh"])
def test_waiting_options_raise(option):
    """``mesh`` waited for data parallelism and is ported now: an engine
    over two shards scores as the engine on one device
    (``test_torch_parallel_engine.py`` holds it against the JAX mesh), and
    a mesh of things that are not devices still raises."""
    model, cfg, variables, _ = seeded_pair(5)
    with pytest.raises((TypeError, RuntimeError)):
        ScoringEngine(variables, cfg, device="cpu", **{option: [object()]})
    sharded = ScoringEngine(variables, cfg, use_bfloat16=False,
                            **{option: ["cpu", "cpu"]})
    single = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False)
    rng = np.random.RandomState(14)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    np.testing.assert_allclose(sharded.score_logits(vis, aud),
                               single.score_logits(vis, aud), atol=1e-5,
                               rtol=0)


def test_load_engine_needs_an_existing_path(tmp_path, monkeypatch):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(FileNotFoundError):
        load_engine(None, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_engine(tmp_path / "missing.pth", device="cpu")


@pytest.mark.parametrize("fmt", [".pth", ".npz"])
def test_load_engine_from_file(engines, tmp_path, fmt):
    port, _, cfg = engines
    _, _, variables, _ = seeded_pair(5)
    path = tmp_path / f"weights{fmt}"
    if fmt == ".pth":
        torch.save({"model_state_dict": port.model.state_dict()}, path)
    else:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = np.asarray(v)

        walk(variables, "")
        np.savez(path, **flat)
    loaded = load_engine(path, cfg, device="cpu", use_bfloat16=False)
    for k, v in port.model.state_dict().items():
        torch.testing.assert_close(loaded.model.state_dict()[k], v,
                                   atol=0, rtol=0)


def test_synthetic_track_windows_follow_the_request_path():
    """The measurement scripts' windows are the request's crops, sliced at
    the stride, with the aligned mel of each start."""
    req = synthetic.request(np.random.default_rng(0), 20, 20 / synthetic.FPS)
    visual, audio = synthetic.track_windows(req, 8, 32, 32, 6, device="cpu")
    frames, boxes, y = req
    crops = crop_track_on_device(frames, boxes, 0, 32, device="cpu")
    mel = preprocess_audio_pcm(y, device="cpu")
    assert visual.shape == (3, 8, 32, 32, 3)
    assert audio.shape == (3, 80, 32, 1)
    for i, s in enumerate((0, 6, 12)):
        np.testing.assert_array_equal(visual[i].numpy(), crops[s : s + 8])
        np.testing.assert_array_equal(
            audio[i, ..., 0].numpy(), align_audio_chunk(mel, s, 20, 32, 8))
