"""The port's ``Predictor`` against the JAX package's, on the same video
files and the same bridged weights, with the port on the CPU (the kernels
run their plain twins there).

Every field of every response is compared: keys, strings (the ``detail``
message included), bools, ints, track ids and frame spans equal;
probabilities (``confidence``, ``raw_confidence``,
``manipulation_probability``, ``window_confidences``,
``window_weighted_confidence``) within 1e-5; every other float within 1e-4.
No field is left out.

Both predictors run with cv2 visible: the pipelined path's host crops are
``cv2.resize`` in both packages (``test_torch_pipelined.py`` also holds the
numpy branch, with cv2 hidden on both sides).
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.predictor import Predictor as JPredictor
from lipsync_tpu.inference.predictor import PredictorConfig as JConfig
from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.predictor import Predictor, PredictorConfig
from lipsync_tpu_torch.preprocessing import mux
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from tests.fixtures import synthetic_frames, write_av_video
from tests.torch_parity import assert_same, seeded_pair

torch.set_num_threads(1)

BOX = (60, 70, 110, 105)
SECOND = (10, 10, 50, 40)

@pytest.fixture(scope="module")
def engines():
    _, cfg, variables, jcfg = seeded_pair(5, crop_size=48)
    return (ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False),
            JEngine(variables, jcfg, use_bfloat16=False), cfg, jcfg)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("predictor")
    return {
        # 8 frames: nb_frames == chunk_size, the short path.
        "short": write_av_video(d / "short.avi", synthetic_frames(n=8)),
        "long": write_av_video(d / "long.avi", synthetic_frames(n=40)),
        # A video stream only: scored against silence.
        "mute": mux.write_video(d / "mute.avi", synthetic_frames(n=8)),
    }


def predictors(engines, boxes, **knobs):
    port_engine, jax_engine, cfg, jcfg = engines
    knobs = {"chunk_size": 8, "chunk_stride": 4, **knobs}

    def backend(cls):
        # None: both packages' default chain (cascades + lip localizer).
        return None if boxes is None else cls(lambda i: list(boxes))

    port = Predictor(config=PredictorConfig(**knobs), model_config=cfg,
                     engine=port_engine, detector_backend=backend(FakeDetector),
                     device="cpu")
    reference = JPredictor(config=JConfig(**knobs), model_config=jcfg,
                           engine=jax_engine, detector_backend=backend(JFake))
    return port, reference


def jax_call(fn, *args):
    with jax.default_matmul_precision("highest"):
        return fn(*args)


CASES = {
    "short_one_track": ("short", [BOX], {}),
    "short_refined_two_tracks": ("short", [BOX, SECOND],
                                 {"refine_margin": 0.5}),
    "short_no_tracks": ("short", [], {}),
    "short_default_backend": ("short", None, {}),
    "short_silence": ("mute", [BOX], {}),
    "long_pipelined": ("long", [BOX], {}),
    "long_pipelined_two_tracks": ("long", [BOX, SECOND], {}),
    "long_batch": ("long", [BOX, SECOND], {"pipelined_long_video": False}),
    "long_no_tracks": ("long", [], {}),
    "long_default_backend": ("long", None, {}),
    "long_articulation": ("long", [BOX, SECOND],
                          {"speaking_score_mode": "articulation"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_matches_jax(engines, clips, case):
    clip, boxes, knobs = CASES[case]
    port, reference = predictors(engines, boxes, **knobs)
    got = port.predict(clips[clip])
    want = jax_call(reference.predict, clips[clip])
    assert_same(got, want)
    if case.endswith("no_tracks"):
        assert got["tracks"] is None


def test_predict_from_path_matches_jax(engines, clips):
    port, reference = predictors(engines, [BOX])
    got = port.predict_from_path(clips["long"])
    assert set(got) == {"verdict", "is_real", "is_fake", "confidence",
                        "manipulation_probability"}
    assert_same(got, jax_call(reference.predict_from_path, clips["long"]))


def test_missing_file_raises_as_in_jax(engines, tmp_path):
    port, reference = predictors(engines, [BOX])
    missing = tmp_path / "missing.avi"
    for p in (port, reference):
        with pytest.raises(FileNotFoundError):
            p.predict_from_path(missing)
    with pytest.raises(ValueError):
        port.predict(missing)
    with pytest.raises(ValueError):
        reference.predict(missing)


def test_predictor_defaults_to_cuda(engines, monkeypatch):
    """Without device="cpu" the predictor asks for the card and raises here;
    it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(engine=engines[0])


def test_model_path_required_as_in_jax(monkeypatch):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(ValueError, match="model_path or engine required"):
        Predictor(device="cpu")
    with pytest.raises(ValueError, match="model_path or engine required"):
        JPredictor()


@pytest.mark.parametrize("knob", [{"data_parallel_devices": 2}])
def test_options_not_ported_yet_raise(engines, clips, tmp_path, knob):
    """``data_parallel_devices`` was the option still to port; it builds a
    two-shard mesh now (the host twice on the CPU), and the predictor's
    response equals the one-device predictor's."""
    port_engine, _, cfg, _ = engines
    path = tmp_path / "w.pth"
    torch.save(port_engine.model.state_dict(), path)
    sharded = Predictor(model_path=path, config=PredictorConfig(
        chunk_size=8, chunk_stride=4, **knob), model_config=cfg,
        detector_backend=FakeDetector(lambda i: [BOX]), device="cpu")
    assert sharded.engine.mesh == [torch.device("cpu")] * 2
    port, _ = predictors(engines, [BOX])
    assert_same(sharded.predict(clips["long"]), port.predict(clips["long"]))


def test_predictor_from_a_weights_file(engines, clips, tmp_path):
    """``model_path`` loads the engine on the predictor's device; the
    response equals the one from the engine it was saved from."""
    port_engine, _, cfg, _ = engines
    path = tmp_path / "w.pth"
    torch.save(port_engine.model.state_dict(), path)
    knobs = PredictorConfig(chunk_size=8, chunk_stride=4)
    loaded = Predictor(model_path=path, config=knobs, model_config=cfg,
                       detector_backend=FakeDetector(lambda i: [BOX]),
                       device="cpu")
    assert loaded.engine.device == torch.device("cpu")
    port, _ = predictors(engines, [BOX])
    assert_same(loaded.predict(clips["short"]), port.predict(clips["short"]),
                tol=0.0)
    loaded.close()
    assert loaded.engine is None
    loaded.close()  # idempotent


@pytest.mark.parametrize("knobs", [
    {}, {"speaking_score_mode": "bogus", "turn_aware_aggregation": "x",
         "confidence_smoothing": "y", "trim_ratio": 0.9, "max_tracks": 0,
         "uncertainty_margin": -1.0, "refine_top_k": 0, "fake_vote_gate": 2.0,
         "detection_stride": 0, "data_parallel_devices": -3},
])
def test_predictor_config_matches_jax(knobs):
    assert vars(PredictorConfig(**knobs)) == vars(JConfig(**knobs))
