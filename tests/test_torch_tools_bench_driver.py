"""``lipsync_tpu_torch/tools/bench.py``, the port of the root benchmark
driver, on the CPU at the ``small_model_config`` geometry (8 frames of
48 x 48; widths narrowed to 64 so that the shared-encoding path, which
encodes the whole track once per engine group, stays in seconds):

- the JSON line's keys are those of the dict literal that root
  ``bench.py`` prints (read with ``ast``; the root file is never
  imported), less ``note``, which only its CPU fall-back prints; every
  number is finite and ``platform`` is ``"cpu"``;
- the engine path scores the pinned payload's 4 groups of
  ``engine_batch`` windows per call;
- ``flops_per_window`` is the counter's count of the forward with K2's
  plain twin in its place;
- without CUDA, ``main`` without ``--device cpu`` raises.
"""

import dataclasses
import math

import pytest
import torch

from conftest import small_model_config
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models import artifact as artifact_mod
from lipsync_tpu_torch.ops.kernels import hf_stem as k2
from lipsync_tpu_torch.tools import bench
from tests.test_torch_coverage import ROOT, _printed_keys

CFG = ModelConfig(**{**dataclasses.asdict(small_model_config()),
                     "visual_feature_dim": 64, "audio_feature_dim": 64,
                     "embed_dim": 64, "cross_modal_heads": 4,
                     "temporal_heads": 4, "temporal_layers": 2})
SIZES = bench.Sizes(model_batch=2, engine_batch=16, iters=1, train_batch=2)


@pytest.fixture(scope="module")
def report():
    torch.set_num_threads(1)
    engine_calls, marks = [], []
    real = ScoringEngine.score_logits

    def spy(self, visual, audio):
        engine_calls.append((self.max_batch, visual.shape, audio.shape))
        return real(self, visual, audio)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ScoringEngine, "score_logits", spy)
        out = bench.run(CFG, "cpu", SIZES, progress=marks.append)
    return out, engine_calls, marks


def test_the_keys_are_the_root_drivers_less_note(report):
    keys = _printed_keys(ROOT / "bench.py")
    assert "note" in keys and "engine_link_utilization" in keys
    assert set(report[0]) == keys - {"note"}


def test_every_number_is_finite_and_the_platform_is_cpu(report):
    out = report[0]
    for key, value in out.items():
        if isinstance(value, (int, float)):
            assert math.isfinite(value), key
    assert out["platform"] == "cpu" and out["dtype"] == "float32"
    assert out["model_batch"] == 2 and out["train_batch"] == 2
    # The CPU has no published peak here: the MFUs read 0.0.
    assert out["mfu"] == out["engine_mfu"] == out["train_mfu"] == 0.0
    assert out["engine_transfer_bound"] is False
    assert out["value"] > 0 and out["train_step_ms"] > 0
    assert any(m.startswith("no published peak") for m in report[2])


def test_the_engine_scores_four_groups_a_call(report):
    out, calls, _ = report
    n = 4 * SIZES.engine_batch
    assert out["engine_batch"] == SIZES.engine_batch
    # One warm call and max(3, iters // 4) timed ones.
    assert len(calls) == 4
    for max_batch, v_shape, a_shape in calls:
        assert max_batch == SIZES.engine_batch
        assert v_shape == (n, CFG.video_frames, CFG.crop_size,
                           CFG.crop_size, 3)
        assert a_shape[:3] == (n, CFG.mel_bins, CFG.audio_frames)
    per_window = (CFG.video_frames * CFG.crop_size ** 2 * 3
                  + 4 * CFG.mel_bins * CFG.audio_frames)
    assert out["engine_transfer_mb_per_call"] == pytest.approx(
        n * per_window / 1e6, rel=1e-12)


def test_the_flop_count_is_the_twin_forwards(report):
    """K2's wrapper is swapped for its twin while counting, so a kernel in
    a chain's place never changes the count."""
    from torch.utils.flop_counter import FlopCounterMode

    model = LipSyncModel(CFG).eval()
    v = torch.zeros(1, CFG.video_frames, CFG.crop_size, CFG.crop_size, 3)
    a = torch.zeros(1, CFG.mel_bins, CFG.audio_frames, 1)
    assert artifact_mod.hf_stem is k2.hf_stem  # restored after the run
    counter = FlopCounterMode(display=False)
    with pytest.MonkeyPatch.context() as mp, counter, torch.no_grad():
        mp.setattr(artifact_mod, "hf_stem", k2.hf_stem_plain)
        model(v, a)
    assert report[0]["flops_per_window"] == counter.get_total_flops() > 0


def test_main_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
