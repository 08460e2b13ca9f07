"""The port's aggregation and guard policy against the JAX package's, on the
inputs of the JAX package's own policy tests (``tests/test_policy.py``).

Tolerance: strings, bools, ints and verdicts equal; floats within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

from lipsync_tpu.inference import policy as j_policy
from lipsync_tpu_torch.inference import policy

RNG = np.random.RandomState(42)


def assert_same(got, want, path="result"):
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__, path
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(got, (float, np.floating)) and not isinstance(got, bool):
        assert isinstance(want, (float, np.floating)), path
        assert abs(float(got) - float(want)) <= 1e-6, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def both(name, *args, **kwargs):
    """The named function of both packages on the same arguments."""
    got = getattr(policy, name)(*args, **kwargs)
    want = getattr(j_policy, name)(*args, **kwargs)
    assert_same(got, want)
    return got


@pytest.mark.parametrize("smoothing", ["none", "median", "trimmed_mean"])
@pytest.mark.parametrize("n", [0, 1, 3, 10, 37])
def test_robust_confidence(smoothing, n):
    confs = list(np.random.RandomState(n).rand(n).astype(float))
    both("robust_confidence", confs, smoothing, 0.1)


@pytest.mark.parametrize("n", [0, 1, 5, 20])
@pytest.mark.parametrize("with_vad", [False, True])
def test_speech_weighted_confidence(n, with_vad):
    rng = np.random.RandomState(n)
    confs, speak, vad = (list(rng.rand(n)) for _ in range(3))
    both("speech_weighted_confidence", confs, speak,
         vad if with_vad else None)
    both("speech_weighted_confidence", confs, speak[: n // 2])


def _talking_and_still_crops(rng, t=32, s=48):
    base = rng.rand(s, s, 3).astype(np.float32)
    talking = np.repeat(base[None], t, axis=0)
    for i in range(t):
        h = int((s // 5) * (1 + np.sin(i * 0.9)))
        talking[i, s - s // 5 - h : s - s // 5, s // 4 : 3 * s // 4, :] = 0.05
    still = np.repeat(base[None], t, axis=0)
    still += rng.randn(t, s, s, 3).astype(np.float32) * 0.002
    return talking, still


@pytest.mark.parametrize("mode", ["alignment", "articulation"])
def test_speaking_scores(mode):
    rng = np.random.RandomState(1)
    talking, still = _talking_and_still_crops(rng)
    audio = (rng.rand(80, 64).astype(np.float32) * 60) - 60
    for visual in (talking, still, talking[:1], talking * 255.0):
        both("speaking_score", visual, audio, mode)
        both("speaking_alignment_score", visual, audio)
        both("speaking_articulation_score", visual)
        both("articulation_ratio", visual)


def _motion_cases():
    rng = np.random.RandomState(2)
    return [
        (rng.rand(8, 32, 32, 3).astype(np.float32),
         rng.rand(80, 32).astype(np.float32) * 30 - 30),  # loud, moving
        (np.full((8, 32, 32, 3), 0.5, np.float32),
         rng.rand(80, 32).astype(np.float32) * 5 - 10),  # loud, still
        (np.full((8, 32, 32, 3), 0.5, np.float32),
         np.full((80, 32), -70.0, np.float32)),  # silent, still
        (np.full((1, 32, 32, 3), 0.5, np.float32),
         np.full((80, 32), -70.0, np.float32)),  # one frame
    ]


@pytest.mark.parametrize("case", range(4))
def test_mouth_motion_energy_check(case):
    visual, audio = _motion_cases()[case]
    both("mouth_motion_energy_check", visual, audio)
    both("mouth_motion_energy_check", visual, audio,
         motion_low_threshold=0.5, audio_high_threshold=-40.0,
         audio_low_threshold=-20.0)


@pytest.mark.parametrize("results", [
    [], ["no_issue"], ["uncertain", "uncertain", "no_issue"],
    ["likely_fake", "likely_fake", "no_issue"],
    ["likely_fake", "uncertain", "no_issue", "no_issue"],
])
def test_aggregate_mouth_motion_check(results):
    checks = [{"check_result": r, "audio_energy": -10.0 * i,
               "mouth_motion_energy": 0.01 * i}
              for i, r in enumerate(results)]
    both("aggregate_mouth_motion_check", checks)


@pytest.mark.parametrize("n", [0, 1, 3, 5, 6, 50, 101])
def test_sample_check_indices(n):
    both("sample_check_indices", n)


def _guards(module, confs, speak=None, vad=None, **kw):
    confs = np.asarray(confs, np.float32)
    if speak is None:
        speak = np.full_like(confs, 0.8)
    return module.run_guard_cascade(module.GuardInputs(
        window_confs=confs, window_speaking=np.asarray(speak, np.float32),
        window_vad=None if vad is None else np.asarray(vad, np.float32),
        **kw))


GUARD_CASES = {
    "all_real": ([0.9] * 12, {}),
    "minority_fake": ([0.55] * 40 + [0.05] * 10, {}),
    "minority_below_min_windows": ([0.9] * 40 + [0.05] * 2, {}),
    "strict_fake_run": ([0.1] * 20 + [0.9] * 2, {}),
    "scattered_fake": (([0.1] * 7 + [0.9]) * 3, {}),
    "mixed": ([0.9, 0.85, 0.1, 0.05, 0.9, 0.08, 0.88, 0.07, 0.06], {}),
    "sparse_real": ([0.01] * 30 + [0.45], {}),
    "drift": ([0.9] * 10 + [0.4] * 10, {}),
    "minority_before_mixed": ([0.9] * 10 + [0.05] * 6, {}),
    "turn_ids": ([0.9, 0.05] * 4,
                 {"window_track_ids": np.asarray([1, 2] * 4)}),
    "one_subject_ids": ([0.9, 0.05] * 4,
                        {"window_track_ids": np.ones(8, np.int64)}),
    "empty": ([], {}),
    "with_vad": (list(RNG.rand(12)), {"vad": list(RNG.rand(12)),
                                      "speak": list(RNG.rand(12))}),
    "other_threshold": (list(RNG.rand(15)), {
        "confidence_threshold": 0.6, "smoothing": "trimmed_mean",
        "fake_vote_min_windows": 2}),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_run_guard_cascade(case):
    confs, kw = GUARD_CASES[case]
    assert_same(_guards(policy, confs, **kw), _guards(j_policy, confs, **kw))


def test_speaker_policies():
    tracks = [
        {"speaking_activity": 0.9, "stability": 0.8, "is_fake": False},
        {"speaking_activity": 0.8, "stability": 0.7, "is_fake": True},
        {"speaking_activity": 0.1, "stability": 0.9, "is_fake": True},
    ]
    for best_is_fake in (False, True):
        for threshold in (0.5, 0.55, 0.95):
            both("speaker_policies", tracks, best_is_fake,
                 speaking_activity_min=threshold)


def _win(tid, conf, start, speaking=0.8, timed=False):
    w = {"selected_track_id": tid, "confidence": conf, "frame_start": start,
         "frame_end": start + 32, "speaking_activity": speaking}
    if timed:
        w["time_start_sec"], w["time_end_sec"] = start / 15, (start + 32) / 15
    return w


SEGMENT_CASES = {
    "any_fake_turn": ([_win(1, 0.9, s) for s in range(0, 64, 8)]
                      + [_win(2, 0.05, s) for s in range(64, 128, 8)]
                      + [_win(1, 0.88, s) for s in range(128, 192, 8)]),
    "all_real": ([_win(1, 0.9, s) for s in range(0, 64, 8)]
                 + [_win(2, 0.8, s) for s in range(64, 128, 8)]),
    "undecided": [_win(1, 0.05, 0, speaking=0.2), _win(2, 0.9, 8)],
    "silent_fake": ([_win(1, 0.9, s) for s in range(0, 64, 8)]
                    + [_win(2, 0.1, s, speaking=0.2)
                       for s in range(64, 128, 8)]),
    "timed": [_win(t % 2, 0.3 + 0.1 * t, 8 * t, timed=True)
              for t in range(7)],
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_turn_aware_segments_and_timeline(case):
    wins = SEGMENT_CASES[case]
    segs = both("turn_aware_segment_verdicts", wins)
    both("aggregate_segment_verdicts", segs)
    both("compress_speaker_timeline", wins, with_time=False)
    both("compress_speaker_timeline", wins, with_time=True)


@pytest.mark.parametrize("span", [(0.0, 1.0), (1.0, 2.0), (0.5, 1.5),
                                  (1.99, 5.0), (3.0, 3.0)])
def test_window_vad_coverage(span):
    mask = np.array([1] * 100 + [0] * 100, bool)
    both("window_vad_coverage", mask, *span)


@pytest.mark.parametrize("reference_slice", [False, True])
def test_align_audio_chunk(reference_slice):
    full = RNG.rand(80, 300).astype(np.float32)
    for v_start, total_v in [(0, 100), (40, 100), (95, 100), (0, 10)]:
        got = policy.align_audio_chunk(full, v_start, total_v, 128,
                                       reference_slice=reference_slice)
        want = j_policy.align_audio_chunk(full, v_start, total_v, 128,
                                          reference_slice=reference_slice)
        np.testing.assert_array_equal(got, want)
