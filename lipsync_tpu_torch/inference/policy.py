"""Aggregation and guard policy: pure, deterministic numpy functions.

Counterpart of ``inference/policy.py`` in the JAX package, which gathers
every aggregation rule and conservative guard of the reference predictor
into standalone functions (the reference's ``predictor.py`` line numbers
are cited per function). Host side, no device code.

Native layouts: visual clips ``(T, H, W, 3)``, mel ``(F, T)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ── Robust aggregation (predictor.py:246-293) ─────────────────────────────


def robust_confidence(
    confidences: Sequence[float],
    smoothing: str = "median",
    trim_ratio: float = 0.1,
) -> float:
    if len(confidences) == 0:
        return 0.5
    arr = np.asarray(confidences, np.float32)
    if smoothing == "none":
        return float(arr.mean())
    if smoothing == "median":
        return float(np.median(arr))
    n = arr.size
    k = int(n * trim_ratio)
    if k <= 0 or 2 * k >= n:
        return float(arr.mean())
    return float(np.sort(arr)[k : n - k].mean())


def speech_weighted_confidence(
    confidences: Sequence[float],
    speaking_scores: Sequence[float],
    vad_weights: Optional[Sequence[float]] = None,
    smoothing: str = "median",
    trim_ratio: float = 0.1,
) -> float:
    """VAD(70%) + alignment(30%) soft weights with a 0.2 floor
    (predictor.py:262-293)."""
    if len(confidences) == 0:
        return 0.5
    if len(confidences) != len(speaking_scores):
        return robust_confidence(confidences, smoothing, trim_ratio)
    conf = np.asarray(confidences, np.float32)
    speech = np.clip(np.asarray(speaking_scores, np.float32), 0.0, 1.0)
    if vad_weights is not None and len(vad_weights) == len(confidences):
        vad = np.clip(np.asarray(vad_weights, np.float32), 0.0, 1.0)
        combined = 0.7 * vad + 0.3 * speech
    else:
        combined = speech
    weights = np.clip(0.2 + 0.8 * combined, 0.2, 1.0)
    denom = float(weights.sum())
    if denom <= 1e-8:
        return robust_confidence(confidences, smoothing, trim_ratio)
    return float(np.dot(conf, weights) / denom)


# ── Speaking-activity score (predictor.py:333-370) ────────────────────────


def speaking_alignment_score(visual: np.ndarray, audio: np.ndarray) -> float:
    """Z-normed correlation of mouth-motion energy vs audio energy -> [0, 1].

    visual (T, H, W, 3); audio (F, T_a)."""
    frames = visual.mean(axis=-1)  # (T, H, W)
    if frames.shape[0] < 2:
        return 0.5
    motion = np.abs(np.diff(frames, axis=0)).mean(axis=(1, 2))
    if motion.size == 0:
        return 0.5
    motion = np.concatenate([motion[:1], motion], axis=0)
    audio_energy = audio.mean(axis=0)  # (T_a,)
    if audio_energy.size < 2:
        return 0.5
    x_old = np.linspace(0.0, 1.0, num=motion.size)
    x_new = np.linspace(0.0, 1.0, num=audio_energy.size)
    motion_resampled = np.interp(x_new, x_old, motion)

    def z(x):
        sigma = float(x.std())
        if sigma < 1e-6:
            return x * 0.0
        return (x - float(x.mean())) / sigma

    m, a = z(motion_resampled), z(audio_energy)
    if float(np.abs(m).sum()) < 1e-6 or float(np.abs(a).sum()) < 1e-6:
        return 0.5
    corr = float(np.corrcoef(m, a)[0, 1])
    if np.isnan(corr):
        return 0.5
    return float(np.clip((corr + 1.0) * 0.5, 0.0, 1.0))


def speaking_articulation_score(visual: np.ndarray) -> float:
    """Audio-independent articulation activity in the mouth region -> [0, 1].

    The reference's only speaking signal is the motion<->audio-energy
    correlation above (predictor.py:334-370), which conflates "is
    speaking" with "is in sync": a DUBBED face articulates vigorously yet
    its motion does not track the dubbed audio's envelope, so the
    correlation sits near chance (0.5) and the face is never classified
    as a speaking track — the speaker-case/policy layer then judges the
    wrong (real, silent) face. Measured on the multiface production
    replay: listener mean activity 0.483 vs speaker 0.561 under the
    reference scorer (docs/eval/multiface_2f_r4.json).

    This scorer answers only "is the mouth articulating": mean per-frame
    motion in the lower (mouth) half of the crop, normalized by the
    crop's own contrast so lighting/resolution/bit-depth cancel, mapped
    through a logistic (midpoint 0.10, scale 0.03). The midpoint is
    cited to a SIX-family measurement (r4 VERDICT item 9,
    scripts/measure_articulation_bands.py ->
    docs/eval/articulation_bands_r5.json): original + fresh-seed 2f/3f
    scenes plus 0.7x/1.3x articulation-gain variants give speaker
    medians 0.125-0.155 and listener medians 0.080-0.090; 92-98% of
    speakers land above 0.10 and 85-100% of listeners below, including
    the weak-articulation variant. The bands overlap slightly near the
    midpoint (min speaker ~0.09, max listener ~0.12), which is why the
    blended score below keeps a 0.3 alignment term as the tie-breaker.

    visual (T, H, W, 3), any real dtype.
    """
    ratio = articulation_ratio(visual)
    if ratio is None:
        return 0.5
    return float(1.0 / (1.0 + np.exp(-(ratio - 0.10) / 0.03)))


def articulation_ratio(visual: np.ndarray) -> Optional[float]:
    """Pre-logistic articulation activity: mean inter-frame mouth motion
    over crop contrast. Exposed so the band calibration behind the 0.10
    midpoint / 0.03 scale above can be re-measured on new scene families
    (scripts/measure_articulation_bands.py). None when < 2 frames."""
    frames = np.asarray(visual, np.float32).mean(axis=-1)  # (T, H, W)
    if frames.shape[0] < 2:
        return None
    h = frames.shape[1]
    mouth = frames[:, h // 2 :, :]
    motion = np.abs(np.diff(mouth, axis=0)).mean(axis=(1, 2))
    scale = float(mouth.std()) + 1e-6
    return float(motion.mean()) / scale


def speaking_score(
    visual: np.ndarray, audio: np.ndarray, mode: str = "alignment"
) -> float:
    """Speaking-activity score under the configured semantics.

    ``alignment``    — reference parity (predictor.py:334-370).
    ``articulation`` — 0.7 * articulation + 0.3 * alignment: the visual
        articulation gate decides, the sync correlation only nudges.
        Separates speakers (incl. dubbed ones) from listeners where the
        reference scorer cannot; opt-in via
        ``PredictorConfig.speaking_score_mode``.
    """
    if mode == "articulation":
        return float(
            0.7 * speaking_articulation_score(visual)
            + 0.3 * speaking_alignment_score(visual, audio)
        )
    return speaking_alignment_score(visual, audio)


# ── Mouth motion energy check (predictor.py:372-461) ──────────────────────


def mouth_motion_energy_check(
    visual: np.ndarray,
    audio: np.ndarray,
    motion_low_threshold: float = 0.015,
    audio_high_threshold: float = -25.0,
    audio_low_threshold: float = -50.0,
) -> Dict[str, Any]:
    """likely_fake: loud audio + still mouth; uncertain: silent + still."""
    frames = visual.mean(axis=-1)  # (T, H, W)
    h = frames.shape[1]
    mouth = frames[:, h // 2 :, :]
    if mouth.shape[0] < 2:
        return {
            "audio_energy": 0.0,
            "mouth_motion_energy": 0.0,
            "check_result": "no_issue",
        }
    motion = float(np.abs(np.diff(mouth, axis=0)).mean())
    audio_energy = float(audio.mean())
    if audio_energy > audio_high_threshold and motion < motion_low_threshold:
        result = "likely_fake"
    elif audio_energy < audio_low_threshold and motion < motion_low_threshold:
        result = "uncertain"
    else:
        result = "no_issue"
    return {
        "audio_energy": round(audio_energy, 4),
        "mouth_motion_energy": round(motion, 6),
        "check_result": result,
    }


def aggregate_mouth_motion_check(
    checks: Sequence[Dict[str, Any]],
) -> Dict[str, Any]:
    """Majority voting over sampled windows (predictor.py:463-523)."""
    if not checks:
        return {
            "check_result": "no_data",
            "audio_energy": 0.0,
            "mouth_motion_energy": 0.0,
            "samples_checked": 0,
        }
    counts = {"likely_fake": 0, "uncertain": 0, "no_issue": 0}
    for c in checks:
        counts[c["check_result"]] = counts.get(c["check_result"], 0) + 1
    n = len(checks)
    if counts["uncertain"] > n // 2:
        agg = "uncertain"
    elif counts["likely_fake"] > counts["uncertain"] + counts["no_issue"]:
        agg = "likely_fake"
    else:
        agg = "no_issue"
    return {
        "check_result": agg,
        "audio_energy": round(
            float(np.median([c["audio_energy"] for c in checks])), 4
        ),
        "mouth_motion_energy": round(
            float(np.median([c["mouth_motion_energy"] for c in checks])), 6
        ),
        "samples_checked": n,
        "counts": counts,
    }


def sample_check_indices(n: int, max_samples: int = 5) -> List[int]:
    """Evenly-spaced sample indices, always including the last chunk
    (predictor.py:484-493)."""
    if n <= max_samples:
        return list(range(n))
    step = n / max_samples
    indices = [int(i * step) for i in range(max_samples)]
    if (n - 1) not in indices:
        indices[-1] = n - 1
    return indices


# ── Audio window alignment (predictor.py:525-552) ─────────────────────────


def align_audio_chunk(
    audio_full: np.ndarray,
    v_start: int,
    total_v_frames: int,
    chunk_a_size: int = 128,
    chunk_v_size: int = 32,
    reference_slice: bool = False,
) -> np.ndarray:
    """Mel (F, T_full) window aligned to video frames
    [v_start, v_start + chunk_v_size) -> (F, chunk_a_size).

    Default: the TRAINING alignment contract — slice the mel span that
    covers the visual window exactly (``chunk_v_size * T_a/T_v`` columns,
    e.g. 213 at 15 fps/100 Hz) and resample it to ``chunk_a_size`` with
    the same integer-linspace the training loader uses
    (reference dataset.py:428-446; the JAX package's training/data.py:148-159).

    ``reference_slice=True`` reproduces the reference's SERVING alignment
    instead (predictor.py:525-552): slice ``chunk_a_size`` RAW columns —
    only 1.28 s of the 2.13 s window, at a time scale the model never saw
    in training. That train/serve mismatch is a reference bug this
    rebuild does not inherit by default; the flag exists for A/B
    measurement (BENCHMARKS.md "Audio-window alignment").
    """
    total_a = audio_full.shape[1]
    a_ratio = total_a / max(1, total_v_frames)
    if reference_slice:
        a_start = int(round(v_start * a_ratio))
        a_end = a_start + chunk_a_size
        if a_end > total_a:
            a_end = total_a
            a_start = max(0, a_end - chunk_a_size)
        chunk = audio_full[:, a_start:a_end]
        if chunk.shape[1] < chunk_a_size:
            pad = np.repeat(
                chunk[:, -1:], chunk_a_size - chunk.shape[1], axis=1
            )
            chunk = np.concatenate([chunk, pad], axis=1)
        return chunk

    mel_len = max(1, int(round(chunk_v_size * a_ratio)))
    a_start = int(round(v_start * a_ratio))
    a_start = max(0, min(a_start, max(0, total_a - 1)))
    a_end = min(total_a, a_start + mel_len)
    chunk = audio_full[:, a_start:a_end]
    if chunk.shape[1] == 0:
        chunk = audio_full[:, -1:]
    if chunk.shape[1] < mel_len:
        pad = np.repeat(chunk[:, -1:], mel_len - chunk.shape[1], axis=1)
        chunk = np.concatenate([chunk, pad], axis=1)
    if chunk.shape[1] != chunk_a_size:
        idx = np.linspace(0, chunk.shape[1] - 1, chunk_a_size).astype(
            np.int64
        )
        chunk = chunk[:, idx]
    return chunk


# ── Long-video guard cascade (predictor.py:856-1155) ──────────────────────


@dataclasses.dataclass
class GuardInputs:
    window_confs: np.ndarray  # (W,) selected-window confidences in time order
    window_speaking: np.ndarray  # (W,)
    window_vad: Optional[np.ndarray]  # (W,) or None
    confidence_threshold: float = 0.5
    smoothing: str = "median"
    trim_ratio: float = 0.1
    fake_vote_gate: float = 0.15
    fake_vote_min_windows: int = 5
    weak_real_gate: float = 0.08
    weak_real_window_threshold: float = 0.30
    # Track id of each window's winning track (turn-aware mode). When set,
    # the mixed-consensus signal requires a SINGLE track to show both
    # strong-real and strong-fake windows: the reference counts strong
    # votes globally (predictor.py:1022-1033), so a real speaker and a
    # dubbed speaker alternating turns reads as "mixed evidence" and the
    # clip is refused as uncertain — measured at 75-100% uncertain on
    # turn_taking_dub scenes (docs/eval/multiface_*_r4_articulation.json).
    # Alternating verdicts across DIFFERENT subjects is turn-taking
    # structure, not contradictory evidence about one subject. An
    # improvement over the reference, opt-in via
    # PredictorConfig.turn_aware_aggregation.
    window_track_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class GuardOutputs:
    final_confidence: float
    final_is_real: bool
    window_median_confidence: float
    weighted_window_confidence: float
    strong_real: int
    strong_fake: int
    mixed_window_signal: bool
    temporal_drift: float
    temporal_confidence_drop: bool
    first_half_avg: float
    second_half_avg: float
    fake_vote_ratio: float
    strict_fake_evidence: bool
    meaningful_fake_evidence: bool
    window_consensus_uncertain: bool
    sparse_real_guard_applied: bool
    override_reason: Optional[str]
    conf_before_sparse: float


def run_guard_cascade(g: GuardInputs) -> GuardOutputs:
    """The ordered long-video guard cascade: blend -> temporal drift ->
    speech-weighted fake-vote ratio -> strict-fake evidence ->
    temporal-minority gate -> mixed-consensus override -> sparse-real guard.

    Order is behavior (SURVEY.md §3.2); this function IS the ordering."""
    thr = g.confidence_threshold
    conf_arr = np.asarray(g.window_confs, np.float32)
    speech_arr = np.asarray(g.window_speaking, np.float32)
    confs = [float(c) for c in conf_arr]

    window_median = robust_confidence(confs, g.smoothing, g.trim_ratio)
    weighted = speech_weighted_confidence(
        confs,
        [float(s) for s in speech_arr],
        vad_weights=None if g.window_vad is None else [float(v) for v in g.window_vad],
        smoothing=g.smoothing,
        trim_ratio=g.trim_ratio,
    )
    final_confidence = float(0.5 * window_median + 0.5 * weighted)

    real_gate = max(thr + 0.15, 0.65)
    fake_gate = min(thr - 0.15, 0.35)
    strong_real = int(np.sum(conf_arr >= real_gate))
    strong_fake = int(np.sum(conf_arr <= fake_gate))
    if (
        g.window_track_ids is not None
        and np.asarray(g.window_track_ids).size == conf_arr.size
    ):
        # Turn-aware: mixed evidence must be about ONE subject (see
        # GuardInputs.window_track_ids).
        ids = np.asarray(g.window_track_ids)
        mixed_window_signal = any(
            int(np.sum(conf_arr[ids == tid] >= real_gate)) >= 2
            and int(np.sum(conf_arr[ids == tid] <= fake_gate)) >= 2
            for tid in np.unique(ids)
        )
    else:
        mixed_window_signal = strong_real >= 2 and strong_fake >= 2

    # Temporal drift (predictor.py:892-909).
    n_w = conf_arr.size
    if n_w >= 4:
        half = n_w // 2
        first_half = float(conf_arr[:half].mean())
        second_half = float(conf_arr[half:].mean())
        drift = round(first_half - second_half, 4)
        temporal_drop = bool(drift >= 0.20)
    else:
        first_half = second_half = float(conf_arr.mean()) if n_w else 0.5
        drift = 0.0
        temporal_drop = False

    # Speech-weighted fake vote ratio (predictor.py:911-946).
    if g.window_vad is not None and len(g.window_vad) == n_w:
        vad_arr = np.clip(np.asarray(g.window_vad, np.float32), 0.0, 1.0)
        combined = np.clip(0.7 * vad_arr + 0.3 * speech_arr, 0.0, 1.0)
    else:
        combined = np.clip(speech_arr, 0.0, 1.0)
    speech_weights = np.clip(0.2 + 0.8 * combined, 0.2, 1.0)
    fake_intensity = np.clip(thr - conf_arr, 0.0, 1.0)
    denom_w = float(speech_weights.sum())
    fake_vote_ratio = (
        float(np.dot(speech_weights, fake_intensity) / denom_w)
        if denom_w > 1e-8
        else 0.0
    )
    fake_vote_ratio = float(np.clip(fake_vote_ratio / max(thr, 1e-6), 0.0, 1.0))

    # Strict fake evidence: hard ratio + >=8 consecutive fakes (:948-983).
    speech_mask = speech_arr >= 0.45
    vote_src = conf_arr[speech_mask] if np.any(speech_mask) else conf_arr
    fake_ratio_hard = (
        float(np.mean(vote_src < thr)) if vote_src.size else 0.0
    )
    max_consec = cur = 0
    for c in conf_arr:
        cur = cur + 1 if c < thr else 0
        max_consec = max(max_consec, cur)
    strict_fake = bool(fake_ratio_hard >= 0.70 and max_consec >= 8)

    # Temporal-minority fake gate (:985-1020).
    meaningful_fake = (
        fake_vote_ratio >= g.fake_vote_gate
        and strong_fake >= g.fake_vote_min_windows
    )
    if meaningful_fake:
        fake_signal_confidence = float(1.0 - fake_vote_ratio)
        final_confidence = float(
            0.3 * final_confidence + 0.7 * fake_signal_confidence
        )
        final_confidence = min(final_confidence, thr - 1e-4)

    final_is_real = final_confidence >= thr
    window_consensus_uncertain = False
    override_reason: Optional[str] = None

    # Mixed-consensus conservative override (:1022-1033).
    if (not final_is_real) and mixed_window_signal and (not strict_fake):
        window_consensus_uncertain = True
        override_reason = "window_consensus_mixed"
        final_confidence = float(max(final_confidence, thr))
        final_is_real = True

    # Sparse-real-signal guard (:1076-1105).
    max_window_conf = float(conf_arr.max()) if n_w else 0.0
    sparse_applied = False
    conf_before_sparse = final_confidence
    if (
        not final_is_real
        and max_window_conf >= g.weak_real_window_threshold
        and final_confidence < g.weak_real_gate
    ):
        conf_before_sparse = final_confidence
        sparse_applied = True
        override_reason = "sparse_real_signal"
        final_confidence = float(thr)
        final_is_real = True

    return GuardOutputs(
        final_confidence=final_confidence,
        final_is_real=final_is_real,
        window_median_confidence=window_median,
        weighted_window_confidence=weighted,
        strong_real=strong_real,
        strong_fake=strong_fake,
        mixed_window_signal=mixed_window_signal,
        temporal_drift=drift,
        temporal_confidence_drop=temporal_drop,
        first_half_avg=first_half,
        second_half_avg=second_half,
        fake_vote_ratio=fake_vote_ratio,
        strict_fake_evidence=strict_fake,
        meaningful_fake_evidence=meaningful_fake,
        window_consensus_uncertain=window_consensus_uncertain,
        sparse_real_guard_applied=sparse_applied,
        override_reason=override_reason,
        conf_before_sparse=conf_before_sparse,
    )


# ── Speaker cases + policy verdicts (predictor.py:1035-1074) ──────────────


def speaker_policies(
    sorted_tracks: List[Dict[str, Any]],
    best_is_fake: bool,
    speaking_activity_min: float = 0.50,
    stability_min: float = 0.20,
) -> Tuple[str, int, int, int, Dict[str, bool]]:
    """Returns (speaker_case, speaking_count, real_count, fake_count,
    policy verdicts)."""
    speaking = [
        tr
        for tr in sorted_tracks
        if float(tr.get("speaking_activity", 0.0)) >= speaking_activity_min
        and float(tr.get("stability", 0.0)) >= stability_min
    ] or sorted_tracks[: min(2, len(sorted_tracks))]
    count = len(speaking)
    fake = sum(1 for tr in speaking if tr["is_fake"])
    real = count - fake
    if fake == 0:
        case = "all_speaking_real"
    elif real == 0:
        case = "all_speaking_fake"
    else:
        case = "mixed_real_and_fake"
    verdicts = {
        "active_speaker_policy_is_fake": bool(best_is_fake),
        "any_speaking_fake_policy_is_fake": bool(fake > 0),
        "all_speaking_fake_policy_is_fake": bool(count > 0 and fake == count),
        "majority_speaking_fake_policy_is_fake": bool(fake > real),
    }
    return case, count, real, fake, verdicts


# ── Turn-aware per-segment verdicts (improvement over the reference) ──────
#
# The reference aggregates per-window winners GLOBALLY into one clip
# confidence (predictor.py:1538-1602): in a scene where a real speaker and
# a dubbed speaker alternate turns, real-looking and fake-looking windows
# interleave, the global blend lands near the threshold, and the
# mixed-consensus guard then refuses the clip as uncertain. Here each run
# of consecutive windows won by the same track — a speaker TURN — gets its
# own verdict from its own windows only; the clip verdict is then a policy
# over segment verdicts (any speaking segment fake -> clip fake, matching
# the reference's headline any_speaking_fake policy, predictor.py:1616).


def turn_aware_segment_verdicts(
    window_results: List[Dict[str, Any]],
    confidence_threshold: float = 0.5,
    smoothing: str = "median",
    trim_ratio: float = 0.1,
    min_windows: int = 2,
    speaking_min: float = 0.50,
) -> List[Dict[str, Any]]:
    """Group consecutive same-track window winners into segments and issue
    a verdict per segment.

    A segment is ``decided`` when it has >= ``min_windows`` windows (one
    stray window-winner flip is attribution noise, not a turn) and its mean
    speaking activity >= ``speaking_min`` (a silent span carries no sync
    evidence)."""
    segments: List[Dict[str, Any]] = []
    for wr in window_results:
        tid = int(wr["selected_track_id"])
        if segments and segments[-1]["track_id"] == tid:
            seg = segments[-1]
            seg["frame_end"] = max(seg["frame_end"], int(wr["frame_end"]))
            if "time_end_sec" in wr:
                seg["time_end_sec"] = float(wr["time_end_sec"])
        else:
            seg = {
                "track_id": tid,
                "frame_start": int(wr["frame_start"]),
                "frame_end": int(wr["frame_end"]),
                "_confs": [],
                "_speaking": [],
            }
            if "time_start_sec" in wr:
                seg["time_start_sec"] = float(wr["time_start_sec"])
                seg["time_end_sec"] = float(wr.get("time_end_sec", 0.0))
            segments.append(seg)
        seg["_confs"].append(float(wr["confidence"]))
        seg["_speaking"].append(float(wr.get("speaking_activity", 0.5)))

    for seg in segments:
        confs = seg.pop("_confs")
        speaking = seg.pop("_speaking")
        conf = robust_confidence(confs, smoothing, trim_ratio)
        activity = float(np.mean(speaking)) if speaking else 0.5
        seg["n_windows"] = len(confs)
        seg["confidence"] = round(float(conf), 4)
        seg["is_real"] = bool(conf >= confidence_threshold)
        seg["is_fake"] = bool(conf < confidence_threshold)
        seg["speaking_activity"] = round(activity, 4)
        seg["decided"] = bool(
            len(confs) >= min_windows and activity >= speaking_min
        )
    return segments


def aggregate_segment_verdicts(
    segments: List[Dict[str, Any]], confidence_threshold: float = 0.5
) -> Optional[Tuple[float, bool]]:
    """Clip verdict from decided segments: any fake speaking turn makes the
    clip fake (confidence = the worst fake segment's), otherwise real
    (median of segment confidences). None when no segment is decided —
    caller falls back to the guard-cascade result."""
    decided = [s for s in segments if s["decided"]]
    if not decided:
        return None
    fakes = [s for s in decided if s["is_fake"]]
    if fakes:
        conf = min(float(s["confidence"]) for s in fakes)
        return min(conf, confidence_threshold - 1e-4), False
    conf = float(np.median([float(s["confidence"]) for s in decided]))
    return max(conf, confidence_threshold), True


# ── Window winner + speaker timeline (predictor.py:749-854) ───────────────


def compress_speaker_timeline(
    window_results: List[Dict[str, Any]], with_time: bool = True
) -> List[Dict[str, Any]]:
    timeline: List[Dict[str, Any]] = []
    for wr in window_results:
        if (
            timeline
            and timeline[-1]["selected_track_id"] == wr["selected_track_id"]
            and wr["frame_start"] <= timeline[-1]["frame_end"]
        ):
            timeline[-1]["frame_end"] = max(
                timeline[-1]["frame_end"], wr["frame_end"]
            )
            if with_time and "time_end_sec" in wr:
                timeline[-1]["time_end_sec"] = wr["time_end_sec"]
        else:
            seg = {
                "selected_track_id": wr["selected_track_id"],
                "frame_start": wr["frame_start"],
                "frame_end": wr["frame_end"],
            }
            if with_time and "time_start_sec" in wr:
                seg["time_start_sec"] = wr["time_start_sec"]
                seg["time_end_sec"] = wr["time_end_sec"]
            timeline.append(seg)
    return timeline


def window_vad_coverage(
    vad_mask: np.ndarray, time_start_sec: float, time_end_sec: float
) -> float:
    """Map the VAD mask (mel frames @~100 Hz) onto a window's time span
    (predictor.py:804-816)."""
    mel_hop_ms = 160.0 / 16000.0 * 1000.0
    start = int(time_start_sec * 1000.0 / mel_hop_ms)
    end = int(time_end_sec * 1000.0 / mel_hop_ms)
    start = max(0, min(start, len(vad_mask) - 1))
    end = max(start + 1, min(end, len(vad_mask)))
    if end <= start:
        return 0.5
    return float(np.mean(vad_mask[start:end]))
