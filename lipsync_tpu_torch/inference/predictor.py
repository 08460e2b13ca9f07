"""Production inference orchestrator: a video file in, a verdict out.

Counterpart of ``inference/predictor.py`` in the JAX package, with the same
decisions and the same ~30-field response. Every model pass (every track,
chunk and refinement sub-window) goes through the port's
:class:`ScoringEngine` in a few padded batched forwards; every aggregation
rule and guard is a pure function in :mod:`lipsync_tpu_torch.inference.
policy`. Config knobs keep the reference's names and defaults.

Host work (decode, detection, tracking, policy) is numpy and Python; the
crops, the log-mel (K1) and the forward (K2 inside) run on ``device``,
which is the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.inference import policy
from lipsync_tpu_torch.inference.calibration import Calibrator
from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
from lipsync_tpu_torch.inference.pipelined import score_long_video_pipelined
from lipsync_tpu_torch.models import ModelConfig
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.audio import (
    detect_voice_activity,
    preprocess_audio,
    preprocess_audio_pcm,
)
from lipsync_tpu_torch.preprocessing.video import (
    preprocess_video,
    preprocess_video_tracks,
    preprocess_video_tracks_chunked,
)
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger
from lipsync_tpu_torch.utils.weights import default_checkpoint

logger = get_logger(__name__)


@dataclasses.dataclass
class PredictorConfig:
    """Knobs mirroring Predictor.__init__ (predictor.py:34-77) and the
    Settings object (config.py:8-81)."""

    confidence_threshold: float = 0.5
    uncertainty_margin: float = 0.05
    confidence_smoothing: str = "median"  # none | median | trimmed_mean
    trim_ratio: float = 0.1
    max_tracks: int = 6
    refine_margin: float = 0.08
    refine_top_k: int = 2
    chunk_size: int = 32
    chunk_stride: int = 8
    long_video_threshold_sec: float = 2.0
    max_total_frames: Optional[int] = None
    confidence_margin: float = 0.10
    # Calibration
    calibration_method: str = "none"
    calibration_temperature: float = 1.0
    calibration_platt_a: float = 1.0
    calibration_platt_b: float = 0.0
    calibration_isotonic_path: Optional[str] = None
    # Mouth motion energy check
    mouth_motion_check: bool = True
    mouth_motion_low_threshold: float = 0.015
    mouth_motion_fake_penalty: float = 0.10
    audio_energy_high_threshold: float = -25.0
    audio_energy_low_threshold: float = -50.0
    # Sparse-real-signal guard
    weak_real_gate: float = 0.08
    weak_real_window_threshold: float = 0.30
    # Temporal-minority fake gate
    fake_vote_gate: float = 0.15
    fake_vote_min_windows: int = 5
    # Pipelined long-video path: overlap host detection with device scoring
    # (falls back to the batch path for engines without async dispatch,
    # e.g. test stubs).
    pipelined_long_video: bool = True
    target_fps: float = 15.0
    # Host detector stride: detect every N-th frame, tracker coasts with
    # velocity extrapolation + lerp backfill in between (tracker.coast).
    # 1 = reference-parity per-frame detection; 2-3 cut single-core host
    # detection cost proportionally (crop-IoU cost measured in
    # scripts/eval_crop_agreement.py --stride).
    detection_stride: int = 1
    # Shared-track visual encoding in the long-video engine: encode each
    # track's frames ONCE and gather per-window features instead of
    # re-encoding every 75%-overlapping window (~2.8x fewer model FLOPs).
    # Off by default: interior windows see real neighbor frames instead of
    # per-window zero conv padding, a measured deviation vs the reference's
    # independent-window numerics (engine.py track_forward_shared).
    shared_visual_encoding: bool = False
    # Shard the window batch axis over the first N devices (0/1 = single
    # device; fewer when fewer exist; on the CPU the host N times), as the
    # JAX package's make_mesh(N) does (parallel/mesh.py).
    data_parallel_devices: int = 0
    # Quantized serving: encoder convs int8 x int8 -> int32 on K3
    # (models/layers.int8_conv); per-tensor activation scales make a
    # window's result depend weakly on its batch-mates.
    quantized_int8: bool = False
    # Serving lowering: compose the HF artifact stem's Laplacian into its
    # conv1 kernel. Exact interior; the strided border row/col deviates.
    fold_hf_stem: bool = False
    # Speaking-activity semantics. "alignment" = reference parity: the
    # motion<->audio-energy correlation (reference predictor.py:334-370),
    # which cannot mark a DUBBED face as speaking (its motion doesn't
    # track the dubbed audio), so speaker policies/timeline judge the
    # wrong track in dubbed scenes (measured: docs/eval/multiface_*_r4).
    # "articulation" = audio-independent mouth-motion gate blended with
    # the correlation (policy.speaking_score); window winners then weight
    # speaking at 0.50 instead of 0.10 so the timeline follows who is
    # ARTICULATING, not who looks most real.
    speaking_score_mode: str = "alignment"
    # Turn-aware multiface aggregation (an improvement over the reference, see
    # policy.turn_aware_segment_verdicts): per-speaker-turn verdicts +
    # single-subject mixed-consensus, instead of the reference's global
    # window blend that refuses real/dubbed turn-taking scenes as
    # uncertain (predictor.py:1538-1602,1022-1033; measured 75-100%
    # uncertain on turn_taking_dub, docs/eval/multiface_*_r4_articulation).
    # "auto" = on exactly when speaking_score_mode == "articulation" (the
    # timeline only follows who is SPEAKING in that mode); "on"/"off"
    # force it. The alignment default stays reference-parity.
    turn_aware_aggregation: str = "auto"

    def __post_init__(self):
        if self.speaking_score_mode not in {"alignment", "articulation"}:
            self.speaking_score_mode = "alignment"
        if self.turn_aware_aggregation not in {"auto", "on", "off"}:
            self.turn_aware_aggregation = "auto"
        if self.confidence_smoothing not in {"none", "median", "trimmed_mean"}:
            self.confidence_smoothing = "median"
        self.trim_ratio = float(min(max(self.trim_ratio, 0.0), 0.49))
        self.max_tracks = int(max(1, self.max_tracks))
        self.uncertainty_margin = max(0.0, self.uncertainty_margin)
        self.confidence_margin = max(0.0, self.confidence_margin)
        self.refine_margin = max(0.0, self.refine_margin)
        self.refine_top_k = int(max(1, self.refine_top_k))
        self.fake_vote_gate = float(max(0.0, min(1.0, self.fake_vote_gate)))
        self.fake_vote_min_windows = int(max(1, self.fake_vote_min_windows))
        self.detection_stride = int(max(1, self.detection_stride))
        if self.detection_stride > 2:
            # Measured safe envelope is 1-2: at stride 3+ the tracker's
            # coasting quality collapses on conversational head motion
            # (tracked-box IoU p10 0.578 at stride 3, 0.366 at stride 5,
            # vs 0.875 at stride 2 — BENCHMARKS.md "Detection stride").
            # Honored as requested, but loudly: crop quality drives every
            # downstream verdict.
            logger.warning(
                "detection_stride=%d is outside the measured safe envelope "
                "(1-2): tracked-crop IoU p10 falls to 0.578 at stride 3 and "
                "0.366 at stride 5 (BENCHMARKS.md). Expect degraded verdict "
                "quality on moving faces.",
                self.detection_stride,
            )
        self.data_parallel_devices = int(max(0, self.data_parallel_devices))


class Predictor:
    def __init__(
        self,
        model_path: Optional[Path] = None,
        config: PredictorConfig = PredictorConfig(),
        model_config: ModelConfig = ModelConfig(),
        engine: Optional[ScoringEngine] = None,
        detector_backend=None,
        device: DeviceLike = None,
    ):
        self.cfg = config
        self.model_config = model_config
        self.backend = detector_backend
        # Crops and the log-mel run here; None is the card (raises when
        # CUDA is absent), the CPU only when the caller asks for it.
        self.device = get_device(device)
        calibrator = Calibrator.from_config(
            method=config.calibration_method,
            temperature=config.calibration_temperature,
            platt_a=config.calibration_platt_a,
            platt_b=config.calibration_platt_b,
            isotonic_path=config.calibration_isotonic_path,
        )
        if engine is not None:
            self.engine = engine
            self.engine.calibrator = calibrator
        else:
            if model_path is None:
                model_path = default_checkpoint()
            if model_path is None:
                raise ValueError(
                    "model_path or engine required (no committed flagship "
                    "checkpoint found at weights/flagship)"
                )
            mesh = None
            if config.data_parallel_devices > 1:
                # The first n devices of the predictor's kind, fewer if
                # fewer exist (the host n times on the CPU).
                mesh = mesh_lib.make_mesh(config.data_parallel_devices,
                                          device_type=self.device.type)
            self.engine = load_engine(
                Path(model_path), model_config, calibrator=calibrator,
                shared_visual_encoding=config.shared_visual_encoding,
                mesh=mesh,
                quantized_int8=config.quantized_int8,
                fold_hf_stem=config.fold_hf_stem,
                device=self.device,
            )

    # ── Core scoring helpers ──────────────────────────────────────────────

    def _score_windows(
        self, visuals: List[np.ndarray], audios: List[np.ndarray]
    ) -> List[float]:
        """Score a list of same-shape windows in one batched forward."""
        if not visuals:
            return []
        v = np.stack(visuals, axis=0)
        a = np.stack(audios, axis=0)
        return [float(p) for p in self.engine.score_probs(v, a)]

    def _score_window_iter(self, pairs) -> List[float]:
        """Score an iterable of (visual, audio) windows in streamed groups
        of ``engine.max_batch`` so minutes-long videos never materialize
        every 75%-overlapping window at once.

        Groups are double-buffered through ``engine.dispatch_logits``:
        group k+1 is built and uploaded while group k computes, so the host
        and the device work at once instead of serializing upload ->
        compute -> readback per group."""
        group_size = getattr(self.engine, "max_batch", 128)
        in_flight = max(1, getattr(self.engine, "max_in_flight", 2))
        # Duck-typed engines (test stubs) without the async API fall back
        # to synchronous per-group scoring.
        dispatch = getattr(self.engine, "dispatch_logits", None)
        probs: List[float] = []
        pending: List[Tuple[object, int]] = []

        def drain_one() -> None:
            dev, size = pending.pop(0)
            logits = dev[:size].float().cpu().numpy()
            probs.extend(float(p) for p in self.engine.calibrator(logits))

        group_v: List[np.ndarray] = []
        group_a: List[np.ndarray] = []

        def flush() -> None:
            if not group_v:
                return
            if dispatch is None:
                probs.extend(self._score_windows(group_v, group_a))
                group_v.clear()
                group_a.clear()
                return
            v = np.stack(group_v, axis=0)
            a = np.stack(group_a, axis=0)
            pending.append((dispatch(v, a), len(group_v)))
            group_v.clear()
            group_a.clear()
            while len(pending) >= in_flight:
                drain_one()

        for visual, audio in pairs:
            group_v.append(visual)
            group_a.append(audio)
            if len(group_v) >= group_size:
                flush()
        flush()
        while pending:
            drain_one()
        return probs

    def _temporal_smoothed_confidence(
        self, visual: np.ndarray, audio: np.ndarray
    ) -> Tuple[float, List[float], List[Tuple[int, int]]]:
        """Full clip + 3 half-windows smoothing (predictor.py:295-331).
        The full clip and the three equal-shape sub-windows are scored as
        two batched calls (two static shapes)."""
        t_v, t_a = visual.shape[0], audio.shape[1]
        spans: List[Tuple[int, int]] = [(0, max(1, t_v))]
        sub_v: List[np.ndarray] = []
        sub_a: List[np.ndarray] = []
        sub_spans: List[Tuple[int, int]] = []
        win_v = max(12, t_v // 2)
        win_a = max(48, t_a // 2)
        if t_v >= win_v and t_a >= win_a:
            for v_start in (0, max(0, (t_v - win_v) // 2), max(0, t_v - win_v)):
                v_end = min(t_v, v_start + win_v)
                a_start = int(round(v_start * (t_a / max(1, t_v))))
                a_end = min(t_a, a_start + win_a)
                if (v_end - v_start) >= 16 and (a_end - a_start) >= 64:
                    sub_v.append(visual[v_start:v_end])
                    sub_a.append(audio[:, a_start:a_end])
                    sub_spans.append((v_start, v_end))
        confidences = self._score_windows([visual], [audio])
        if sub_v:
            # Sub-windows share one shape -> one more batched call.
            confidences += self._score_windows(sub_v, sub_a)
            spans += sub_spans
        agg = policy.robust_confidence(
            confidences, self.cfg.confidence_smoothing, self.cfg.trim_ratio
        )
        return agg, confidences, spans

    def _apply_mouth_motion_check(
        self, visual: np.ndarray, audio: np.ndarray, confidence: float
    ) -> Tuple[float, Dict[str, Any]]:
        """Single-window penalty/override (predictor.py:421-461)."""
        if not self.cfg.mouth_motion_check:
            return confidence, {"check_result": "disabled"}
        check = policy.mouth_motion_energy_check(
            visual, audio,
            motion_low_threshold=self.cfg.mouth_motion_low_threshold,
            audio_high_threshold=self.cfg.audio_energy_high_threshold,
            audio_low_threshold=self.cfg.audio_energy_low_threshold,
        )
        adjusted = confidence
        if check["check_result"] == "likely_fake":
            adjusted = float(
                max(0.0, confidence - self.cfg.mouth_motion_fake_penalty)
            )
        elif check["check_result"] == "uncertain":
            if confidence < self.cfg.confidence_threshold:
                adjusted = float(self.cfg.confidence_threshold)
        return adjusted, check

    def _audio_or_silence(
        self, audio_path: Path, target_frames: Optional[int]
    ) -> np.ndarray:
        """Load the mel spectrogram; if the container has no usable audio
        stream, degrade to silence of the video's duration rather than
        erroring the request (the reference 500s here — an intentional
        robustness improvement, consistent with its VAD all-speech
        fallback, audio.py:232-237)."""
        try:
            return preprocess_audio(audio_path, target_frames=target_frames,
                                    device=self.device)
        except ValueError:
            info = ingest.probe(audio_path)
            dur = max(1.0, info.duration_sec)
            logger.warning(
                "No audio stream in %s — scoring against %.1fs of silence",
                audio_path, dur,
            )
            silence = np.zeros(int(dur * 16000), np.float32)
            return preprocess_audio_pcm(silence, target_frames=target_frames,
                                        device=self.device)

    # ── Public API ────────────────────────────────────────────────────────

    def predict_from_path(self, video_path: Path) -> Dict[str, Any]:
        """Single-window scoring of a file (predictor.py:1740-1781)."""
        video_path = Path(video_path)
        if not video_path.is_file():
            raise FileNotFoundError(f"Video file not found: {video_path}")
        visual = preprocess_video(
            video_path, backend=self.backend,
            max_frames=self.model_config.video_frames,
            crop_size=self.model_config.crop_size,
            device=self.device,
        )
        audio = self._audio_or_silence(
            video_path, self.model_config.audio_frames
        )
        confidence = self._score_windows([visual], [audio])[0]
        is_real = confidence >= self.cfg.confidence_threshold
        return {
            "verdict": "real" if is_real else "fake",
            "is_real": is_real,
            "is_fake": not is_real,
            "confidence": confidence,
            "manipulation_probability": float(1.0 - confidence),
        }

    def predict(self, video_path: Path) -> Dict[str, Any]:
        """Full production pipeline on a file (the predict_from_upload logic,
        predictor.py:1277-1738, minus the upload temp-file handling which
        lives in the serving layer)."""
        t_start = perf_counter()
        video_path = Path(video_path)
        info = ingest.probe(video_path)
        is_long = info.nb_frames > self.cfg.chunk_size
        if is_long:
            return self._predict_long_video(video_path, video_path, t_start)
        return self._predict_short_video(video_path, video_path, t_start)

    def close(self) -> None:
        """Release device state, as the reference predictor frees its model
        on shutdown: drops the engine's model and returns the cached device
        memory. The Predictor is unusable afterwards."""
        engine = getattr(self, "engine", None)
        if engine is not None:
            closer = getattr(engine, "close", None)
            if callable(closer):  # CoalescingEngine: stop the dispatcher
                closer()
            try:
                del engine.model
            except AttributeError:  # no model, or a CoalescingEngine's
                pass
            self.engine = None
            torch.cuda.empty_cache()

    # ── Short-video path (predictor.py:1307-1733) ─────────────────────────

    def _predict_short_video(
        self, video_path: Path, audio_path: Path, t_start: float
    ) -> Dict[str, Any]:
        cfg = self.cfg
        t_pre_start = perf_counter()
        tracks = preprocess_video_tracks(
            video_path,
            max_tracks=cfg.max_tracks,
            max_frames=self.model_config.video_frames,
            crop_size=self.model_config.crop_size,
            backend=self.backend,
            max_total_frames=cfg.max_total_frames,
            device=self.device,
        )
        audio_np = self._audio_or_silence(
            audio_path, self.model_config.audio_frames
        )
        t_pre_end = perf_counter()
        logger.info(
            "Preprocessing completed in %.1f ms, %d face track(s)",
            (t_pre_end - t_pre_start) * 1e3, len(tracks),
        )

        if not tracks:
            return self._predict_single_face(
                video_path, audio_np, t_start, t_pre_end - t_pre_start
            )

        # Phase 1: ALL tracks scored in one batched forward.
        t_inf_start = perf_counter()
        clips = [tr["clip"] for tr in tracks]
        confs = self._score_windows(clips, [audio_np] * len(clips))

        track_results: List[Dict[str, Any]] = []
        track_clip_map: Dict[int, np.ndarray] = {}
        for tr, raw_confidence in zip(tracks, confs):
            track_id = int(tr["track_id"])
            visual_np = tr["clip"]
            track_clip_map[track_id] = visual_np
            stability = float(tr.get("stability", 0.0))
            speaking = policy.speaking_score(
                visual_np, audio_np, cfg.speaking_score_mode
            )
            selection = 0.65 * raw_confidence + 0.20 * stability + 0.15 * speaking
            is_real = raw_confidence >= cfg.confidence_threshold
            track_results.append({
                "track_id": track_id,
                "is_real": is_real,
                "is_fake": not is_real,
                "confidence": float(raw_confidence),
                "raw_confidence": float(raw_confidence),
                "manipulation_probability": float(1.0 - raw_confidence),
                "stability": stability,
                "hits": int(tr.get("hits", 0)),
                "total_frames": int(tr.get("total_frames", 0)),
                "speaking_activity": float(speaking),
                "selection_score": float(selection),
                "window_confidences": [float(raw_confidence)],
                "window_spans": [(0, int(visual_np.shape[0]))],
                "consecutive_miss_max": int(tr.get("consecutive_miss_max", 0)),
                # Mean mouth box in source pixels: lets a caller attribute
                # each track to a subject in multi-face scenes
                # (scripts/eval_multiface.py matches on it).
                "bbox": [round(float(v), 1) for v in tr.get(
                    "mean_bbox", (0.0, 0.0, 0.0, 0.0)
                )],
            })

        # Adaptive phase 2: refine only when competition is close
        # (predictor.py:1449-1487).
        quick_sorted = sorted(
            track_results, key=lambda t: t["selection_score"], reverse=True
        )
        quick_margin = (
            quick_sorted[0]["selection_score"] - quick_sorted[1]["selection_score"]
            if len(quick_sorted) > 1 else 1.0
        )
        needs_refine = quick_margin < cfg.refine_margin
        if needs_refine:
            for tr in quick_sorted[: cfg.refine_top_k]:
                visual_np = track_clip_map[int(tr["track_id"])]
                smoothed, samples, spans = self._temporal_smoothed_confidence(
                    visual_np, audio_np
                )
                tr["confidence"] = float(smoothed)
                tr["manipulation_probability"] = float(1.0 - smoothed)
                tr["is_real"] = bool(smoothed >= cfg.confidence_threshold)
                tr["is_fake"] = not tr["is_real"]
                tr["window_confidences"] = [float(v) for v in samples]
                tr["window_spans"] = [(int(s), int(e)) for s, e in spans]
                tr["selection_score"] = (
                    0.55 * tr["confidence"]
                    + 0.25 * float(tr["stability"])
                    + 0.20 * float(tr["speaking_activity"])
                )
        t_inf_end = perf_counter()

        sorted_tracks = sorted(
            track_results, key=lambda t: t["selection_score"], reverse=True
        )
        best_result = sorted_tracks[0]
        best_track_id = int(best_result["track_id"])
        selection_margin = (
            float(sorted_tracks[0]["selection_score"]
                  - sorted_tracks[1]["selection_score"])
            if len(sorted_tracks) > 1 else 1.0
        )
        selection_uncertain = selection_margin < cfg.uncertainty_margin
        if len(sorted_tracks) > 1:
            conf_gap = abs(
                sorted_tracks[0]["confidence"] - sorted_tracks[1]["confidence"]
            )
            confidence_margin_uncertain = conf_gap < cfg.confidence_margin
        else:
            conf_gap, confidence_margin_uncertain = 1.0, False

        # Per-window winners (skip index 0 = full clip, predictor.py:1538-1583).
        max_windows = max(
            (len(t.get("window_confidences", [])) for t in sorted_tracks),
            default=0,
        )
        window_results: List[Dict[str, Any]] = []
        if max_windows > 1:
            t_a = audio_np.shape[1]
            for w_idx in range(1, max_windows):
                candidates = [
                    t for t in sorted_tracks
                    if len(t.get("window_confidences", [])) > w_idx
                ]
                if not candidates:
                    continue

                def window_score(t):
                    start, end = t["window_spans"][w_idx]
                    clip = track_clip_map[int(t["track_id"])]
                    t_v = clip.shape[0]
                    a_start = int(round(start * (t_a / max(1, t_v))))
                    a_end = int(round(end * (t_a / max(1, t_v))))
                    a_start = max(0, min(a_start, t_a - 1))
                    a_end = max(a_start + 1, min(a_end, t_a))
                    win_speaking = policy.speaking_score(
                        clip[start:end], audio_np[:, a_start:a_end],
                        cfg.speaking_score_mode,
                    )
                    if cfg.speaking_score_mode == "articulation":
                        # The window winner should be whoever is SPEAKING
                        # in this span; its confidence then carries the
                        # verdict. The parity weights (0.75 conf) pick the
                        # most real-looking track instead, which inverts
                        # the timeline in dubbed scenes.
                        return (
                            0.35 * float(t["window_confidences"][w_idx])
                            + 0.15 * float(t.get("stability", 0.0))
                            + 0.50 * win_speaking
                        )
                    return (
                        0.75 * float(t["window_confidences"][w_idx])
                        + 0.15 * float(t.get("stability", 0.0))
                        + 0.10 * win_speaking
                    )

                win_best = max(candidates, key=window_score)
                start, end = win_best["window_spans"][w_idx]
                win_conf = float(win_best["window_confidences"][w_idx])
                window_results.append({
                    "window_index": int(w_idx - 1),
                    "frame_start": int(start),
                    "frame_end": int(end),
                    "selected_track_id": int(win_best["track_id"]),
                    "confidence": win_conf,
                    "is_real": bool(win_conf >= cfg.confidence_threshold),
                    "is_fake": bool(win_conf < cfg.confidence_threshold),
                })

        speaker_timeline = policy.compress_speaker_timeline(
            window_results, with_time=False
        )

        # Speaking-track policies (threshold 0.55 on the short path,
        # predictor.py:1606-1631).
        case, s_count, s_real, s_fake, verdicts = policy.speaker_policies(
            sorted_tracks, bool(best_result["is_fake"]),
            speaking_activity_min=0.55,
        )

        if window_results:
            window_conf = [float(w["confidence"]) for w in window_results]
            window_agg_conf = policy.robust_confidence(
                window_conf, cfg.confidence_smoothing, cfg.trim_ratio
            )
            window_agg_is_real = window_agg_conf >= cfg.confidence_threshold
            unique_speakers = len(
                {w["selected_track_id"] for w in window_results}
            )
        else:
            window_agg_conf = float(best_result["confidence"])
            window_agg_is_real = bool(best_result["is_real"])
            unique_speakers = 1

        final_is_real = bool(best_result["is_real"])
        final_confidence = float(best_result["confidence"])
        if unique_speakers > 1:
            final_is_real = bool(window_agg_is_real)
            final_confidence = float(window_agg_conf)

        best_visual = track_clip_map.get(best_track_id)
        if best_visual is not None:
            final_confidence, mouth_check = self._apply_mouth_motion_check(
                best_visual, audio_np, final_confidence
            )
            final_is_real = final_confidence >= cfg.confidence_threshold
        else:
            mouth_check = {"check_result": "no_data"}

        t_end = perf_counter()
        logger.info(
            "Inference completed: %d tracks, best=%s, conf=%.4f, "
            "total_ms=%.1f infer_ms=%.1f",
            len(track_results), best_track_id, final_confidence,
            (t_end - t_start) * 1e3, (t_inf_end - t_inf_start) * 1e3,
        )

        result: Dict[str, Any] = {
            "verdict": "real" if final_is_real else "fake",
            "is_real": final_is_real,
            "is_fake": not final_is_real,
            "confidence": final_confidence,
            "manipulation_probability": float(1.0 - final_confidence),
            "selection_uncertain": selection_uncertain,
            "selection_margin": selection_margin,
            "confidence_margin_uncertain": bool(confidence_margin_uncertain),
            "confidence_gap": float(conf_gap),
            "turn_taking_detected": bool(unique_speakers > 1),
            "speaker_case": case,
            "speaking_tracks_count": s_count,
            "speaking_real_count": s_real,
            "speaking_fake_count": s_fake,
            "verdicts": verdicts,
            "window_results": window_results or None,
            "speaker_timeline": speaker_timeline or None,
            "mouth_motion_check": mouth_check,
            "tracks": sorted_tracks,
            "selected_track_id": best_track_id,
        }

        turn_taking = unique_speakers > 1
        if turn_taking:
            spans_str = " → ".join(
                f"track_{seg['selected_track_id']} "
                f"(frames {seg['frame_start']}-{seg['frame_end']})"
                for seg in speaker_timeline
            )
            result["detail"] = (
                f"Speaker turn-taking detected across {len(speaker_timeline)} "
                f"segment(s): {spans_str}. Final verdict is window-aggregated "
                f"(confidence={final_confidence:.4f})."
            )
            result["selection_uncertain"] = False
        elif selection_uncertain:
            result["detail"] = (
                f"Track selection uncertain: top-two selection scores are too "
                f"close (margin={selection_margin:.4f}, "
                f"threshold={cfg.uncertainty_margin:.4f}). Consider using a "
                f"longer clip for more reliable results."
            )
        return result

    def _predict_single_face(
        self,
        video_path: Path,
        audio_np: np.ndarray,
        t_start: float,
        preproc_sec: float,
    ) -> Dict[str, Any]:
        """No-tracks fallback (predictor.py:1330-1400)."""
        visual_np = preprocess_video(
            video_path, backend=self.backend,
            max_frames=self.model_config.video_frames,
            crop_size=self.model_config.crop_size,
            max_total_frames=self.cfg.max_total_frames,
            device=self.device,
        )
        confidence = self._score_windows([visual_np], [audio_np])[0]
        confidence, mouth_check = self._apply_mouth_motion_check(
            visual_np, audio_np, confidence
        )
        is_real = confidence >= self.cfg.confidence_threshold
        return {
            "verdict": "real" if is_real else "fake",
            "is_real": is_real,
            "is_fake": not is_real,
            "confidence": float(confidence),
            "manipulation_probability": float(1.0 - confidence),
            "tracks": None,
            "selected_track_id": None,
            "mouth_motion_check": mouth_check,
        }

    # ── Long-video path (predictor.py:582-1275) ───────────────────────────

    def _predict_long_video(
        self, video_path: Path, audio_path: Path, t_start: float
    ) -> Dict[str, Any]:
        cfg = self.cfg
        t_pre_start = perf_counter()
        audio_np_full = self._audio_or_silence(audio_path, None)  # (F, T_full)
        total_a_frames = audio_np_full.shape[1]
        try:
            vad_mask, _ = detect_voice_activity(audio_path)
        except Exception as e:
            logger.warning("VAD detection failed, using fallback: %s", e)
            vad_mask = np.ones(total_a_frames, dtype=bool)

        pipelined_probs: Optional[Dict[int, List[float]]] = None
        if cfg.pipelined_long_video and hasattr(
            self.engine, "dispatch_track_logits"
        ):
            # Overlapped path: detection (host) and scoring (device) run
            # concurrently through async dispatch (inference/pipelined.py).
            frames = ingest.read_video(
                video_path, cfg.target_fps, cfg.max_total_frames
            )
            fps, total_v_frames = cfg.target_fps, len(frames)
            chunked_tracks, pipelined_probs = score_long_video_pipelined(
                frames, audio_np_full, self.engine,
                backend=self.backend,
                chunk_size=cfg.chunk_size,
                stride=cfg.chunk_stride,
                max_tracks=cfg.max_tracks,
                crop_size=self.model_config.crop_size,
                audio_frames=self.model_config.audio_frames,
                detection_stride=cfg.detection_stride,
            )
        else:
            chunked_tracks, fps, total_v_frames = (
                preprocess_video_tracks_chunked(
                    video_path,
                    chunk_size=cfg.chunk_size,
                    stride=cfg.chunk_stride,
                    max_tracks=cfg.max_tracks,
                    crop_size=self.model_config.crop_size,
                    max_total_frames=cfg.max_total_frames,
                    backend=self.backend,
                    device=self.device,
                )
            )
        t_pre_end = perf_counter()
        logger.info(
            "Long-video preprocessing: %.1fs video, %d frames, %d audio "
            "frames, %d track(s), %.1f ms",
            total_v_frames / max(1.0, fps), total_v_frames, total_a_frames,
            len(chunked_tracks), (t_pre_end - t_pre_start) * 1e3,
        )
        if not chunked_tracks:
            return self._no_tracks_result(total_v_frames, fps)

        # ── Score EVERY (track, chunk) window in one batched pass ─────────
        t_inf_start = perf_counter()
        index: List[Tuple[int, int]] = []  # (track_idx, chunk_idx)
        for ti, tr in enumerate(chunked_tracks):
            for ci in range(tr.num_chunks):
                index.append((ti, ci))

        if pipelined_probs is not None:
            # Already scored during detection (overlapped); flatten in the
            # same (track, chunk) order the index expects.
            all_probs = [
                p for ti in range(len(chunked_tracks))
                for p in pipelined_probs[ti]
            ]
        elif hasattr(self.engine, "score_track_probs"):
            # Zero-copy path: upload each track's crop sequence once and
            # gather the 75%-overlapping windows on device.
            all_probs = []
            for tr in chunked_tracks:
                audio_windows = np.stack([
                    policy.align_audio_chunk(
                        audio_np_full, abs_start, total_v_frames,
                        chunk_a_size=self.model_config.audio_frames,
                        chunk_v_size=cfg.chunk_size,
                    )
                    for abs_start in tr.abs_chunk_starts
                ])
                all_probs.extend(
                    float(p) for p in self.engine.score_track_probs(
                        tr.crops, tr.chunk_starts, audio_windows
                    )
                )
        else:
            def window_pairs():
                for ti, ci in index:
                    tr = chunked_tracks[ti]
                    yield (
                        tr.chunk(ci),
                        policy.align_audio_chunk(
                            audio_np_full, tr.abs_chunk_starts[ci],
                            total_v_frames,
                            chunk_a_size=self.model_config.audio_frames,
                        chunk_v_size=cfg.chunk_size,
                        ),
                    )

            # Streamed scoring: windows materialize per max_batch group.
            all_probs = self._score_window_iter(window_pairs())
        probs_by_track: Dict[int, List[float]] = {}
        for (ti, ci), p in zip(index, all_probs):
            probs_by_track.setdefault(ti, []).append(p)

        track_results: List[Dict[str, Any]] = []
        for ti, tr in enumerate(chunked_tracks):
            chunk_confs = probs_by_track[ti]
            if cfg.speaking_score_mode == "articulation":
                # A turn-taking speaker is silent half its chunks; those
                # windows carry no sync evidence yet read "real", so the
                # plain median dilutes a dubbed track toward real
                # (measured: turn-taking speaker_verdict_accuracy 0.625
                # vs 1.0 on always-speaking scenes). Weight each chunk by
                # its articulation gate — the same 0.2-floor soft
                # weighting the reference applies to the best track's
                # windows (speech_weighted_confidence).
                chunk_artic = [
                    policy.speaking_articulation_score(tr.chunk(ci))
                    for ci in range(tr.num_chunks)
                ][: len(chunk_confs)]
                agg_conf = policy.speech_weighted_confidence(
                    chunk_confs, chunk_artic,
                    smoothing=cfg.confidence_smoothing,
                    trim_ratio=cfg.trim_ratio,
                )
            else:
                agg_conf = policy.robust_confidence(
                    chunk_confs, cfg.confidence_smoothing, cfg.trim_ratio
                )
            mid = tr.num_chunks // 2
            speaking = policy.speaking_score(
                tr.chunk(mid),
                policy.align_audio_chunk(
                    audio_np_full, tr.abs_chunk_starts[mid], total_v_frames,
                    chunk_a_size=self.model_config.audio_frames,
                        chunk_v_size=cfg.chunk_size,
                ),
                cfg.speaking_score_mode,
            )
            selection = 0.65 * agg_conf + 0.20 * tr.stability + 0.15 * speaking
            is_real = agg_conf >= cfg.confidence_threshold
            track_results.append({
                "track_id": tr.track_id,
                "is_real": is_real,
                "is_fake": not is_real,
                "confidence": float(agg_conf),
                "raw_confidence": float(chunk_confs[0]) if chunk_confs else float(agg_conf),
                "manipulation_probability": float(1.0 - agg_conf),
                "stability": tr.stability,
                "hits": tr.hits,
                "total_frames": total_v_frames,
                "track_start_frame": tr.track_start_frame,
                "track_end_frame": tr.track_end_frame,
                "speaking_activity": float(speaking),
                "selection_score": float(selection),
                "window_confidences": [float(c) for c in chunk_confs],
                "window_spans": [
                    (int(s), int(s + cfg.chunk_size))
                    for s in tr.abs_chunk_starts
                ],
                "consecutive_miss_max": tr.consecutive_miss_max,
                "bbox": [round(float(v), 1) for v in tr.mean_bbox],
                "_track_idx": ti,
            })
        t_inf_end = perf_counter()

        sorted_tracks = sorted(
            track_results, key=lambda t: t["selection_score"], reverse=True
        )
        best_result = sorted_tracks[0]
        best_track_id = int(best_result["track_id"])
        selection_margin = (
            float(sorted_tracks[0]["selection_score"]
                  - sorted_tracks[1]["selection_score"])
            if len(sorted_tracks) > 1 else 1.0
        )
        selection_uncertain = selection_margin < cfg.uncertainty_margin
        if len(sorted_tracks) > 1:
            conf_gap = abs(
                sorted_tracks[0]["confidence"] - sorted_tracks[1]["confidence"]
            )
            confidence_margin_uncertain = conf_gap < cfg.confidence_margin
        else:
            conf_gap, confidence_margin_uncertain = 1.0, False

        total_chunks = sum(len(t["window_confidences"]) for t in sorted_tracks)
        max_chunks = max(
            (len(t["window_confidences"]) for t in sorted_tracks), default=0
        )

        # Per-time-position window winners over ABSOLUTE starts
        # (predictor.py:749-830).
        by_abs_start: Dict[int, List[Tuple[Dict[str, Any], int]]] = {}
        for t in sorted_tracks:
            for i, span in enumerate(t["window_spans"]):
                by_abs_start.setdefault(int(span[0]), []).append((t, i))

        chunk_window_results: List[Dict[str, Any]] = []
        for abs_start in sorted(by_abs_start):
            candidates = by_abs_start[abs_start]
            if cfg.speaking_score_mode == "articulation":
                # Winner = whoever is articulating in this span (see the
                # short-path window_score note); per-candidate motion gate
                # is audio-free and cheap (one diff over a 32-frame chunk).
                def _artic(c):
                    t, i = c
                    tr_o = chunked_tracks[t["_track_idx"]]
                    if i >= tr_o.num_chunks:
                        return float(t.get("speaking_activity", 0.5))
                    return policy.speaking_articulation_score(tr_o.chunk(i))

                win_tr, win_i = max(
                    candidates,
                    key=lambda c: (
                        0.35 * float(c[0]["window_confidences"][c[1]])
                        + 0.15 * float(c[0].get("stability", 0.0))
                        + 0.50 * _artic(c)
                    ),
                )
            else:
                win_tr, win_i = max(
                    candidates,
                    key=lambda c: (
                        0.75 * float(c[0]["window_confidences"][c[1]])
                        + 0.25 * float(c[0].get("stability", 0.0))
                    ),
                )
            v_start = int(win_tr["window_spans"][win_i][0])
            v_end = int(win_tr["window_spans"][win_i][1])
            win_conf = float(win_tr["window_confidences"][win_i])
            tr_obj = chunked_tracks[win_tr["_track_idx"]]
            win_speaking = float(win_tr.get("speaking_activity", 0.5))
            if win_i < tr_obj.num_chunks:
                try:
                    win_speaking = policy.speaking_score(
                        tr_obj.chunk(win_i),
                        policy.align_audio_chunk(
                            audio_np_full, v_start, total_v_frames,
                            chunk_a_size=self.model_config.audio_frames,
                        chunk_v_size=cfg.chunk_size,
                        ),
                        cfg.speaking_score_mode,
                    )
                except Exception:
                    pass
            time_start = float(v_start / max(1.0, fps))
            time_end = float(v_end / max(1.0, fps))
            vad_cov = policy.window_vad_coverage(vad_mask, time_start, time_end)
            chunk_window_results.append({
                "window_index": len(chunk_window_results),
                "frame_start": v_start,
                "frame_end": v_end,
                "time_start_sec": round(time_start, 3),
                "time_end_sec": round(time_end, 3),
                "selected_track_id": int(win_tr["track_id"]),
                "confidence": win_conf,
                "speaking_activity": float(win_speaking),
                "vad_coverage": round(vad_cov, 3),
                "is_real": bool(win_conf >= cfg.confidence_threshold),
                "is_fake": bool(win_conf < cfg.confidence_threshold),
            })

        speaker_timeline = policy.compress_speaker_timeline(
            chunk_window_results, with_time=True
        )
        unique_speakers = len(
            {w["selected_track_id"] for w in chunk_window_results}
        )
        turn_taking_detected = unique_speakers > 1

        # ── Guard cascade ────────────────────────────────────────────────
        turn_aware = (
            cfg.speaking_score_mode == "articulation"
            if cfg.turn_aware_aggregation == "auto"
            else cfg.turn_aware_aggregation == "on"
        )
        all_chunk_confs = [float(c) for c in best_result["window_confidences"]]
        if chunk_window_results:
            window_confs = [float(w["confidence"]) for w in chunk_window_results]
            window_speaking = [
                float(w.get("speaking_activity", 0.5))
                for w in chunk_window_results
            ]
            window_vad = [
                float(w.get("vad_coverage", 0.5)) for w in chunk_window_results
            ]
            window_track_ids = [
                int(w["selected_track_id"]) for w in chunk_window_results
            ]
        else:
            window_confs = all_chunk_confs
            window_speaking = [
                float(best_result.get("speaking_activity", 0.5))
            ] * len(window_confs)
            window_vad = None
            window_track_ids = None

        guards = policy.run_guard_cascade(
            policy.GuardInputs(
                window_confs=np.asarray(window_confs, np.float32),
                window_speaking=np.asarray(window_speaking, np.float32),
                window_vad=(
                    None if window_vad is None
                    else np.asarray(window_vad, np.float32)
                ),
                window_track_ids=(
                    np.asarray(window_track_ids, np.int64)
                    if turn_aware and window_track_ids is not None
                    else None
                ),
                confidence_threshold=cfg.confidence_threshold,
                smoothing=cfg.confidence_smoothing,
                trim_ratio=cfg.trim_ratio,
                fake_vote_gate=cfg.fake_vote_gate,
                fake_vote_min_windows=cfg.fake_vote_min_windows,
                weak_real_gate=cfg.weak_real_gate,
                weak_real_window_threshold=cfg.weak_real_window_threshold,
            )
        )
        final_confidence = guards.final_confidence
        final_is_real = guards.final_is_real
        override_reason = guards.override_reason
        if guards.window_consensus_uncertain or guards.sparse_real_guard_applied:
            selection_uncertain = True

        # ── Speaker policies ─────────────────────────────────────────────
        case, s_count, s_real, s_fake, track_policy_verdicts = (
            policy.speaker_policies(
                sorted_tracks, bool(best_result["is_fake"]),
                speaking_activity_min=0.50,
            )
        )
        track_policy_case = case
        conservative_override = bool(
            guards.window_consensus_uncertain and final_is_real
        )
        if conservative_override:
            verdicts = {k: False for k in track_policy_verdicts}
            case = "mixed_window_consensus_uncertain"
        else:
            verdicts = track_policy_verdicts
        if guards.sparse_real_guard_applied:
            case = "uncertain_override_sparse_real"
            verdicts = {k: False for k in verdicts}

        # ── Turn-aware per-segment decision (multi-speaker scenes) ───────
        # Each speaker turn is verdicted from its own windows; any fake
        # speaking turn makes the clip fake (policy module docstring). The
        # sparse-real and mouth-motion guards below encode SINGLE-subject
        # semantics (a silent span on the one subject is suspicious); in a
        # multi-speaker timeline silent spans on a track are EXPECTED
        # (someone else is talking), so a segment decision supersedes them.
        segment_verdicts: Optional[List[Dict[str, Any]]] = None
        turn_aware_decided = False
        if turn_aware and chunk_window_results:
            segment_verdicts = policy.turn_aware_segment_verdicts(
                chunk_window_results,
                confidence_threshold=cfg.confidence_threshold,
                smoothing=cfg.confidence_smoothing,
                trim_ratio=cfg.trim_ratio,
            )
            if unique_speakers > 1:
                seg_agg = policy.aggregate_segment_verdicts(
                    segment_verdicts, cfg.confidence_threshold
                )
                if seg_agg is not None:
                    final_confidence, final_is_real = seg_agg
                    turn_aware_decided = True
                    if guards.sparse_real_guard_applied or conservative_override:
                        # Revert the single-subject overrides' side effects
                        # (case/verdicts were blanked above).
                        case = track_policy_case
                        verdicts = dict(track_policy_verdicts)
                        conservative_override = False
                    override_reason = None
                    selection_uncertain = False

        # ── Multi-window mouth motion check on best track ────────────────
        mouth_check: Dict[str, Any] = {"check_result": "no_data"}
        mouth_motion_override = False
        conf_before_mm = final_confidence
        best_tr_obj = chunked_tracks[best_result["_track_idx"]]
        if best_tr_obj.num_chunks > 0:
            indices = policy.sample_check_indices(best_tr_obj.num_chunks)
            checks = []
            for idx in indices:
                checks.append(
                    policy.mouth_motion_energy_check(
                        best_tr_obj.chunk(idx),
                        policy.align_audio_chunk(
                            audio_np_full, best_tr_obj.abs_chunk_starts[idx],
                            total_v_frames,
                            chunk_a_size=self.model_config.audio_frames,
                        chunk_v_size=cfg.chunk_size,
                        ),
                        motion_low_threshold=cfg.mouth_motion_low_threshold,
                        audio_high_threshold=cfg.audio_energy_high_threshold,
                        audio_low_threshold=cfg.audio_energy_low_threshold,
                    )
                )
            mouth_check = policy.aggregate_mouth_motion_check(checks)
            if (
                mouth_check["check_result"] == "likely_fake"
                and cfg.mouth_motion_check
                and not turn_aware_decided
            ):
                final_confidence = float(
                    max(0.0, final_confidence - cfg.mouth_motion_fake_penalty)
                )
            elif (
                mouth_check["check_result"] == "uncertain"
                and cfg.mouth_motion_check
                and not turn_aware_decided
            ):
                if final_confidence < cfg.confidence_threshold:
                    conf_before_mm = final_confidence
                    mouth_motion_override = True
                    selection_uncertain = True
                    override_reason = override_reason or "mouth_motion_uncertain"
                    final_confidence = float(cfg.confidence_threshold)
                    case = "uncertain_override_mouth_motion"
                    verdicts = {k: False for k in verdicts}
            final_is_real = final_confidence >= cfg.confidence_threshold

        t_end = perf_counter()
        logger.info(
            "Long-video inference done: tracks=%d, chunks=%d, "
            "final_conf=%.4f, fake_vote_ratio=%.2f, total_ms=%.1f "
            "preproc_ms=%.1f infer_ms=%.1f",
            len(track_results), total_chunks, final_confidence,
            guards.fake_vote_ratio, (t_end - t_start) * 1e3,
            (t_pre_end - t_pre_start) * 1e3, (t_inf_end - t_inf_start) * 1e3,
        )

        # ── Detail message (predictor.py:1177-1233) ──────────────────────
        dur_str = f"{total_v_frames / max(1.0, fps):.1f}s"
        if turn_taking_detected:
            spans_str = " → ".join(
                f"track_{seg['selected_track_id']} "
                f"({seg.get('time_start_sec', 0):.1f}s–"
                f"{seg.get('time_end_sec', 0):.1f}s)"
                for seg in speaker_timeline
            )
            if turn_aware_decided:
                seg_str = ", ".join(
                    f"track_{s['track_id']}="
                    + ("fake" if s["is_fake"] else "real")
                    + ("" if s["decided"] else "?")
                    for s in (segment_verdicts or [])
                )
                detail = (
                    f"Long video ({dur_str}, {total_chunks} chunks analyzed). "
                    f"Speaker turn-taking detected: {spans_str}. Per-turn "
                    f"verdicts [{seg_str}]; clip verdict is fake iff any "
                    f"speaking turn is fake "
                    f"(confidence={final_confidence:.4f})."
                )
            else:
                detail = (
                    f"Long video ({dur_str}, {total_chunks} chunks analyzed). "
                    f"Speaker turn-taking detected: {spans_str}. Final verdict "
                    f"window-aggregated (confidence={final_confidence:.4f})."
                )
            selection_uncertain = False
        elif mouth_motion_override:
            detail = (
                f"Long video ({dur_str}, {total_chunks} chunks). Mouth motion "
                f"check → uncertain (audio={mouth_check['audio_energy']:.1f} dB, "
                f"motion={mouth_check['mouth_motion_energy']:.5f}): quiet audio "
                f"+ near-zero mouth motion — cannot distinguish fake from "
                f"natural still speech. Conservative REAL verdict returned "
                f"(raw model conf={conf_before_mm:.4f}, lifted to "
                f"threshold={final_confidence:.4f})."
            )
        elif guards.sparse_real_guard_applied:
            detail = (
                f"Long video ({dur_str}, {total_chunks} chunks). "
                f"Sparse-real-signal guard: model confidence very low "
                f"({guards.conf_before_sparse:.4f}) but window "
                f"{int(np.argmax(window_confs))} showed real-like signal "
                f"(conf={max(window_confs):.3f}). Conservative REAL verdict "
                f"(lifted to threshold={final_confidence:.4f})."
            )
        elif guards.window_consensus_uncertain:
            detail = (
                f"Long video ({dur_str}, {total_chunks} chunks). Window "
                f"consensus is mixed (strong_real={guards.strong_real}, "
                f"strong_fake={guards.strong_fake}, "
                f"fake_vote_ratio={guards.fake_vote_ratio:.2f}). Returning "
                f"conservative REAL verdict "
                f"(confidence={final_confidence:.4f})."
            )
        elif selection_uncertain:
            detail = (
                f"Long video ({dur_str}, {total_chunks} chunks). Track "
                f"selection uncertain (margin={selection_margin:.4f})."
            )
        else:
            drift_note = (
                f" ⚠ Temporal drift detected: first-half "
                f"avg={guards.first_half_avg:.3f}, second-half "
                f"avg={guards.second_half_avg:.3f} "
                f"(drop={guards.temporal_drift:.3f})."
                if guards.temporal_confidence_drop else ""
            )
            detail = (
                f"Long video ({dur_str}). Analyzed {total_chunks} chunk(s) "
                f"across full clip. Dominant speaker: track {best_track_id} "
                f"(confidence={final_confidence:.4f}).{drift_note}"
            )

        for t in sorted_tracks:
            t.pop("_track_idx", None)
        verdict = (
            "uncertain" if override_reason
            else ("real" if final_is_real else "fake")
        )
        return {
            "verdict": verdict,
            "is_real": final_is_real,
            "is_fake": not final_is_real,
            "confidence": float(final_confidence),
            "manipulation_probability": float(1.0 - final_confidence),
            "tracks": sorted_tracks,
            "selected_track_id": best_track_id,
            "selection_uncertain": selection_uncertain,
            "selection_margin": float(selection_margin),
            "turn_taking_detected": turn_taking_detected,
            "speaker_case": case,
            "speaking_tracks_count": s_count,
            "speaking_real_count": s_real,
            "speaking_fake_count": s_fake,
            "verdicts": verdicts,
            "track_policy_verdicts": track_policy_verdicts,
            "conservative_override_applied": conservative_override,
            "window_results": chunk_window_results or None,
            "speaker_timeline": speaker_timeline or None,
            "segment_verdicts": segment_verdicts,
            "turn_aware_decided": bool(turn_aware_decided),
            "video_duration_sec": float(total_v_frames / max(1.0, fps)),
            "total_chunks_analyzed": int(total_chunks),
            "chunks_per_track_max": int(max_chunks),
            "window_weighted_confidence": float(
                guards.weighted_window_confidence
            ),
            "window_fake_vote_ratio": float(guards.fake_vote_ratio),
            "window_consensus_uncertain": bool(
                guards.window_consensus_uncertain
            ),
            "strict_fake_evidence": bool(guards.strict_fake_evidence),
            "confidence_margin_uncertain": bool(confidence_margin_uncertain),
            "confidence_gap": float(conf_gap),
            "mouth_motion_check": mouth_check,
            "sparse_real_guard_applied": bool(
                guards.sparse_real_guard_applied
            ),
            "mouth_motion_override_applied": bool(mouth_motion_override),
            "override_reason": override_reason,
            "temporal_confidence_drop": bool(guards.temporal_confidence_drop),
            "temporal_drift": round(guards.temporal_drift, 4),
            "first_half_avg_confidence": round(guards.first_half_avg, 4),
            "second_half_avg_confidence": round(guards.second_half_avg, 4),
            "detail": detail,
        }

    @staticmethod
    def _no_tracks_result(total_v_frames: int, fps: float) -> Dict[str, Any]:
        """Zero-track long-video result (predictor.py:635-660)."""
        return {
            "verdict": "uncertain",
            "is_real": False,
            "is_fake": False,
            "confidence": 0.5,
            "manipulation_probability": 0.5,
            "tracks": None,
            "selected_track_id": None,
            "turn_taking_detected": False,
            "speaker_case": "no_face_detected",
            "speaking_tracks_count": 0,
            "speaking_real_count": 0,
            "speaking_fake_count": 0,
            "verdicts": {
                "active_speaker_policy_is_fake": False,
                "any_speaking_fake_policy_is_fake": False,
                "all_speaking_fake_policy_is_fake": False,
                "majority_speaking_fake_policy_is_fake": False,
            },
            "window_results": None,
            "speaker_timeline": None,
            "detail": "No face tracks detected in video.",
            "video_duration_sec": float(total_v_frames / max(1.0, fps)),
            "total_chunks_analyzed": 0,
        }
