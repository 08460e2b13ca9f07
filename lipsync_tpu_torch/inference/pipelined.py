"""Pipelined long-video scoring: host detection overlapped with device scoring.

Counterpart of ``inference/pipelined.py`` in the JAX package. The batch
path (``preprocess_video_tracks_chunked``, then one scoring pass) runs host
face detection and device scoring one after the other. Here the reference's
sequential tracker semantics (``preprocessing/tracker.py::StreamingTracker``)
are kept, but every model window goes to the device as soon as its boxes
are immutable (a slot can only be rewritten by lerp backfill within
``max_age`` frames of the tracker head), through the engine's asynchronous
``dispatch_track_logits``: CUDA kernels are queued and the host goes on
detecting. The device logits are read back once, after the last group has
been dispatched.

The output matches the batch path: a list of
:class:`~lipsync_tpu_torch.preprocessing.video.ChunkedTrack` (crop buffers
kept uint8; ``chunk()`` normalizes on access) in viable-stability order,
plus per-track window probabilities.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from lipsync_tpu_torch.inference import policy
from lipsync_tpu_torch.preprocessing.face_detection import (
    FaceDetectorBackend,
    get_default_backend,
)
from lipsync_tpu_torch.preprocessing.tracker import StreamingTracker, TrackState
from lipsync_tpu_torch.preprocessing.video import (
    ChunkedTrack,
    crop_mouth_uint8,
    mean_box,
)
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class _TrackBook:
    """Per-track scoring bookkeeping keyed by track_id."""

    state: TrackState
    crops: List[np.ndarray] = dataclasses.field(default_factory=list)
    next_window_start: int = 0  # next local window start to dispatch
    dispatched: List[Tuple[List[int], object]] = dataclasses.field(
        default_factory=list
    )  # (local starts, device logits future)


def score_long_video_pipelined(
    frames: np.ndarray,
    audio_full: np.ndarray,
    engine,
    *,
    backend: Optional[FaceDetectorBackend] = None,
    chunk_size: int = 32,
    stride: int = 8,
    max_tracks: int = 6,
    crop_size: int = 96,
    audio_frames: int = 128,
    iou_threshold: float = 0.25,
    iou_threshold_relaxed: float = 0.12,
    max_age: int = 15,
    min_stability: float = 0.35,
    dispatch_batch: int = 16,
    detection_stride: int = 1,
) -> Tuple[List[ChunkedTrack], Dict[int, List[float]]]:
    """Detect, track and score ``frames`` with detection and scoring
    overlapped.

    Returns ``(chunked_tracks, probs_by_index)`` where ``probs_by_index[i]``
    are the calibrated window probabilities of ``chunked_tracks[i]``, in
    window-start order: the inputs ``Predictor._predict_long_video``
    aggregates.

    ``detection_stride`` > 1 runs the host detector only on every N-th
    frame; the tracker coasts (velocity extrapolation, lerp backfill on
    re-acquisition) through the frames in between. Stride 1 is the
    reference's per-frame tracking.
    """
    if backend is None:
        backend = get_default_backend()
    if hasattr(backend, "reset"):
        backend.reset()

    total_frames = len(frames)
    if total_frames == 0:
        return [], {}
    h, w = frames.shape[1:3]

    def run_stream():
        tracker = StreamingTracker(
            h, w,
            max_tracks=max_tracks,
            iou_threshold=iou_threshold,
            iou_threshold_relaxed=iou_threshold_relaxed,
            max_age=max_age,
            min_stability=min_stability,
            crop_size=crop_size,
            detection_stride=detection_stride,
        )
        books: Dict[int, _TrackBook] = {}
        any_detection = False
        for idx, frame in enumerate(frames):
            if idx % detection_stride == 0:
                dets = backend.detect(frame)
                any_detection = any_detection or bool(dets)
                tracker.update(dets)
            else:
                tracker.coast()
            _advance(tracker, books, frames, done=False,
                     chunk_size=chunk_size, stride=stride,
                     crop_size=crop_size, audio_full=audio_full,
                     total_frames=total_frames, audio_frames=audio_frames,
                     engine=engine, dispatch_batch=dispatch_batch)
        # Final flush scores only the tracks finalize() keeps — the batch
        # path never scores retired transient tracks either, and a jittery
        # clip can create dozens of short-lived ones.
        results = tracker.finalize()
        _advance(tracker, books, frames, done=True,
                 chunk_size=chunk_size, stride=stride, crop_size=crop_size,
                 audio_full=audio_full, total_frames=total_frames,
                 audio_frames=audio_frames, engine=engine,
                 dispatch_batch=dispatch_batch,
                 viable_ids={tr.track_id for tr in results})
        return tracker, books, results, any_detection

    tracker, books, results, any_detection = run_stream()

    # Zero-detection relaxed retry (reference face_detection.py:1057-1082;
    # cascade analog min_neighbors=1 — mirrors detect_and_crop_tracks).
    if not any_detection and hasattr(backend, "min_neighbors") and (
        backend.min_neighbors > 1
    ):
        logger.warning(
            "Zero detections at min_neighbors=%d; retrying relaxed (pipelined)",
            backend.min_neighbors,
        )
        original = backend.min_neighbors
        try:
            backend.min_neighbors = 1
            if hasattr(backend, "reset"):
                backend.reset()
            tracker, books, results, _ = run_stream()
        finally:
            backend.min_neighbors = original

    # ── Assemble viable tracks + pull device results ─────────────────────
    chunked: List[ChunkedTrack] = []
    probs_by_index: Dict[int, List[float]] = {}
    for tr in results:
        book = books.get(tr.track_id)
        if book is None:  # defensive: every finalized track has a book
            continue
        crops = (
            np.stack(book.crops)
            if book.crops
            else np.zeros((0, crop_size, crop_size, 3), np.uint8)
        )
        starts: List[int] = []
        logits: List[float] = []
        for batch_starts, future in book.dispatched:
            # Read back only now, after every group has been dispatched, so
            # that host detection and device scoring overlapped.
            vals = future[: len(batch_starts)].float().cpu().numpy()
            starts.extend(batch_starts)
            logits.extend(float(v) for v in vals)
        probs = [float(p) for p in engine.calibrator(np.asarray(logits))]
        chunked.append(
            ChunkedTrack(
                track_id=tr.track_id,
                crops=crops,
                chunk_starts=starts,
                abs_chunk_starts=[tr.track_start_frame + s for s in starts],
                chunk_size=chunk_size,
                hits=tr.hits,
                total_frames=total_frames,
                stability=tr.stability,
                consecutive_miss_max=tr.consecutive_miss_max,
                track_start_frame=tr.track_start_frame,
                track_end_frame=tr.track_end_frame,
                mean_bbox=mean_box(tr.boxes),
            )
        )
        # Keyed by position in `chunked`, which can diverge from the
        # finalize() index if the defensive skip above ever fires.
        probs_by_index[len(chunked) - 1] = probs
    return chunked, probs_by_index


def _advance(
    tracker: StreamingTracker,
    books: Dict[int, "_TrackBook"],
    frames: np.ndarray,
    done: bool,
    *,
    chunk_size: int,
    stride: int,
    crop_size: int,
    audio_full: np.ndarray,
    total_frames: int,
    audio_frames: int,
    engine,
    dispatch_batch: int,
    viable_ids: Optional[set] = None,
) -> None:
    """Crop newly-finalized slots and dispatch completed windows.

    ``viable_ids`` (the end-of-stream flush) restricts work to the tracks
    finalize() keeps, so transient false-positive tracks don't cost crops
    or device dispatches.
    """
    for state in tracker.all_states():
        if viable_ids is not None and state.track_id not in viable_ids:
            continue
        book = books.setdefault(state.track_id, _TrackBook(state=state))
        final_n = tracker.finalized_length(state, done=done)

        # Host-crop slots that just became immutable.
        while len(book.crops) < final_n:
            local = len(book.crops)
            abs_idx = min(state.start_frame_idx + local, total_frames - 1)
            book.crops.append(
                crop_mouth_uint8(frames[abs_idx], state.boxes[local],
                                 crop_size)
            )

        # Collect window starts whose frames are fully finalized.
        pending: List[int] = []
        s = book.next_window_start
        while s + chunk_size <= final_n:
            pending.append(s)
            s += stride
        # End of stream: short tracks still get their single padded window
        # (batch-path semantics: starts=[0] when n < chunk_size).
        if done and not pending and book.next_window_start == 0 and final_n:
            pending = [0]
            s = stride  # consumed
        if not pending:
            continue
        if not done and len(pending) < dispatch_batch:
            continue  # accumulate a worthwhile device batch

        book.next_window_start = s
        _dispatch(book, pending, chunk_size=chunk_size, stride=stride,
                  crop_size=crop_size, audio_full=audio_full,
                  total_frames=total_frames, audio_frames=audio_frames,
                  engine=engine, max_batch=getattr(engine, "max_batch", 256))


def _dispatch(
    book: "_TrackBook",
    pending: List[int],
    *,
    chunk_size: int,
    stride: int,
    crop_size: int,
    audio_full: np.ndarray,
    total_frames: int,
    audio_frames: int,
    engine,
    max_batch: int,
) -> None:
    """Upload the window span once (uint8) and enqueue the batched forward."""
    for i in range(0, len(pending), max_batch):
        batch = pending[i : i + max_batch]
        span_start = batch[0]
        span_end = max(batch) + chunk_size
        span = np.stack(book.crops[span_start:span_end]) if (
            span_end - span_start
        ) else np.zeros((0, crop_size, crop_size, 3), np.uint8)
        if span.shape[0] < chunk_size:  # short-track single padded window
            pad = np.repeat(
                span[-1:] if span.shape[0] else np.zeros(
                    (1, crop_size, crop_size, 3), np.uint8
                ),
                chunk_size - span.shape[0], axis=0,
            )
            span = np.concatenate([span, pad], axis=0) if span.shape[0] else pad
        rel_starts = [s - span_start for s in batch]
        audio_windows = np.stack([
            policy.align_audio_chunk(
                audio_full,
                book.state.start_frame_idx + s,
                total_frames,
                chunk_a_size=audio_frames,
                chunk_v_size=chunk_size,
            )
            for s in batch
        ])[..., None]
        future = engine.dispatch_track_logits(span, rel_starts, audio_windows)
        book.dispatched.append((batch, future))
