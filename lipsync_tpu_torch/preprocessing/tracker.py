"""Multi-face IoU/velocity tracker: a pure host state machine over boxes.

Counterpart of ``preprocessing/tracker.py`` in the JAX package (the
reference's production tracker, ``face_detection.py:668-1101``): it consumes
per-frame detections and emits per-track boxes per frame slot; pixel
cropping happens afterwards in one batched device call.

Behaviour kept from the reference:
- IoU matching against velocity-extrapolated boxes for aged tracks, with a
  relaxed threshold during the grace period;
- exponential velocity smoothing, alpha = 0.4;
- lerp backfill of missed slots once a track re-acquires;
- predicted-box placeholders for missed frames;
- retirement after ``max_age`` misses, retired tracks retained;
- span-relative weighted stability with a consecutive-miss penalty;
- the min-stability filter with keep-best fallback, top ``max_tracks``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from lipsync_tpu_torch.preprocessing.face_detection import (
    Box,
    Detection,
    bbox_iou,
    center_crop_box,
)

@dataclasses.dataclass
class TrackState:
    track_id: int
    start_frame_idx: int
    end_frame_idx: int
    last_bbox: Box
    velocity: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    boxes: List[Box] = dataclasses.field(default_factory=list)
    hits: int = 1
    age: int = 0
    consecutive_miss: int = 0
    max_consecutive_miss: int = 0
    miss_frame_indices: List[int] = dataclasses.field(default_factory=list)
    # Slots appended by coast() (detection deliberately skipped) since the
    # last real observation; lerp-backfilled on the next match like misses,
    # but stats-neutral: no age/stability penalty.
    coast_pending: int = 0


@dataclasses.dataclass
class TrackResult:
    """Finalized track: ``boxes[i]`` belongs to video frame
    ``start_frame + i`` (crop on device afterwards)."""

    track_id: int
    boxes: List[Box]
    hits: int
    total_frames: int
    stability: float
    consecutive_miss_max: int
    track_start_frame: int
    track_end_frame: int


def _predict_bbox(bbox: Box, velocity, steps: int = 1) -> Box:
    x1, y1, x2, y2 = bbox
    vx1, vy1, vx2, vy2 = velocity
    return (
        int(round(x1 + vx1 * steps)),
        int(round(y1 + vy1 * steps)),
        int(round(x2 + vx2 * steps)),
        int(round(y2 + vy2 * steps)),
    )


def _lerp_bbox(b_from: Box, b_to: Box, t: float) -> Box:
    return tuple(
        int(round(b_from[k] + (b_to[k] - b_from[k]) * t)) for k in range(4)
    )  # type: ignore[return-value]


class StreamingTracker:
    """Incremental form of the tracker: feed one frame's detections at a
    time and read back *finalized* (immutable) box prefixes per track.

    This enables the pipelined long-video path: while the host detector
    works on frame t, windows whose boxes can no longer change are already
    scoring on the device. A slot is immutable once the tracker has
    advanced ``max_age + 1`` frames past it — lerp backfill on track
    re-acquisition (:869-884 in the reference) only ever rewrites the last
    ``age <= max_age`` slots — or once its track has retired.
    """

    def __init__(
        self,
        frame_height: int,
        frame_width: int,
        max_tracks: int = 5,
        iou_threshold: float = 0.25,
        iou_threshold_relaxed: float = 0.12,
        max_age: int = 15,
        min_stability: float = 0.35,
        crop_size: int = 96,
        detection_stride: int = 1,
    ):
        self.frame_height = frame_height
        self.frame_width = frame_width
        self.max_tracks = max_tracks
        self.iou_threshold = iou_threshold
        self.iou_threshold_relaxed = iou_threshold_relaxed
        self.max_age = max_age
        self.min_stability = min_stability
        # Declared upper bound on frames between detection attempts; only
        # used to size the immutable-prefix window in finalized_length().
        self.detection_stride = max(1, detection_stride)
        self.center_box = center_crop_box(frame_height, frame_width, crop_size)
        self.tracks: List[TrackState] = []
        self.completed: List[TrackState] = []
        self.next_id = 0
        self.frames_consumed = 0

    def update(self, detections: Sequence[Detection]) -> None:
        """Consume one frame's detections (frame index = frames_consumed)."""
        t_idx = self.frames_consumed
        boxes = [d.bbox for d in detections]
        matched: set = set()

        for tr in self.tracks:
            if tr.age > self.max_age:
                continue
            gap = tr.age + tr.coast_pending  # slots since last observation
            predicted = (
                _predict_bbox(tr.last_bbox, tr.velocity, steps=gap + 1)
                if gap > 0
                else tr.last_bbox
            )
            best_iou, best_idx = 0.0, -1
            for i, box in enumerate(boxes):
                if i in matched:
                    continue
                score = bbox_iou(predicted, box)
                if score > best_iou:
                    best_iou, best_idx = score, i
            threshold = (
                self.iou_threshold_relaxed if tr.age > 0 else self.iou_threshold
            )

            if best_idx >= 0 and best_iou >= threshold:
                matched.add(best_idx)
                new_bbox = boxes[best_idx]

                # Backfill missed/coasted slots with lerped boxes.
                if gap > 0 and tr.boxes:
                    for g in range(gap):
                        fill_idx = len(tr.boxes) - gap + g
                        if 0 <= fill_idx < len(tr.boxes):
                            tr.boxes[fill_idx] = _lerp_bbox(
                                tr.last_bbox, new_bbox, (g + 1) / (gap + 1)
                            )

                alpha = 0.4
                # Per-frame delta. With coasting the last observation is
                # gap+1 slots back, so the raw delta is normalized; the
                # stride=1 path (coast_pending always 0) is unchanged
                # (reference face_detection.py:886-899 smooths raw deltas
                # between consecutive detection frames).
                denom = float(gap + 1) if tr.coast_pending > 0 else 1.0
                raw_v = tuple(
                    float(new_bbox[k] - tr.last_bbox[k]) / denom
                    for k in range(4)
                )
                tr.velocity = tuple(
                    alpha * raw_v[k] + (1 - alpha) * tr.velocity[k]
                    for k in range(4)
                )  # type: ignore[assignment]
                tr.last_bbox = new_bbox
                tr.end_frame_idx = t_idx
                tr.boxes.append(new_bbox)
                tr.hits += 1
                tr.age = 0
                tr.consecutive_miss = 0
                tr.coast_pending = 0
            else:
                steps = gap + 1 if tr.coast_pending > 0 else 1
                placeholder = (
                    _predict_bbox(tr.last_bbox, tr.velocity, steps=steps)
                    if tr.boxes
                    else self.center_box
                )
                tr.boxes.append(_clamp_box(placeholder, self.frame_height,
                                           self.frame_width, self.center_box))
                tr.age += 1
                tr.consecutive_miss += 1
                tr.max_consecutive_miss = max(
                    tr.max_consecutive_miss, tr.consecutive_miss
                )
                tr.miss_frame_indices.append(t_idx)

        # Retire expired tracks (retained, not deleted).
        self.completed.extend(
            tr for tr in self.tracks if tr.age > self.max_age
        )
        self.tracks = [tr for tr in self.tracks if tr.age <= self.max_age]

        # New tracks for unmatched detections, capped at max_tracks.
        for i, box in enumerate(boxes):
            if i in matched or len(self.tracks) >= self.max_tracks:
                continue
            self.tracks.append(
                TrackState(
                    track_id=self.next_id,
                    start_frame_idx=t_idx,
                    end_frame_idx=t_idx,
                    last_bbox=box,
                    boxes=[box],
                )
            )
            self.next_id += 1
        self.frames_consumed = t_idx + 1

    def coast(self) -> None:
        """Consume one frame WITHOUT running detection (detection-stride
        mode): every live track gets a velocity-extrapolated box for this
        slot, lerp-backfilled on the next real match exactly like a missed
        slot.

        Stability bookkeeping follows the track's CURRENT detection state so
        span-relative semantics (reference face_detection.py:1000-1020) are
        preserved across strides: while matched (``age == 0``) the coasted
        slot counts as a hit — skipping detection was the caller's choice,
        not evidence the face vanished; mid-miss-streak (``age > 0``) it is
        placeholder-only and counts against stability exactly like the
        intervening frames of a stride-1 miss streak would.
        """
        t_idx = self.frames_consumed
        for tr in self.tracks:
            # Invariant: update() retires tracks past max_age before
            # returning and coast() never increments age, so every live
            # track here is within its grace period.
            assert tr.age <= self.max_age, "retired track left in self.tracks"
            gap = tr.age + tr.coast_pending
            predicted = _predict_bbox(tr.last_bbox, tr.velocity,
                                      steps=gap + 1)
            tr.boxes.append(_clamp_box(predicted, self.frame_height,
                                       self.frame_width, self.center_box))
            if tr.age == 0:
                tr.end_frame_idx = t_idx
                tr.hits += 1
            tr.coast_pending += 1
        self.frames_consumed = t_idx + 1

    # -- incremental readback ------------------------------------------------
    def all_states(self) -> List[TrackState]:
        return self.completed + self.tracks

    def finalized_length(self, tr: TrackState, done: bool = False) -> int:
        """Immutable prefix length of ``tr.boxes`` given frames consumed.

        ``done=True`` (end of stream) or retirement finalizes everything.
        """
        if done or any(tr is c for c in self.completed):  # retired = frozen
            return len(tr.boxes)
        # Lerp backfill can rewrite every slot since the last observation.
        # Worst case before retirement: max_age real misses (one per
        # detection attempt) plus (stride-1) coasted slots around each ->
        # (max_age + 1) * stride - 1 rewritable slots behind the head.
        window = (self.max_age + 1) * self.detection_stride - 1
        safe = self.frames_consumed - window - tr.start_frame_idx
        return max(0, min(len(tr.boxes), safe))

    def stability(self, tr: TrackState) -> float:
        """Span-relative weighted stability with consecutive-miss penalty
        (reference face_detection.py:1000-1020)."""
        span = max(1, tr.end_frame_idx - tr.start_frame_idx + 1)
        base = float(tr.hits) / span
        if tr.max_consecutive_miss <= 1:
            return base
        penalty = min(0.5, (tr.max_consecutive_miss - 1) * 0.15)
        return base * (1.0 - penalty)

    def finalize(self) -> List[TrackResult]:
        """Min-stability filter with keep-best fallback, top-``max_tracks``
        (reference face_detection.py:1047-1056)."""
        total_frames = max(1, self.frames_consumed)
        scored = [(self.stability(tr), tr) for tr in self.all_states()]
        viable = [
            (s, tr) for s, tr in scored if s >= self.min_stability
        ] or scored
        viable.sort(key=lambda st: st[0], reverse=True)

        results = []
        for stability, tr in viable[: self.max_tracks]:
            results.append(
                TrackResult(
                    track_id=tr.track_id,
                    boxes=list(tr.boxes),
                    hits=tr.hits,
                    total_frames=total_frames,
                    stability=float(stability),
                    consecutive_miss_max=tr.max_consecutive_miss,
                    track_start_frame=tr.start_frame_idx,
                    track_end_frame=tr.end_frame_idx,
                )
            )
        return results


def track_faces(
    detections_per_frame: Sequence[Sequence[Detection]],
    frame_height: int,
    frame_width: int,
    max_tracks: int = 5,
    iou_threshold: float = 0.25,
    iou_threshold_relaxed: float = 0.12,
    max_age: int = 15,
    min_stability: float = 0.35,
    crop_size: int = 96,
) -> List[TrackResult]:
    """Run the tracker over pre-computed detections (batch form)."""
    st = StreamingTracker(
        frame_height, frame_width,
        max_tracks=max_tracks,
        iou_threshold=iou_threshold,
        iou_threshold_relaxed=iou_threshold_relaxed,
        max_age=max_age,
        min_stability=min_stability,
        crop_size=crop_size,
    )
    for detections in detections_per_frame:
        st.update(detections)
    return st.finalize()


def _clamp_box(box: Box, h: int, w: int, fallback: Box) -> Box:
    """Clamp a (possibly extrapolated) box into the frame; degenerate boxes
    collapse to the fallback (the reference's _bbox_crop clamping,
    face_detection.py:718-730)."""
    x1 = int(max(0, min(box[0], w - 1)))
    y1 = int(max(0, min(box[1], h - 1)))
    x2 = int(max(x1 + 1, min(box[2], w)))
    y2 = int(max(y1 + 1, min(box[3], h)))
    if x2 - x1 < 2 and y2 - y1 < 2:
        return fallback
    return (x1, y1, x2, y2)
