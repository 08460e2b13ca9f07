"""Host-side face detection backends behind a common interface.

Counterpart of ``preprocessing/face_detection.py`` in the JAX package. The
reference's ladder is MediaPipe FaceMesh, MediaPipe FaceDetection, the
OpenCV Haar cascades, then a centre crop. The two MediaPipe tiers run
where the ``mediapipe`` wheel imports and raise ``ImportError`` otherwise,
as the JAX package's do; without the wheel the cascade tier (native
evaluator, ``preprocessing/haar.py``), lip-refined, is the default host
detector. A scripted backend lets tests and measurements run without any
detector.

Backends return MOUTH bounding boxes only: cropping and resizing happen
afterwards in one batched call on the device (``ops/image.py``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

Box = Tuple[int, int, int, int]  # x1, y1, x2, y2 (x2/y2 exclusive)


@dataclasses.dataclass
class Detection:
    """One detected mouth region."""

    bbox: Box
    detector: str = "unknown"
    score: float = 1.0


class FaceDetectorBackend(Protocol):
    name: str

    def detect(self, frame: np.ndarray) -> List[Detection]:
        """RGB (H, W, 3) uint8 -> mouth-region detections."""
        ...


def face_bbox_to_mouth_bbox(
    fx1: int, fy1: int, fw: int, fh: int, width: int, height: int
) -> Box:
    """Face box -> approximate mouth box (face_detection.py:220-234:
    x in [0.18, 0.82]w, y in [0.52, 0.96]h, clamped)."""
    x_min = fx1 + int(0.18 * fw)
    x_max = fx1 + int(0.82 * fw)
    y_min = fy1 + int(0.52 * fh)
    y_max = fy1 + int(0.96 * fh)
    x_min = max(0, min(x_min, width - 1))
    y_min = max(0, min(y_min, height - 1))
    x_max = max(x_min + 1, min(x_max, width))
    y_max = max(y_min + 1, min(y_max, height))
    return x_min, y_min, x_max, y_max


def bbox_iou(b1: Sequence[float], b2: Sequence[float]) -> float:
    """IoU on (x1, y1, x2, y2) boxes (face_detection.py:731-745)."""
    inter_x1 = max(b1[0], b2[0])
    inter_y1 = max(b1[1], b2[1])
    inter_x2 = min(b1[2], b2[2])
    inter_y2 = min(b1[3], b2[3])
    if inter_x2 <= inter_x1 or inter_y2 <= inter_y1:
        return 0.0
    inter = (inter_x2 - inter_x1) * (inter_y2 - inter_y1)
    a1 = max(1, (b1[2] - b1[0]) * (b1[3] - b1[1]))
    a2 = max(1, (b2[2] - b2[0]) * (b2[3] - b2[1]))
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0


class CascadeDetector:
    """Haar cascade detector (frontal + profile) on the NATIVE evaluator.

    Reproduces the reference's cascade tier (face_detection.py:236-328):
    scaleFactor 1.08, minNeighbors 3, minSize 4% of the short side, NMS at
    IoU 0.5 keeping the larger box, then the face->mouth heuristic. OpenCV 5
    removed ``CascadeClassifier``, so evaluation runs in ``native/haar.cc``
    via :mod:`lipsync_tpu_torch.preprocessing.haar` using the distro's cascade
    data files.

    One detector serves concurrent requests (the service's handler threads
    and its job worker share the predictor's backend), so its per-video
    state is per thread: the ROI state that :meth:`reset` clears, and a
    ``min_neighbors`` set after construction (the relaxed retry's), which
    holds for the calling thread only. Each clip is detected on one thread.
    """

    name = "cascade"

    def __init__(
        self,
        max_num_faces: int = 5,
        min_neighbors: int = 3,
        track_rois: bool = True,
        refresh_every: int = 10,
    ):
        from lipsync_tpu_torch.preprocessing.haar import (
            HaarCascade,
            find_cascade_file,
        )

        self.max_num_faces = max_num_faces
        self._local = threading.local()
        self._min_neighbors = min_neighbors
        # ROI-guided video mode: after the first hit, scan only expanded
        # regions around the previous frame's faces; do a full-frame sweep
        # every ``refresh_every`` frames to catch entering faces. The host
        # detector is the serial bottleneck of the pipeline (SURVEY.md §7
        # host/device split), and faces move little at 15 fps.
        self.track_rois = track_rois
        self.refresh_every = max(1, refresh_every)
        frontal = find_cascade_file("haarcascade_frontalface_default.xml")
        if frontal is None:
            raise RuntimeError("No frontal face cascade file found")
        self._frontal = HaarCascade(frontal)
        profile = find_cascade_file("haarcascade_profileface.xml")
        self._profile = HaarCascade(profile) if profile else None

    @property
    def min_neighbors(self) -> int:
        return getattr(self._local, "min_neighbors", self._min_neighbors)

    @min_neighbors.setter
    def min_neighbors(self, value: int) -> None:
        self._local.min_neighbors = value

    @property
    def _last_faces(self) -> List[Tuple[int, int, int, int]]:
        return getattr(self._local, "last_faces", [])

    @_last_faces.setter
    def _last_faces(self, faces) -> None:
        self._local.last_faces = faces

    @property
    def _since_full(self) -> int:
        return getattr(self._local, "since_full", 0)

    @_since_full.setter
    def _since_full(self, n: int) -> None:
        self._local.since_full = n

    def reset(self) -> None:
        """Clear the calling thread's per-video ROI state (called at the
        start of each clip)."""
        self._last_faces = []
        self._since_full = 0

    def _scan(self, gray: np.ndarray, min_side: int,
              offset=(0, 0),
              skip_profile_if_frontal: bool = False,
              ) -> List[Tuple[int, int, int, int]]:
        """Frontal + profile sweep (reference face_detection.py:247-275 runs
        both and NMS-merges). ``skip_profile_if_frontal`` is the ROI-mode
        fast path: a tracked face that the frontal cascade still fires on
        doesn't need the profile sweep of the same ROI — halves the per-
        frame cost in the common case; full-frame sweeps keep both so
        entering profiled faces are still found."""
        rects: List[Tuple[int, int, int, int]] = []
        for cascade in (self._frontal, self._profile):
            if cascade is None:
                continue
            if cascade is self._profile and skip_profile_if_frontal and rects:
                break
            found = cascade.detect(
                gray, scale_factor=1.08, min_neighbors=self.min_neighbors,
                min_size=min_side,
            )
            if len(found) > 0:
                ox, oy = offset
                rects.extend((r[0] + ox, r[1] + oy, r[2], r[3]) for r in found)
        return rects

    def detect(self, frame: np.ndarray) -> List[Detection]:
        h, w = frame.shape[:2]
        gray = (
            0.299 * frame[:, :, 0]
            + 0.587 * frame[:, :, 1]
            + 0.114 * frame[:, :, 2]
        ).astype(np.uint8)
        min_side = max(20, int(min(h, w) * 0.04))

        rects: List[Tuple[int, int, int, int]] = []
        use_roi = (
            self.track_rois
            and self._last_faces
            and self._since_full < self.refresh_every
        )
        if use_roi:
            for fx, fy, fw, fh in self._last_faces:
                # Expand the previous face box by 50% each side.
                ex = max(0, fx - fw // 2)
                ey = max(0, fy - fh // 2)
                ex2 = min(w, fx + fw + fw // 2)
                ey2 = min(h, fy + fh + fh // 2)
                if ex2 - ex < min_side or ey2 - ey < min_side:
                    continue
                # The face size is known from last frame: skip the small-
                # scale pyramid levels (they dominate the scan cost).
                roi_min = max(min_side, min(fw, fh) // 2)
                roi = np.ascontiguousarray(gray[ey:ey2, ex:ex2])
                rects.extend(self._scan(roi, roi_min, offset=(ex, ey),
                                        skip_profile_if_frontal=True))
            self._since_full += 1
        if not rects:
            rects = self._scan(gray, min_side)
            self._since_full = 0

        # NMS: IoU > 0.5 keeps the larger box (face_detection.py:284-310).
        filtered: List[Tuple[int, int, int, int]] = []
        for rect in rects:
            rb = (rect[0], rect[1], rect[0] + rect[2], rect[1] + rect[3])
            dup = False
            for existing in list(filtered):
                eb = (
                    existing[0], existing[1],
                    existing[0] + existing[2], existing[1] + existing[3],
                )
                if bbox_iou(rb, eb) > 0.5:
                    if rect[2] * rect[3] > existing[2] * existing[3]:
                        filtered.remove(existing)
                        filtered.append(rect)
                    dup = True
                    break
            if not dup:
                filtered.append(rect)

        kept = filtered[: self.max_num_faces]
        self._last_faces = kept
        out: List[Detection] = []
        for x, y, fw, fh in kept:
            mouth = face_bbox_to_mouth_bbox(x, y, fw, fh, w, h)
            if mouth[2] - mouth[0] < 4 or mouth[3] - mouth[1] < 4:
                continue
            out.append(Detection(bbox=mouth, detector=self.name))
        return out


class MediaPipeDetector:
    """MediaPipe FaceMesh tier (face_detection.py:428-449): the extremes of
    22 lip landmarks padded by 20 px each side and clamped to the frame.
    Raises ``ImportError`` when the ``mediapipe`` wheel is absent.

    FaceMesh runs with ``static_image_mode=False`` and so carries tracking
    state from frame to frame: each thread that calls :meth:`detect` gets
    its own FaceMesh, built with the same arguments (the JAX package shares
    one instance)."""

    name = "facemesh"
    # Outer + inner lip landmark indices (face_detection.py:101-124).
    mouth_landmarks = [
        61, 146, 91, 181, 84, 17, 314, 405, 320, 307, 375, 321,
        78, 95, 88, 178, 87, 14, 317, 402, 318, 324,
    ]

    def __init__(
        self,
        max_num_faces: int = 5,
        min_detection_confidence: float = 0.3,
        min_tracking_confidence: float = 0.3,
    ):
        import mediapipe as mp  # optional dependency

        self.max_num_faces = max_num_faces
        self._kwargs = dict(
            static_image_mode=False,
            max_num_faces=max_num_faces,
            refine_landmarks=True,
            min_detection_confidence=min_detection_confidence,
            min_tracking_confidence=min_tracking_confidence,
        )
        self._make = mp.solutions.face_mesh.FaceMesh
        self._local = threading.local()
        self._local.mesh = self._make(**self._kwargs)

    def _mesh(self):
        mesh = getattr(self._local, "mesh", None)
        if mesh is None:
            mesh = self._local.mesh = self._make(**self._kwargs)
        return mesh

    def detect(self, frame: np.ndarray) -> List[Detection]:
        h, w = frame.shape[:2]
        results = self._mesh().process(frame)
        if not results or not results.multi_face_landmarks:
            return []
        out = []
        for face in results.multi_face_landmarks:
            pts = np.array(
                [[lm.x * w, lm.y * h] for lm in face.landmark], np.float32
            )
            mouth = pts[self.mouth_landmarks]
            x_min = max(0, int(mouth[:, 0].min()) - 20)
            x_max = min(w, int(mouth[:, 0].max()) + 20)
            y_min = max(0, int(mouth[:, 1].min()) - 20)
            y_max = min(h, int(mouth[:, 1].max()) + 20)
            out.append(Detection(bbox=(x_min, y_min, x_max, y_max),
                                 detector=self.name))
        return out


class MediaPipeFaceDetectionDetector:
    """MediaPipe FaceDetection tier (face_detection.py:330-385): face boxes
    mapped to mouth boxes with the cascade's heuristic
    (:func:`face_bbox_to_mouth_bbox`). ``model_selection=1`` is the
    full-range model. Raises ``ImportError`` when the ``mediapipe`` wheel
    is absent."""

    name = "facedetection"

    def __init__(
        self,
        max_num_faces: int = 5,
        min_detection_confidence: float = 0.3,
        model_selection: int = 1,
    ):
        import mediapipe as mp  # optional dependency

        self.max_num_faces = max_num_faces
        self._detector = mp.solutions.face_detection.FaceDetection(
            model_selection=model_selection,
            min_detection_confidence=min_detection_confidence,
        )

    def detect(self, frame: np.ndarray) -> List[Detection]:
        h, w = frame.shape[:2]
        results = self._detector.process(frame)
        if not results or not results.detections:
            return []
        out: List[Detection] = []
        for det in results.detections[: self.max_num_faces]:
            rel = det.location_data.relative_bounding_box
            fx, fy = int(rel.xmin * w), int(rel.ymin * h)
            fw, fh = int(rel.width * w), int(rel.height * h)
            if fw < 4 or fh < 4:
                continue
            score = float(det.score[0]) if det.score else 1.0
            mouth = face_bbox_to_mouth_bbox(fx, fy, fw, fh, w, h)
            if mouth[2] - mouth[0] < 4 or mouth[3] - mouth[1] < 4:
                continue
            out.append(Detection(bbox=mouth, detector=self.name, score=score))
        return out


def _normalized(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-6:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def _box1d(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Vectorized k-tap zero-padded box mean along ``axis`` — identical to
    ``np.convolve(row, ones(k)/k, mode="same")`` per lane, without the
    per-lane Python loop of apply_along_axis (the refiner runs per frame on
    the host hot path)."""
    n = x.shape[axis]
    p = (k - 1) // 2
    zero = np.zeros_like(np.take(x, [0], axis=axis))
    cum = np.concatenate([zero, np.cumsum(x, axis=axis)], axis=axis)
    hi = np.clip(np.arange(n) - p + k, 0, n)
    lo = np.clip(np.arange(n) - p, 0, n)
    return (np.take(cum, hi, axis=axis) - np.take(cum, lo, axis=axis)) / k


def _box_smooth(x: np.ndarray, k: int = 3) -> np.ndarray:
    """k-tap box filter along both axes (no scipy dependency)."""
    if k <= 1:
        return x
    return _box1d(_box1d(x, k, 1), k, 0)


def _profile_extent(profile: np.ndarray, rel_threshold: float = 0.45
                    ) -> Tuple[int, int]:
    """Contiguous span around the profile peak, thresholded at
    ``floor + rel * (peak - floor)`` where floor is the profile median —
    normalized-noise profiles have a high flat floor, so a peak-relative
    cut alone would swallow the whole region."""
    peak = int(np.argmax(profile))
    floor = float(np.median(profile))
    cut = floor + (float(profile[peak]) - floor) * rel_threshold
    lo = peak
    while lo > 0 and profile[lo - 1] >= cut:
        lo -= 1
    hi = peak
    while hi < len(profile) - 1 and profile[hi + 1] >= cut:
        hi += 1
    return lo, hi + 1


def refine_mouth_box(frame: np.ndarray, box: Box) -> Box:
    """Image-evidence lip localization inside a heuristic mouth box.

    The reference's top tier derives the mouth box from 21 FaceMesh lip
    landmarks ±20 px (face_detection.py:101-124,428-438); without the
    mediapipe wheel every crop here came from the face-box heuristic
    (:221-234), which over-covers (chin/cheeks) and drifts with cascade
    jitter. This refiner recovers most of the landmark tier's precision
    with no model: inside the (expanded) heuristic box it builds a lip
    likelihood map from horizontal-edge energy (the lip gap is the
    strongest horizontal edge in the lower face), redness (lips vs skin)
    and darkness (the mouth opening), takes the peak row band + its column
    extent, and pads by a face-scaled margin (the ±20 px analog). Falls
    back to the input box when the evidence is weak — one more rung on the
    graceful-degradation ladder (SURVEY.md §5.3).
    """
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    if bw < 12 or bh < 8:
        return box
    # Search strictly INSIDE the heuristic box: it over-covers by
    # construction (chin/cheeks), and expanding it would admit
    # below-the-chin background whose darkness/noise poisons the map.
    region = frame[y1:y2, x1:x2].astype(np.float32)

    r, g, b = region[..., 0], region[..., 1], region[..., 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    # Lips vs skin: redder; the lip gap: the strongest horizontal edge.
    redness = np.clip(r - 0.5 * (g + b), 0.0, None)
    grad_y = np.zeros_like(gray)
    grad_y[1:] = np.abs(gray[1:] - gray[:-1])
    # Parameters (smooth k, extent thresholds) picked by sweep on the
    # synthetic-face agreement eval (scripts/eval_crop_agreement.py):
    # mean IoU vs the landmark-analog box 0.60 (heuristic) -> 0.84.
    lip_map = _box_smooth(_normalized(grad_y) + _normalized(redness), k=5)

    row_profile = lip_map.mean(axis=1)
    # Structure check: no clear row bump above the noise floor means no
    # lip evidence -> keep the heuristic box (degradation ladder).
    if float(row_profile.max() - np.median(row_profile)) < 0.12:
        return box

    ry1, ry2 = _profile_extent(row_profile, rel_threshold=0.35)
    col_profile = lip_map[ry1:ry2].mean(axis=0)
    rx1, rx2 = _profile_extent(col_profile, rel_threshold=0.25)

    # The reference landmark tier pads the lip extremes by a FIXED ±20 px
    # (face_detection.py:428-438) — reproduce that box geometry.
    pad = 20
    nx1 = max(0, x1 + rx1 - pad)
    nx2 = min(w, x1 + rx2 + pad)
    ny1 = max(0, y1 + ry1 - pad)
    ny2 = min(h, y1 + ry2 + pad)

    # Sanity: reject degenerate/implausible refinements.
    if (nx2 - nx1) < 0.25 * bw or (ny2 - ny1) < 0.10 * bh:
        return box
    if bbox_iou((nx1, ny1, nx2, ny2), box) < 0.05:
        return box
    return (int(nx1), int(ny1), int(nx2), int(ny2))


class LipRefinerBackend:
    """Wraps a face-heuristic backend and refines each mouth box with
    :func:`refine_mouth_box` — the no-mediapipe analog of the reference's
    landmark tier, wired into the default chain."""

    def __init__(self, inner: FaceDetectorBackend):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "name", f"{inner.name}+lip")

    def __getattr__(self, attr):  # pass through min_neighbors etc.
        return getattr(self.inner, attr)

    def __setattr__(self, attr, value):  # relaxed retry sets min_neighbors
        if attr in ("inner", "name"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self.inner, attr, value)

    def reset(self) -> None:
        if hasattr(self.inner, "reset"):
            self.inner.reset()

    def detect(self, frame: np.ndarray) -> List[Detection]:
        out = []
        for d in self.inner.detect(frame):
            out.append(
                Detection(
                    bbox=refine_mouth_box(frame, d.bbox),
                    detector=f"{d.detector}+lip",
                    score=d.score,
                )
            )
        return out


class FakeDetector:
    """Scripted backend for tests: returns preset boxes per frame index."""

    name = "fake"

    def __init__(self, script):
        """``script``: list (per frame) of lists of boxes, or a callable
        ``frame_idx -> List[Box]``. Indexing past the script yields []."""
        self._script = script
        self._idx = 0

    def reset(self) -> None:
        """Restart the per-video frame counter (called per pass)."""
        self._idx = 0

    def detect(self, frame: np.ndarray) -> List[Detection]:
        if callable(self._script):
            boxes = self._script(self._idx)
        elif self._idx < len(self._script):
            boxes = self._script[self._idx]
        else:
            boxes = []
        self._idx += 1
        return [Detection(bbox=tuple(b), detector=self.name) for b in boxes]


class ChainedDetector:
    """Fallback chain over backends (first non-empty wins) — the shape of
    the reference's FaceMesh -> FaceDetection -> Haar ladder
    (face_detection.py:387-413)."""

    name = "chain"

    def __init__(self, backends: Sequence[FaceDetectorBackend]):
        self.backends = list(backends)

    def detect(self, frame: np.ndarray) -> List[Detection]:
        for backend in self.backends:
            try:
                found = backend.detect(frame)
            except Exception as e:  # a tier crashing must not kill the frame
                logger.warning("%s backend failed: %s", backend.name, e)
                continue
            if found:
                return found
        return []


_default_backend: Optional[FaceDetectorBackend] = None


def get_default_backend(
    max_num_faces: int = 5, lip_refine: bool = True
) -> FaceDetectorBackend:
    """The reference's ladder (cached): the two MediaPipe tiers where the
    wheel imports, then the lip-localized cascades; a
    :class:`ChainedDetector` when there is more than one tier.

    The cascade tier emits face-heuristic mouth boxes; a lip-localization
    wrapper recovers landmark-tier crop precision without the mediapipe
    wheel. Two localizer rungs: the learned CNN
    (preprocessing/lip_localizer.py, when ``weights/lip_localizer.npz``
    exists and LIPSYNC_LIP_LOCALIZER != 0) with the image-evidence
    :class:`LipRefinerBackend` as fallback (measured IoU report:
    ``scripts/eval_crop_agreement.py``).
    """
    global _default_backend
    if _default_backend is not None:
        return _default_backend
    tiers: List[FaceDetectorBackend] = []
    for tier in (MediaPipeDetector, MediaPipeFaceDetectionDetector):
        try:
            tiers.append(tier(max_num_faces=max_num_faces))
        except ImportError:
            pass
    cascade: FaceDetectorBackend = CascadeDetector(max_num_faces=max_num_faces)
    if lip_refine:
        localizer = None
        try:
            from lipsync_tpu_torch.preprocessing import lip_localizer

            localizer = lip_localizer.load_default_localizer()
        except Exception as e:  # never let the learned tier kill detection
            logger.warning("learned lip localizer unavailable: %s", e)
        if localizer is not None:
            from lipsync_tpu_torch.preprocessing.lip_localizer import (
                LearnedLipBackend,
            )

            cascade = LearnedLipBackend(cascade, localizer)
        else:
            cascade = LipRefinerBackend(cascade)
    tiers.append(cascade)
    _default_backend = ChainedDetector(tiers) if len(tiers) > 1 else tiers[0]
    return _default_backend


def center_crop_box(h: int, w: int, crop: int = 96) -> Box:
    """Center-crop fallback box (video.py:293-312, face_detection.py:604-631)."""
    y1 = max(0, h // 2 - crop // 2)
    x1 = max(0, w // 2 - crop // 2)
    return (x1, y1, min(w, x1 + crop), min(h, y1 + crop))
