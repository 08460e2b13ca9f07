"""Video preprocessing: detection -> tracking -> batched device crops.

Counterpart of ``preprocessing/video.py`` in the JAX package. The host runs
decode (native ingest) and the serial detector/tracker state machine over
boxes; the pixel work (crop, bilinear resize, /255) runs as one batched call
per track on the device (``ops/image.py``). Crop counts are bucketed to
powers of two, with the padding slots repeating the last frame.

Native layouts: clips are ``(T, H, W, 3)`` float32 in [0, 1].
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.ops.image import crop_resize_normalize
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.face_detection import (
    FaceDetectorBackend,
    center_crop_box,
    get_default_backend,
)
from lipsync_tpu_torch.preprocessing.tracker import track_faces
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _bucket(n: int, base: int = 32) -> int:
    """Round up to a power-of-two multiple of ``base``."""
    size = base
    while size < n:
        size *= 2
    return size


def crop_track_on_device(
    frames: np.ndarray,
    boxes: Sequence[Sequence[int]],
    start_frame: int,
    crop_size: int = 96,
    device: DeviceLike = None,
) -> np.ndarray:
    """Crop ``boxes[i]`` from ``frames[start_frame + i]`` in one device call.

    Returns ``(len(boxes), crop, crop, 3)`` float32 in [0, 1].
    """
    n = len(boxes)
    if n == 0:
        return np.zeros((0, crop_size, crop_size, 3), np.float32)
    dev = get_device(device)
    padded_n = _bucket(n)
    idx = np.minimum(start_frame + np.arange(padded_n), len(frames) - 1)
    idx = np.minimum(idx, start_frame + n - 1)
    sel = frames[idx]  # (padded_n, H, W, 3) uint8
    box_arr = np.zeros((padded_n, 4), np.int32)
    box_arr[:n] = np.asarray(boxes, np.int32)
    box_arr[n:] = box_arr[n - 1]
    crops = crop_resize_normalize(
        torch.from_numpy(sel).to(dev), torch.from_numpy(box_arr).to(dev),
        crop_size,
    )
    return crops[:n].cpu().numpy()


def crop_mouth_uint8(
    frame: np.ndarray, box: Sequence[int], out_size: int = 96
) -> np.ndarray:
    """Host-side single crop resized to ``(out_size, out_size, 3)`` uint8.

    The pipelined long path crops frame by frame as the tracker finalizes
    slots. Bilinear with half-pixel centres, clamped at the crop boundary
    (the cv2.INTER_LINEAR convention of :func:`crop_resize_normalize`):
    ``cv2.resize`` where cv2 imports, as in the JAX package, else numpy,
    within one uint8 step of cv2.
    """
    h, w = frame.shape[:2]
    x1 = max(0, min(int(box[0]), w - 1))
    y1 = max(0, min(int(box[1]), h - 1))
    x2 = max(x1 + 1, min(int(box[2]), w))
    y2 = max(y1 + 1, min(int(box[3]), h))
    region = frame[y1:y2, x1:x2]
    try:
        import cv2
    except ImportError:
        return _resize_bilinear_uint8(region, out_size)
    return cv2.resize(region, (out_size, out_size),
                      interpolation=cv2.INTER_LINEAR)


def _resize_bilinear_uint8(region: np.ndarray, out_size: int) -> np.ndarray:
    """The numpy branch of :func:`crop_mouth_uint8`."""
    rh, rw = region.shape[:2]
    u = (np.arange(out_size, dtype=np.float32) + 0.5)
    sx = np.clip(u / out_size * rw - 0.5, 0, rw - 1)
    sy = np.clip(u / out_size * rh - 0.5, 0, rh - 1)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    x1i = np.minimum(x0 + 1, rw - 1)
    y1i = np.minimum(y0 + 1, rh - 1)
    wx = (sx - x0)[None, :, None]
    wy = (sy - y0)[:, None, None]
    f = region.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1i] * wx
    bot = f[y1i][:, x0] * (1 - wx) + f[y1i][:, x1i] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


@dataclasses.dataclass
class MouthTrack:
    """A tracked speaker's mouth-crop sequence (model-ready floats)."""

    track_id: int
    crops: np.ndarray  # (N, crop, crop, 3) float32 [0, 1]
    hits: int
    total_frames: int
    stability: float
    consecutive_miss_max: int
    track_start_frame: int
    track_end_frame: int
    # Mean mouth box over the track in source pixels (x1, y1, x2, y2).
    mean_bbox: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)


def detect_and_crop_tracks(
    frames: np.ndarray,
    backend: Optional[FaceDetectorBackend] = None,
    crop_size: int = 96,
    max_tracks: int = 5,
    iou_threshold: float = 0.25,
    iou_threshold_relaxed: float = 0.12,
    max_age: int = 15,
    min_stability: float = 0.35,
    device: DeviceLike = None,
) -> List[MouthTrack]:
    """Detect per frame, track, and crop every kept track on the device."""
    if backend is None:
        backend = get_default_backend()
    if hasattr(backend, "reset"):
        backend.reset()  # clear per-video ROI state
    h, w = frames.shape[1:3]
    detections = [backend.detect(f) for f in frames]

    # Zero-detection retry at relaxed sensitivity (the cascade analog of
    # the reference's MediaPipe retry at confidence 0.15).
    if not any(detections) and hasattr(backend, "min_neighbors") and (
        backend.min_neighbors > 1
    ):
        logger.warning(
            "Zero detections at min_neighbors=%d; retrying relaxed",
            backend.min_neighbors,
        )
        original = backend.min_neighbors
        try:
            backend.min_neighbors = 1
            if hasattr(backend, "reset"):
                backend.reset()
            detections = [backend.detect(f) for f in frames]
        finally:
            backend.min_neighbors = original

    results = track_faces(
        detections, h, w,
        max_tracks=max_tracks,
        iou_threshold=iou_threshold,
        iou_threshold_relaxed=iou_threshold_relaxed,
        max_age=max_age,
        min_stability=min_stability,
        crop_size=crop_size,
    )
    tracks = []
    for tr in results:
        crops = crop_track_on_device(
            frames, tr.boxes, tr.track_start_frame, crop_size, device=device
        )
        tracks.append(
            MouthTrack(
                track_id=tr.track_id,
                crops=crops,
                hits=tr.hits,
                total_frames=tr.total_frames,
                stability=tr.stability,
                consecutive_miss_max=tr.consecutive_miss_max,
                track_start_frame=tr.track_start_frame,
                track_end_frame=tr.track_end_frame,
                mean_bbox=mean_box(tr.boxes),
            )
        )
    return tracks


def mean_box(boxes) -> Tuple[float, float, float, float]:
    """Mean (x1, y1, x2, y2) over a track's per-frame boxes."""
    if not boxes:
        return (0.0, 0.0, 0.0, 0.0)
    m = np.asarray(boxes, np.float32).mean(axis=0)
    return (float(m[0]), float(m[1]), float(m[2]), float(m[3]))


def _fit_to_window(crops: np.ndarray, max_frames: int) -> np.ndarray:
    """Pad (repeat last) or uniformly sample to ``max_frames``."""
    t = crops.shape[0]
    if t == 0:
        return np.zeros((max_frames,) + crops.shape[1:], crops.dtype)
    if t < max_frames:
        pad = np.repeat(crops[-1:], max_frames - t, axis=0)
        return np.concatenate([crops, pad], axis=0)
    if t > max_frames:
        idx = np.linspace(0, t - 1, max_frames).astype(np.int64)
        return crops[idx]
    return crops


def preprocess_video(
    path: Path,
    use_face_detection: bool = True,
    crop_size: int = 96,
    max_frames: int = 32,
    target_fps: float = 15.0,
    max_total_frames: Optional[int] = None,
    backend: Optional[FaceDetectorBackend] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Single-clip preprocessing -> ``(max_frames, crop, crop, 3)`` float32:
    decode at ``target_fps``, the best track's mouth crops (a centre crop
    when no face is found), padded or sampled to the model window."""
    frames = ingest.read_video(path, target_fps, max_total_frames)
    if use_face_detection:
        tracks = detect_and_crop_tracks(
            frames, backend=backend, crop_size=crop_size, max_tracks=1,
            device=device,
        )
    else:
        tracks = []
    if tracks:
        crops = tracks[0].crops
    else:
        h, w = frames.shape[1:3]
        box = center_crop_box(h, w, crop_size)
        crops = crop_track_on_device(
            frames, [box] * len(frames), 0, crop_size, device=device
        )
    return _fit_to_window(crops, max_frames)


def preprocess_video_tracks(
    path: Path,
    crop_size: int = 96,
    max_frames: int = 32,
    max_tracks: int = 5,
    target_fps: float = 15.0,
    max_total_frames: Optional[int] = None,
    backend: Optional[FaceDetectorBackend] = None,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Multi-subject short-video preprocessing: per-track dicts with
    ``clip`` ``(max_frames, crop, crop, 3)``."""
    frames = ingest.read_video(path, target_fps, max_total_frames)
    tracks = detect_and_crop_tracks(
        frames, backend=backend, crop_size=crop_size, max_tracks=max_tracks,
        device=device,
    )
    return [
        {
            "track_id": tr.track_id,
            "clip": _fit_to_window(tr.crops, max_frames),
            "hits": tr.hits,
            "total_frames": tr.total_frames,
            "stability": tr.stability,
            "mean_bbox": tr.mean_bbox,
        }
        for tr in tracks
    ]


@dataclasses.dataclass
class ChunkedTrack:
    """A track split into overlapping model windows.

    ``crops`` holds the whole track once and ``chunk_starts`` are local
    offsets into it; the engine gathers the windows on the device.
    ``abs_chunk_starts`` are absolute video frame indices (audio alignment).
    """

    track_id: int
    crops: np.ndarray  # (N, crop, crop, 3) float32 [0,1] or uint8
    chunk_starts: List[int]  # local start index per window
    abs_chunk_starts: List[int]  # absolute video frame per window
    chunk_size: int
    hits: int
    total_frames: int
    stability: float
    consecutive_miss_max: int
    track_start_frame: int
    track_end_frame: int
    mean_bbox: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_starts)

    def chunk(self, j: int) -> np.ndarray:
        """Window j on the host: ``(chunk_size, crop, crop, 3)`` float32 in
        [0, 1] (uint8 crop buffers, which the pipelined path keeps, are
        normalized here)."""
        s = self.chunk_starts[j]
        window = self.crops[s : s + self.chunk_size]
        if window.shape[0] < self.chunk_size:
            pad = np.repeat(
                window[-1:], self.chunk_size - window.shape[0], axis=0
            )
            window = np.concatenate([window, pad], axis=0)
        if window.dtype == np.uint8:
            window = window.astype(np.float32) / 255.0
        return window


def preprocess_video_tracks_chunked(
    path: Path,
    chunk_size: int = 32,
    stride: int = 8,
    max_tracks: int = 6,
    crop_size: int = 96,
    max_total_frames: Optional[int] = None,
    target_fps: float = 15.0,
    backend: Optional[FaceDetectorBackend] = None,
    device: DeviceLike = None,
) -> Tuple[List[ChunkedTrack], float, int]:
    """Long-video preprocessing: whole-clip tracking, then overlapping
    windows with absolute start frames per track."""
    frames = ingest.read_video(path, target_fps, max_total_frames)
    total_frames = len(frames)
    tracks = detect_and_crop_tracks(
        frames, backend=backend, crop_size=crop_size, max_tracks=max_tracks,
        device=device,
    )

    out: List[ChunkedTrack] = []
    for tr in tracks:
        n = tr.crops.shape[0]
        starts = list(range(0, max(n - chunk_size, 0) + 1, stride)) if (
            n >= chunk_size
        ) else [0]
        # The reference's loop: while start + chunk <= N, step stride.
        starts = [s for s in starts if s + chunk_size <= n] or [0]
        out.append(
            ChunkedTrack(
                track_id=tr.track_id,
                crops=tr.crops,
                chunk_starts=starts,
                abs_chunk_starts=[tr.track_start_frame + s for s in starts],
                chunk_size=chunk_size,
                hits=tr.hits,
                total_frames=total_frames,
                stability=tr.stability,
                consecutive_miss_max=tr.consecutive_miss_max,
                track_start_frame=tr.track_start_frame,
                track_end_frame=tr.track_end_frame,
                mean_bbox=tr.mean_bbox,
            )
        )
    return out, float(target_fps), total_frames
