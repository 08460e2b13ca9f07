"""Host media ingest: ctypes bindings over the native C++ FFmpeg library.

Counterpart of ``preprocessing/ingest.py`` in the JAX package, over the same
``native/ingest.cc``: PTS-accurate fps resampling, RGB24 frames and mono
float PCM written straight into numpy buffers. The library is compiled into
``build/lipsync_tpu_torch_native/`` (``utils/native.py``), never into
``native/``.

Degradation ladder, as in the JAX package: the native library, then OpenCV
for video and the standard library's ``wave`` for WAV audio, then an error.
Every exception that ``probe``, ``read_video`` or ``read_audio`` raises
carries the reader's name (:func:`is_read_failure`), so that a tool or the
raw-video dataset can skip a file it could not read without skipping a
failure of the stages after it (:func:`host_stage_failed`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from lipsync_tpu_torch.utils import native
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class _IngestInfoC(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("fps", ctypes.c_double),
        ("duration_sec", ctypes.c_double),
        ("nb_frames", ctypes.c_int64),
        ("has_audio", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
    ]


@dataclasses.dataclass
class MediaInfo:
    width: int = 0
    height: int = 0
    fps: float = 0.0
    duration_sec: float = 0.0
    nb_frames: int = 0
    has_audio: bool = False
    sample_rate: int = 0


_lib = None
_lib_tried = False
READ_FAILURE = "ingest_read_failure"


def _marks_failures(reader):
    """``reader``, with every exception it raises marked by its name."""
    @functools.wraps(reader)
    def read(*args, **kwargs):
        try:
            return reader(*args, **kwargs)
        except Exception as e:
            if not hasattr(e, READ_FAILURE):
                setattr(e, READ_FAILURE, reader.__name__)
            raise
    return read


def is_read_failure(exc: BaseException) -> bool:
    """Whether ``exc`` came out of ``probe``, ``read_video`` or
    ``read_audio``: the file could not be read."""
    return hasattr(exc, READ_FAILURE)


class HostStageError(Exception):
    """An input file that a host stage could not use: no audio stream, no
    face track. A caller records the file and goes on."""


def host_stage_failed(exc: BaseException) -> bool:
    """Whether ``exc`` says that one input file was unusable (ingest could
    not read it, or a :class:`HostStageError`), and not that the program
    failed: a kernel wrapper's ``RuntimeError`` or ``ValueError``, a CUDA
    error or a shape fault is none of these."""
    return isinstance(exc, HostStageError) or is_read_failure(exc)


def get_native_lib():
    """The native ingest library (built on first use), or None when it
    cannot be built or loaded here (no compiler or no FFmpeg)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = native.library("ingest")
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        logger.warning("native ingest unavailable: %s", e)
        return None
    lib.ingest_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_IngestInfoC)]
    lib.ingest_probe.restype = ctypes.c_int
    lib.ingest_read_video.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.ingest_read_video.restype = ctypes.c_int64
    lib.ingest_read_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ]
    lib.ingest_read_audio.restype = ctypes.c_int64
    _lib = lib
    return _lib


@_marks_failures
def probe(path: os.PathLike) -> MediaInfo:
    """Container metadata without decoding."""
    lib = get_native_lib()
    if lib is not None:
        info = _IngestInfoC()
        if lib.ingest_probe(str(path).encode(), ctypes.byref(info)) == 0:
            return MediaInfo(
                width=info.width, height=info.height, fps=info.fps,
                duration_sec=info.duration_sec, nb_frames=info.nb_frames,
                has_audio=bool(info.has_audio), sample_rate=info.sample_rate,
            )
    return _probe_cv2(path)


def _probe_cv2(path) -> MediaInfo:
    try:
        import cv2
    except ImportError:
        return MediaInfo()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return MediaInfo()
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return MediaInfo(
        width=w, height=h, fps=fps,
        duration_sec=n / fps if fps > 0 else 0.0, nb_frames=max(0, n),
    )


@_marks_failures
def read_video(
    path: os.PathLike,
    target_fps: float = 15.0,
    max_total_frames: Optional[int] = None,
    out_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Decode frames resampled to ``target_fps`` -> (N, H, W, 3) uint8 RGB.

    The first frame at or past each target timestamp (with half-interval
    tolerance) fills that slot; a frame may fill several slots.
    """
    cap_frames = max_total_frames
    if cap_frames is None:
        info = probe(path)
        dur = info.duration_sec if info.duration_sec > 0 else 3600.0
        cap_frames = max(1, int(dur * target_fps) + 2)

    lib = get_native_lib()
    if lib is not None:
        info = probe(path)
        w, h = (out_size if out_size else (info.width, info.height))
        if w > 0 and h > 0:
            # Zeroed, not empty: the native RGB conversion (swscale's
            # unscaled path) leaves the last ``w % 8`` columns of every
            # frame unwritten, and an empty buffer would hand them out as
            # whatever the heap held before (different in every process).
            buf = np.zeros((cap_frames, h, w, 3), np.uint8)
            n = lib.ingest_read_video(
                str(path).encode(), float(target_fps), cap_frames, w, h,
                buf.reshape(-1),
            )
            if n > 0:
                return buf[:n].copy()
            logger.warning(
                "native decode failed (%d) for %s — OpenCV fallback", n, path
            )
    return _read_video_cv2(path, target_fps, cap_frames, out_size)


def _read_video_cv2(path, target_fps, max_frames, out_size=None) -> np.ndarray:
    """OpenCV rung with the same timestamp sampling (tolerates 10
    consecutive read failures)."""
    try:
        import cv2
    except ImportError as e:
        raise ValueError(
            f"Cannot decode {path}: no native ingest and no OpenCV"
        ) from e

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise ValueError(f"Cannot open video {path}")
    src_fps = float(cap.get(cv2.CAP_PROP_FPS)) or target_fps
    frames = []
    next_target = 0
    half = 0.5 / target_fps
    failures = 0
    i = 0
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            failures += 1
            if failures > 10:
                break
            i += 1
            continue
        failures = 0
        t = i / src_fps
        img = None
        while len(frames) < max_frames and t >= next_target / target_fps - half:
            if img is None:
                img = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if out_size:
                    img = cv2.resize(img, out_size,
                                     interpolation=cv2.INTER_LINEAR)
            frames.append(img.copy())
            next_target += 1
        i += 1
    cap.release()
    if not frames:
        raise ValueError(f"No valid frames decoded from video {path}")
    return np.stack(frames)


@_marks_failures
def read_audio(path: os.PathLike, sr: int = 16000) -> np.ndarray:
    """Mono float32 PCM at ``sr`` from any container (audio or video)."""
    lib = get_native_lib()
    if lib is not None:
        info = probe(path)
        dur = info.duration_sec if info.duration_sec > 0 else 3600.0
        max_samples = int((dur + 2.0) * sr)
        buf = np.empty(max_samples, np.float32)
        n = lib.ingest_read_audio(str(path).encode(), sr, buf, max_samples)
        if n > 0:
            return buf[:n].copy()
        if n == 0:
            return np.zeros(0, np.float32)
        logger.warning("native audio decode failed (%d) for %s", n, path)
    return _read_audio_wave(path, sr)


def _read_audio_wave(path, sr) -> np.ndarray:
    """Standard-library rung, for WAV files only."""
    import wave

    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
        src_sr = w.getframerate()
    if width == 2:
        y = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        y = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        y = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if channels > 1:
        y = y.reshape(-1, channels).mean(axis=1)
    if src_sr != sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(src_sr, sr)
        y = resample_poly(y, sr // g, src_sr // g).astype(np.float32)
    return y
