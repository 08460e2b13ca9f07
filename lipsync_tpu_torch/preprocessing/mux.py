"""ctypes binding for the native muxer: write RGB frames and PCM to a file.

Counterpart of ``preprocessing/mux.py`` in the JAX package, over the same
``native/mux.cc`` (an ``.avi`` target uses the built-in mpeg4 and
pcm_s16le encoders): :func:`write_video`, and :func:`h264_roundtrip`, the
codec perturbation of the robustness grid. The library is compiled into
``build/lipsync_tpu_torch_native/`` (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from lipsync_tpu_torch.utils import native

_lib = None


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = native.library("mux")
    lib.mux_write_video_ex.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.mux_write_video_ex.restype = ctypes.c_int
    _lib = lib
    return lib


def write_video(
    path: Path,
    frames: np.ndarray,
    fps: float = 15.0,
    pcm: Optional[np.ndarray] = None,
    sample_rate: int = 16000,
    vcodec: str = "mpeg4",
    vcodec_opts: Optional[str] = None,
) -> Path:
    """Write (N, H, W, 3) uint8 RGB frames (+ optional mono float PCM).

    ``vcodec``/``vcodec_opts`` select the libavcodec encoder and its
    private options (e.g. ``vcodec="libx264", vcodec_opts="crf=28:
    preset=veryfast"``), the surface behind the H.264 compression
    robustness axis."""
    lib = _get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"expected RGB frames, got {c} channels")
    if pcm is not None:
        pcm = np.ascontiguousarray(pcm, np.float32)
        pcm_ptr = pcm.ctypes.data_as(ctypes.c_void_p)
        n_samples = len(pcm)
    else:
        pcm_ptr, n_samples = None, 0
    rc = lib.mux_write_video_ex(
        str(path).encode(), frames, n, w, h, float(fps),
        pcm_ptr, n_samples, sample_rate,
        vcodec.encode(), (vcodec_opts or "").encode(),
    )
    if rc != 0:
        raise RuntimeError(f"mux_write_video failed ({rc}) for {path}")
    return Path(path)


def h264_roundtrip(
    frames: np.ndarray, crf: int, fps: float = 15.0
) -> np.ndarray:
    """Encode (N, H, W, 3) uint8 RGB frames as H.264 at the given CRF and
    decode them back, the codec perturbation for the robustness grid.

    Frame count and size are preserved (CFR stream, full decode, no PTS
    resampling). Requires even H/W (yuv420p); model crops are 96x96.
    Raises ``RuntimeError`` if the decode returns fewer frames."""
    import tempfile

    import cv2

    frames = np.ascontiguousarray(frames, np.uint8)
    n = frames.shape[0]
    # cv2's mp4 demux drops a trailing frame on very short streams; pad
    # with duplicates of the last frame and trim after decode.
    pad = max(0, 12 - n)
    if pad:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0
        )
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=True) as tmp:
        # bf=0: no B-frames, so decode order == presentation order and
        # short streams round-trip to the exact frame count.
        write_video(
            Path(tmp.name), frames, fps=fps,
            vcodec="libx264",
            vcodec_opts=f"crf={int(crf)}:preset=veryfast:bf=0",
        )
        cap = cv2.VideoCapture(tmp.name)
        out = []
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                out.append(bgr[..., ::-1])
        finally:
            cap.release()
    if len(out) < n:
        raise RuntimeError(
            f"h264_roundtrip frame count changed: {n} -> {len(out)}"
        )
    return np.stack(out[:n]).astype(np.uint8)
