"""ctypes binding for the native muxer: write RGB frames and PCM to a file.

Counterpart of ``preprocessing/mux.py::write_video`` in the JAX package,
over the same ``native/mux.cc`` (an ``.avi`` target uses the built-in
mpeg4 and pcm_s16le encoders). The library is compiled into
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
) -> Path:
    """Write (N, H, W, 3) uint8 RGB frames (+ optional mono float PCM),
    video as mpeg4."""
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
        pcm_ptr, n_samples, sample_rate, b"mpeg4", b"",
    )
    if rc != 0:
        raise RuntimeError(f"mux_write_video failed ({rc}) for {path}")
    return Path(path)
