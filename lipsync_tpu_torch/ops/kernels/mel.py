"""K1: the fused log-mel kernel (``csrc/mel.cu``), its wrapper and its twin.

Counterpart of ``ops/pallas/mel_kernel.py::log_mel_spectrogram_pallas`` in
the JAX package. The wrapper launches the CUDA kernel for a CUDA tensor and
runs the plain PyTorch twin (:func:`log_mel_db_plain`, the same DFT-matmul
chain in fp32) only for a CPU tensor. The clip-max reference and the
``-top_db`` floor are torch ops on the small output, as in the JAX wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build
from lipsync_tpu_torch.ops.mel import hann_window, mel_filterbank

SR, N_FFT, HOP, N_MELS = 16000, 400, 160, 80

# Launches of the CUDA kernel in this process (the CPU twin does not count),
# in all and by device.
launches = 0
launches_by_device: Dict[str, int] = {}

_tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
_kernel_tables: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}


def _host_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hann-folded DFT cos/sin bases ``(400, 201)`` built in float64 and cast
    to fp32, and the transposed mel filterbank ``(201, 80)``."""
    window = hann_window(N_FFT).astype(np.float64)
    n = np.arange(N_FFT)[:, None]
    k = np.arange(1 + N_FFT // 2)[None, :]
    ang = 2.0 * np.pi * n * k / N_FFT
    wc = (window[:, None] * np.cos(ang)).astype(np.float32)
    ws = (window[:, None] * np.sin(ang)).astype(np.float32)
    fbt = np.ascontiguousarray(mel_filterbank(SR, N_FFT, N_MELS).T)
    return wc, ws, fbt


def tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``(wc, ws, fbt)`` fp32 on ``device``, built once per device."""
    device = torch.device(device)
    if device not in _tables:
        _tables[device] = tuple(
            torch.from_numpy(t).to(device) for t in _host_tables()
        )
    return _tables[device]


def _host_kernel_tables() -> Tuple[np.ndarray, ...]:
    """The kernel's tables: the Hann window ``(400,)``, the twiddles
    ``cos, sin(2*pi*m/400)`` ``(400,)`` (float64, cast to fp32), the
    transposed filterbank ``(201, 80)`` and each mel band's support
    ``(80, 2)``: its first and last nonzero bin (``(0, -1)`` if none). The
    kernel reads basis entry ``(n, k)`` as ``window[n] * twiddle[n*k % 400]``."""
    ang = 2.0 * np.pi * np.arange(N_FFT) / N_FFT
    fbt = np.ascontiguousarray(mel_filterbank(SR, N_FFT, N_MELS).T)
    bands = np.zeros((N_MELS, 2), np.int32)
    bands[:, 1] = -1
    for m in range(N_MELS):
        nz = np.flatnonzero(fbt[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1]
    return (hann_window(N_FFT).astype(np.float32),
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            fbt, bands)


def kernel_tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``(window, cos, sin, fbt, bands)`` on ``device``, built once."""
    device = torch.device(device)
    if device not in _kernel_tables:
        _kernel_tables[device] = tuple(
            torch.from_numpy(t).to(device) for t in _host_kernel_tables()
        )
    return _kernel_tables[device]


def frames_per_block(b: int, t: int, n_sms: int) -> int:
    """K1's frames per block: 8 where ``b`` clips of ``t`` frames still give
    every SM a block at 8, else 3."""
    return 8 if b * -(-t // 8) >= n_sms else 3


def n_frames_for(n: int) -> int:
    """Frame count of a centre-padded clip of ``n`` samples."""
    return 1 + n // HOP


def log_mel_db_plain(y: torch.Tensor) -> torch.Tensor:
    """Twin of the kernel: ``(B, N)`` fp32 PCM -> ``(B, 80, T)`` absolute dB
    through the same DFT-matmul chain, in plain PyTorch."""
    wc, ws, fbt = tables(y.device)
    yp = F.pad(y, (N_FFT // 2, N_FFT // 2))
    frames = yp.unfold(-1, N_FFT, HOP)  # (B, T, 400)
    c = frames @ wc
    s = frames @ ws
    mel = (c * c + s * s) @ fbt  # (B, T, 80)
    return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)


def log_mel_db(y: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` fp32 PCM -> ``(B, 80, 1 + N//160)`` absolute dB. Launches
    K1 for a CUDA tensor; the twin runs only for a CPU tensor."""
    global launches
    if y.dim() != 2:
        raise ValueError(f"expected (B, N) PCM, got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32 PCM, got {y.dtype}")
    if y.device.type == "cpu":
        return log_mel_db_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not y.is_contiguous():
        raise ValueError("PCM must be contiguous")
    b, n = y.shape
    if b == 0 or n == 0:
        raise ValueError("empty PCM")
    t = n_frames_for(n)
    win, twc, tws, fbt, bands = kernel_tables(y.device)
    out = torch.empty((b, N_MELS, t), dtype=torch.float32, device=y.device)
    n_sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.lipsync_log_mel(
            y.data_ptr(), win.data_ptr(), twc.data_ptr(), tws.data_ptr(),
            fbt.data_ptr(), bands.data_ptr(), out.data_ptr(), b, n, t,
            frames_per_block(b, t, n_sms), stream,
        )
    if err != 0:
        raise RuntimeError(f"log_mel kernel launch failed: cudaError {err}")
    with build.COUNT_LOCK:
        launches += 1
        key = str(y.device)
        launches_by_device[key] = launches_by_device.get(key, 0) + 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("mel")
    fn = lib.lipsync_log_mel
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def finish_db(db: torch.Tensor, top_db: Optional[float] = 80.0) -> torch.Tensor:
    """dB relative to each clip's peak, floored at ``-top_db``."""
    db = db - db.amax(dim=(-2, -1), keepdim=True)
    if top_db is not None:
        db = torch.clamp(db, min=-top_db)
    return db


def log_mel_spectrogram_fused(
    y: torch.Tensor, top_db: Optional[float] = 80.0
) -> torch.Tensor:
    """:func:`lipsync_tpu_torch.ops.mel.log_mel_spectrogram` at its defaults
    (16 kHz, n_fft = win = 400, hop 160, 80 mels, centred) with the chain in
    one kernel: ``(N,)`` -> ``(80, T)`` or ``(B, N)`` -> ``(B, 80, T)`` dB."""
    squeeze = y.dim() == 1
    y2 = y.reshape(1, -1) if squeeze else y
    out = finish_db(log_mel_db(y2.to(torch.float32).contiguous()), top_db)
    return out[0] if squeeze else out
