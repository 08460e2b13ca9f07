"""K1: the fused log-mel kernel (``csrc/mel.cu``), its wrapper and its twin.

Counterpart of ``ops/pallas/mel_kernel.py::log_mel_spectrogram_pallas`` in
the JAX package, over the same parameters and the same range: any sample
rate and hop, centred or not, ``win_length = n_fft <= 511`` and ``n_mels <=
128`` (the Pallas kernel's padded widths); outside it the wrapper raises
``ValueError`` before any launch. The wrapper launches the CUDA kernel for
a CUDA tensor and runs the plain PyTorch twin (:func:`log_mel_db_plain`,
the same DFT-matmul chain in fp32) only for a CPU tensor. Tables are built
once per device and parameter set. The clip-max reference and the
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

# The defaults of the JAX package's log-mel, and the Pallas kernel's range:
# n_fft / 2 + 1 bins within its _BINS_PAD (256), mel bands within its
# _MELS_PAD (128), win_length = n_fft.
SR, N_FFT, HOP, N_MELS = 16000, 400, 160, 80
MAX_N_FFT = 511
MAX_MELS = 128

# Launches of the CUDA kernel in this process (the CPU twin does not count),
# in all and by device.
launches = 0
launches_by_device: Dict[str, int] = {}

_tables: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
_kernel_tables: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def range_error(n_fft: int, win_length: int, n_mels: int) -> Optional[str]:
    """Why the kernel does not take these sizes, naming the limit (the
    Pallas kernel refuses the same sets), or None where it takes them."""
    if win_length != n_fft:
        return (f"win_length must equal n_fft in this kernel (got "
                f"{win_length} and {n_fft})")
    if not 1 <= n_fft <= MAX_N_FFT:
        return (f"n_fft {n_fft} outside this kernel's 1..{MAX_N_FFT} "
                f"(n_fft // 2 + 1 <= 256 bins)")
    if not 1 <= n_mels <= MAX_MELS:
        return f"n_mels {n_mels} outside this kernel's 1..{MAX_MELS}"
    return None


def _host_tables(sr: int = SR, n_fft: int = N_FFT, n_mels: int = N_MELS
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hann-folded DFT cos/sin bases ``(n_fft, n_fft//2 + 1)`` built in
    float64 and cast to fp32, and the transposed mel filterbank
    ``(n_fft//2 + 1, n_mels)``."""
    window = hann_window(n_fft).astype(np.float64)
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    wc = (window[:, None] * np.cos(ang)).astype(np.float32)
    ws = (window[:, None] * np.sin(ang)).astype(np.float32)
    fbt = np.ascontiguousarray(mel_filterbank(sr, n_fft, n_mels).T)
    return wc, ws, fbt


def tables(device: torch.device, sr: int = SR, n_fft: int = N_FFT,
           n_mels: int = N_MELS) -> Tuple[torch.Tensor, ...]:
    """``(wc, ws, fbt)`` fp32 on ``device``, built once per device and
    parameter set."""
    key = (torch.device(device), sr, n_fft, n_mels)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(t).to(key[0])
                             for t in _host_tables(sr, n_fft, n_mels))
    return _tables[key]


def _host_kernel_tables(sr: int = SR, n_fft: int = N_FFT,
                        n_mels: int = N_MELS) -> Tuple[np.ndarray, ...]:
    """The kernel's tables: the Hann window ``(n_fft,)``, the twiddles
    ``cos, sin(2*pi*m/n_fft)`` ``(n_fft,)`` (float64, cast to fp32), the
    transposed filterbank ``(n_fft//2 + 1, n_mels)`` and each mel band's
    support ``(n_mels, 2)``: its first and last nonzero bin (``(0, -1)`` if
    none). The kernel reads basis entry ``(n, k)`` as ``window[n] *
    twiddle[n*k % n_fft]``."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    fbt = np.ascontiguousarray(mel_filterbank(sr, n_fft, n_mels).T)
    bands = np.zeros((n_mels, 2), np.int32)
    bands[:, 1] = -1
    for m in range(n_mels):
        nz = np.flatnonzero(fbt[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1]
    return (hann_window(n_fft).astype(np.float32),
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
            fbt, bands)


def kernel_tables(device: torch.device, sr: int = SR, n_fft: int = N_FFT,
                  n_mels: int = N_MELS) -> Tuple[torch.Tensor, ...]:
    """``(window, cos, sin, fbt, bands)`` on ``device``, built once per
    device and parameter set."""
    key = (torch.device(device), sr, n_fft, n_mels)
    if key not in _kernel_tables:
        _kernel_tables[key] = tuple(
            torch.from_numpy(t).to(key[0])
            for t in _host_kernel_tables(sr, n_fft, n_mels))
    return _kernel_tables[key]


def frames_per_block(b: int, t: int, n_sms: int) -> int:
    """K1's frames per block: 8 where ``b`` clips of ``t`` frames still give
    every SM a block at 8, else 3."""
    return 8 if b * -(-t // 8) >= n_sms else 3


def n_frames_for(n: int, n_fft: int = N_FFT, hop_length: int = HOP,
                 center: bool = True) -> int:
    """Frame count of a clip of ``n`` samples: ``1 + (n + 2 pad - n_fft) //
    hop`` with ``pad = n_fft // 2`` for centred frames, else 0."""
    pad = n_fft // 2 if center else 0
    return 1 + (n + 2 * pad - n_fft) // hop_length


def log_mel_db_plain(
    y: torch.Tensor,
    sr: int = SR,
    n_fft: int = N_FFT,
    hop_length: int = HOP,
    win_length: int = N_FFT,
    n_mels: int = N_MELS,
    center: bool = True,
) -> torch.Tensor:
    """Twin of the kernel: ``(B, N)`` fp32 PCM -> ``(B, n_mels, T)``
    absolute dB through the same DFT-matmul chain, in plain PyTorch
    (``win_length`` is ``n_fft`` here, as in the kernel)."""
    wc, ws, fbt = tables(y.device, sr, n_fft, n_mels)
    if center:
        y = F.pad(y, (n_fft // 2, n_fft // 2))
    frames = y.unfold(-1, n_fft, hop_length)  # (B, T, n_fft)
    c = frames @ wc
    s = frames @ ws
    mel = (c * c + s * s) @ fbt  # (B, T, n_mels)
    return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))).transpose(1, 2)


def log_mel_db(
    y: torch.Tensor,
    sr: int = SR,
    n_fft: int = N_FFT,
    hop_length: int = HOP,
    win_length: int = N_FFT,
    n_mels: int = N_MELS,
    center: bool = True,
) -> torch.Tensor:
    """``(B, N)`` fp32 PCM -> ``(B, n_mels, T)`` absolute dB, ``T =``
    :func:`n_frames_for`. Launches K1 for a CUDA tensor; the twin runs only
    for a CPU tensor. Raises ``ValueError`` outside the kernel's range."""
    why = range_error(n_fft, win_length, n_mels)
    if why is not None:
        raise ValueError(why)
    if hop_length < 1:
        raise ValueError(f"hop_length must be positive, got {hop_length}")
    if y.dim() != 2:
        raise ValueError(f"expected (B, N) PCM, got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32 PCM, got {y.dtype}")
    b, n = y.shape
    if b == 0 or n == 0:
        raise ValueError("empty PCM")
    t = n_frames_for(n, n_fft, hop_length, center)
    if t < 1:
        raise ValueError(f"{n} samples give no frame of {n_fft}")
    params = dict(sr=sr, n_fft=n_fft, hop_length=hop_length,
                  win_length=win_length, n_mels=n_mels, center=center)
    if y.device.type == "cpu":
        return log_mel_db_plain(y, **params)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not y.is_contiguous():
        raise ValueError("PCM must be contiguous")
    return _launch(y, params, t)


def _launch(y: torch.Tensor, params: dict, t: int,
            general: bool = False) -> torch.Tensor:
    """One launch of K1 on ``y`` (checked by :func:`log_mel_db`).
    ``general`` takes the run-time-sized kernel even at ``n_fft = 400``,
    for timing it against the fixed one; it counts as a launch."""
    global launches
    b, n = y.shape
    n_fft, n_mels = params["n_fft"], params["n_mels"]
    win, twc, tws, fbt, bands = kernel_tables(y.device, params["sr"], n_fft,
                                              n_mels)
    out = torch.empty((b, n_mels, t), dtype=torch.float32, device=y.device)
    n_sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.lipsync_log_mel(
            y.data_ptr(), win.data_ptr(), twc.data_ptr(), tws.data_ptr(),
            fbt.data_ptr(), bands.data_ptr(), out.data_ptr(), b, n, t,
            n_fft, params["hop_length"], n_mels, int(params["center"]),
            frames_per_block(b, t, n_sms), int(general), stream,
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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def finish_db(db: torch.Tensor, top_db: Optional[float] = 80.0) -> torch.Tensor:
    """dB relative to each clip's peak, floored at ``-top_db``."""
    db = db - db.amax(dim=(-2, -1), keepdim=True)
    if top_db is not None:
        db = torch.clamp(db, min=-top_db)
    return db


def log_mel_spectrogram_fused(
    y: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    center: bool = True,
    top_db: Optional[float] = 80.0,
) -> torch.Tensor:
    """:func:`lipsync_tpu_torch.ops.mel.log_mel_spectrogram` with the chain
    in one kernel: ``(N,)`` -> ``(n_mels, T)`` or ``(B, N)`` -> ``(B,
    n_mels, T)`` dB. Takes the Pallas kernel's range (``win_length =
    n_fft <= 511``, ``n_mels <= 128``) and raises ``ValueError`` outside
    it."""
    squeeze = y.dim() == 1
    y2 = y.reshape(1, -1) if squeeze else y
    db = log_mel_db(y2.to(torch.float32).contiguous(), sr=sr, n_fft=n_fft,
                    hop_length=hop_length, win_length=win_length,
                    n_mels=n_mels, center=center)
    out = finish_db(db, top_db)
    return out[0] if squeeze else out
