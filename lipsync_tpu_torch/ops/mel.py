"""Log-mel spectrogram: numpy constants and the plain PyTorch chain.

Counterpart of ``ops/mel.py`` in the JAX package, with its own copies of
the host-side constants: periodic Hann window, Slaney-scale/Slaney-norm mel
filterbank (librosa defaults), ``center=True`` zero padding, dB relative to
the clip's peak, floor at ``-top_db``.

:func:`log_mel_spectrogram` is the straightforward rFFT chain. The serving
path goes through the CUDA kernel instead (``ops/kernels/mel.py``); this
function is the numerics reference and the library yardstick it is timed
against.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_slaney(f) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mel,
    )


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(
    sr: int = 16000,
    n_fft: int = 400,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, ``(n_mels, 1 + n_fft//2)``
    (``librosa.filters.mel`` defaults: htk=False, norm="slaney")."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constants(sr: int, n_fft: int, win_length: int, n_mels: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (centred) window and the filterbank on ``device``, built once."""
    window = hann_window(win_length)
    if win_length < n_fft:  # librosa centres the window inside n_fft
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    fb = mel_filterbank(sr, n_fft, n_mels)
    return torch.from_numpy(window).to(device), torch.from_numpy(fb).to(device)


def log_mel_spectrogram(
    y: torch.Tensor,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    center: bool = True,
    top_db: Optional[float] = 80.0,
) -> torch.Tensor:
    """Mono PCM ``(N,)`` -> ``(n_mels, n_frames)`` dB on ``y.device``
    (``power_to_db(ref=max)`` semantics, floor at ``-top_db``)."""
    y = y.to(torch.float32)
    if center:
        pad = n_fft // 2
        y = torch.nn.functional.pad(y, (pad, pad))
    frames = y.unfold(0, n_fft, hop_length)  # (n_frames, n_fft) view
    window, fb = _constants(sr, n_fft, win_length, n_mels, y.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = (power @ fb.T).T  # (n_mels, n_frames)
    return power_to_db(mel, top_db=top_db)


def power_to_db(
    s: torch.Tensor, amin: float = 1e-10, top_db: Optional[float] = 80.0
) -> torch.Tensor:
    """``librosa.power_to_db(S, ref=np.max)``."""
    ref = torch.clamp(s.max(), min=amin)
    log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(ref)
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def pad_or_truncate_frames(mel_db: np.ndarray, target_frames: int) -> np.ndarray:
    """Truncate, or pad by repeating the LAST frame (host side)."""
    t = mel_db.shape[-1]
    if t < target_frames:
        pad = np.repeat(mel_db[..., -1:], target_frames - t, axis=-1)
        return np.concatenate([mel_db, pad], axis=-1)
    return mel_db[..., :target_frames]
