"""Audio preprocessing: ingest -> log-mel dB on the device, and the VAD.

Counterpart of ``preprocessing/audio.py`` in the JAX package, with its
parameters (``sr, n_mels, hop_length, win_length, target_frames``; ``n_fft
= win_length``) and ``device``. The route follows from the parameters
alone, before any launch: inside K1's range (``win_length <= 511``,
``n_mels <= 128``, the Pallas kernel's) the spectrogram goes through the
fused kernel K1 (``ops/kernels/mel.py``; on the CPU its wrapper runs the
plain twin), and outside it through ``ops/mel.py::log_mel_spectrogram``,
the counterpart of the XLA chain that the JAX package takes by default. A
K1 failure inside the range raises; it never falls over to the chain. The
voice-activity mask is numpy on the host (``ops/vad.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.ops.kernels.mel import (
    log_mel_spectrogram_fused,
    range_error,
)
from lipsync_tpu_torch.ops.mel import (
    log_mel_spectrogram,
    pad_or_truncate_frames,
)
from lipsync_tpu_torch.ops.vad import detect_voice_activity_pcm
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def preprocess_audio_pcm(
    y: np.ndarray,
    sr: int = 16000,
    n_mels: int = 80,
    hop_length: int = 160,
    win_length: int = 400,
    target_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Mono PCM -> ``(n_mels, T)`` float32 log-mel dB, ``T = 1 + len(y) //
    hop_length`` (``n_fft = win_length``), through K1 inside its range and
    through ``ops/mel.py::log_mel_spectrogram`` outside it (module
    docstring).

    The PCM length is bucketed to the next power of two (at least 16384),
    as in the JAX package. The zero tail is inert: its frames are sliced off,
    the last true frames see zeros exactly as centre padding supplies them,
    and the dB reference can only come from the true frames.
    """
    if y.size == 0:
        raise ValueError("Empty audio signal")
    dev = get_device(device)
    n_true = len(y)
    n_frames_true = 1 + n_true // hop_length  # center=True frame count
    bucket = max(1 << 14, 1 << (n_true - 1).bit_length())
    y = np.asarray(y, np.float32)
    if bucket != n_true:
        y = np.pad(y, (0, bucket - n_true))
    in_k1 = range_error(win_length, win_length, n_mels) is None
    mel_fn = log_mel_spectrogram_fused if in_k1 else log_mel_spectrogram
    mel = mel_fn(torch.from_numpy(y).to(dev), sr=sr, n_fft=win_length,
                 hop_length=hop_length, win_length=win_length, n_mels=n_mels)
    mel = mel[:, :n_frames_true].cpu().numpy().astype(np.float32, copy=False)
    if target_frames is not None:
        mel = pad_or_truncate_frames(mel, target_frames)
    return mel


def preprocess_audio(
    path: Path,
    sr: int = 16000,
    n_mels: int = 80,
    hop_length: int = 160,
    win_length: int = 400,
    target_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Load mono PCM at ``sr`` from any container and compute its log-mel
    spectrogram -> ``(n_mels, T)`` float32. Raises ``ValueError`` when the
    container holds no audio."""
    y = ingest.read_audio(path, sr=sr)
    if y.size == 0:
        raise ValueError(f"Empty audio signal for {path}")
    return preprocess_audio_pcm(
        y, sr=sr, n_mels=n_mels, hop_length=hop_length,
        win_length=win_length, target_frames=target_frames, device=device,
    )


def detect_voice_activity(
    path: Path, sr: int = 16000
) -> Tuple[np.ndarray, float]:
    """(per-mel-frame speech mask at 100 Hz, duration in seconds); a file
    whose audio cannot be read gives an all-speech mask."""
    try:
        y = ingest.read_audio(path, sr=sr)
    except Exception as e:  # the reference's all-speech fallback
        logger.warning("VAD audio load failed: %s — all-speech mask", e)
        return np.ones(1, dtype=bool), 0.0
    return detect_voice_activity_pcm(y, sr=sr)
