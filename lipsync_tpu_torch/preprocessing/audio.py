"""Audio preprocessing: ingest -> log-mel dB on the device, and the VAD.

Counterpart of ``preprocessing/audio.py`` in the JAX package. On CUDA the
spectrogram always goes through the fused kernel K1 (``ops/kernels/mel.py``);
on the CPU its wrapper runs the plain twin. The voice-activity mask is
numpy on the host (``ops/vad.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.ops.kernels.mel import HOP, log_mel_spectrogram_fused
from lipsync_tpu_torch.ops.mel import pad_or_truncate_frames
from lipsync_tpu_torch.ops.vad import detect_voice_activity_pcm
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def preprocess_audio_pcm(
    y: np.ndarray,
    target_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """16 kHz mono PCM -> ``(80, T)`` float32 log-mel dB, ``T = 1 +
    len(y) // 160`` (n_fft = win = 400, hop 160: the JAX package's defaults,
    the only parameters K1 is built for).

    The PCM length is bucketed to the next power of two (at least 16384),
    as in the JAX package. The zero tail is inert: its frames are sliced off,
    the last true frames see zeros exactly as centre padding supplies them,
    and the dB reference can only come from the true frames.
    """
    if y.size == 0:
        raise ValueError("Empty audio signal")
    dev = get_device(device)
    n_true = len(y)
    n_frames_true = 1 + n_true // HOP
    bucket = max(1 << 14, 1 << (n_true - 1).bit_length())
    y = np.asarray(y, np.float32)
    if bucket != n_true:
        y = np.pad(y, (0, bucket - n_true))
    mel = log_mel_spectrogram_fused(torch.from_numpy(y).to(dev))
    mel = mel[:, :n_frames_true].cpu().numpy()
    if target_frames is not None:
        mel = pad_or_truncate_frames(mel, target_frames)
    return mel


def preprocess_audio(
    path: Path,
    target_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Load 16 kHz mono PCM from any container and compute its log-mel
    spectrogram -> ``(80, T)`` float32. Raises ``ValueError`` when the
    container holds no audio."""
    y = ingest.read_audio(path, sr=16000)
    if y.size == 0:
        raise ValueError(f"Empty audio signal for {path}")
    return preprocess_audio_pcm(y, target_frames=target_frames, device=device)


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
