"""Energy-based voice activity detection (numpy, host side).

Counterpart of ``ops/vad.py`` in the JAX package: per-mel-frame energies
with an adaptive threshold (the smaller of the 20th percentile and 5% of
the median, clamped by 5% of the mean above-median energy) and a 3-frame
"any" smoothing. Mask frames align with mel frames (hop 160 at 16 kHz).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def frame_energies(
    y: np.ndarray, hop_length: int = 160, frame_length: int = 400
) -> np.ndarray:
    """Mean squared amplitude per frame."""
    n = len(y)
    n_frames = int(np.ceil(n / hop_length))
    energies = np.empty(n_frames, np.float64)
    for i in range(n_frames):
        start = i * hop_length
        end = min(start + frame_length, n)
        seg = y[start:end]
        energies[i] = np.mean(seg.astype(np.float64) ** 2) if len(seg) else 0.0
    return energies


def detect_voice_activity_pcm(
    y: np.ndarray,
    sr: int = 16000,
    hop_length: int = 160,
    frame_length: int = 400,
) -> Tuple[np.ndarray, float]:
    """(mask, duration_sec) from mono PCM. Empty input -> all-True mask."""
    if y.size == 0:
        return np.ones(1, dtype=bool), 0.0
    duration_sec = len(y) / sr
    energies = frame_energies(y, hop_length, frame_length)
    if len(energies) == 0:
        return np.ones(1, dtype=bool), duration_sec

    median = np.median(energies)
    p20 = np.percentile(energies, 20)
    threshold = max(1e-8, min(p20, median * 0.05))

    speech_frames = energies[energies > median]
    if speech_frames.size:
        speech_energy = float(np.mean(speech_frames))
        threshold = min(threshold, max(1e-8, speech_energy * 0.05))

    mask = energies >= threshold
    padded = np.concatenate([[False], mask, [False]])
    smoothed = padded[:-2] | padded[1:-1] | padded[2:]
    return smoothed, duration_sec
