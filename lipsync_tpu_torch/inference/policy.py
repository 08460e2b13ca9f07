"""Window alignment policy (numpy, host side).

Counterpart of ``inference/policy.py::align_audio_chunk`` in the JAX
package; the rest of that module (aggregation and the guard cascade) is a
later slice's work. Native layouts: mel ``(F, T)``.
"""

from __future__ import annotations

import numpy as np


def align_audio_chunk(
    audio_full: np.ndarray,
    v_start: int,
    total_v_frames: int,
    chunk_a_size: int = 128,
    chunk_v_size: int = 32,
    reference_slice: bool = False,
) -> np.ndarray:
    """Mel ``(F, T_full)`` window aligned to video frames
    ``[v_start, v_start + chunk_v_size)`` -> ``(F, chunk_a_size)``.

    Default: the training alignment contract. Slice the mel span that covers
    the visual window exactly (``chunk_v_size * T_a / T_v`` columns) and
    resample it to ``chunk_a_size`` with an integer linspace.

    ``reference_slice=True``: the reference's serving alignment. Slice
    ``chunk_a_size`` raw columns starting at the aligned position, padding
    by repeating the last column.
    """
    total_a = audio_full.shape[1]
    a_ratio = total_a / max(1, total_v_frames)
    if reference_slice:
        a_start = int(round(v_start * a_ratio))
        a_end = a_start + chunk_a_size
        if a_end > total_a:
            a_end = total_a
            a_start = max(0, a_end - chunk_a_size)
        chunk = audio_full[:, a_start:a_end]
        if chunk.shape[1] < chunk_a_size:
            pad = np.repeat(chunk[:, -1:], chunk_a_size - chunk.shape[1],
                            axis=1)
            chunk = np.concatenate([chunk, pad], axis=1)
        return chunk

    mel_len = max(1, int(round(chunk_v_size * a_ratio)))
    a_start = int(round(v_start * a_ratio))
    a_start = max(0, min(a_start, max(0, total_a - 1)))
    a_end = min(total_a, a_start + mel_len)
    chunk = audio_full[:, a_start:a_end]
    if chunk.shape[1] == 0:
        chunk = audio_full[:, -1:]
    if chunk.shape[1] < mel_len:
        pad = np.repeat(chunk[:, -1:], mel_len - chunk.shape[1], axis=1)
        chunk = np.concatenate([chunk, pad], axis=1)
    if chunk.shape[1] != chunk_a_size:
        idx = np.linspace(0, chunk.shape[1] - 1, chunk_a_size).astype(np.int64)
        chunk = chunk[:, idx]
    return chunk
