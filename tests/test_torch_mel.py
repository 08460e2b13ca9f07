"""The port's log-mel against the JAX package (CPU).

Tolerance < 1e-3 dB, the JAX package's own bound for its fused kernel.
On the CPU the K1 wrapper runs its plain twin; the CUDA kernel is held
against the same twin on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lipsync_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from lipsync_tpu.ops.pallas.mel_kernel import log_mel_spectrogram_pallas
from lipsync_tpu.preprocessing.audio import (
    preprocess_audio_pcm as jax_preprocess,
)
from lipsync_tpu_torch.ops import mel as port_mel
from lipsync_tpu_torch.ops.kernels import mel as k1
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm

torch.set_num_threads(1)
TOL_DB = 1e-3


def _speechish(n, seed):
    """A 220 Hz tone over white noise: ~50 dB of range between the clip peak
    and its quietest band. (Bands ~75 dB down reach ~1.2e-3 dB of fp32 DFT
    rounding in the twin; ROADMAP.md section C.)"""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    tone = 0.2 * np.sin(2 * np.pi * 220 * t)
    return (tone + 0.1 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("n", [16000, 23456])
def test_log_mel_spectrogram_matches_jax(n):
    y = _speechish(n, n)
    got = port_mel.log_mel_spectrogram(torch.from_numpy(y)).numpy()
    want = np.asarray(jax_log_mel(jnp.asarray(y)))
    assert got.shape == want.shape == (80, 1 + n // 160)
    print(f"max |delta| log_mel n={n}: {np.abs(got - want).max():.3g} dB")
    assert np.abs(got - want).max() < TOL_DB


@pytest.mark.parametrize("n,target", [(23456, None), (41000, 128)])
def test_preprocess_audio_pcm_matches_jax(n, target):
    """A length that is not a power of two goes through the PCM bucket and
    the slice to 1 + n // hop frames on both sides."""
    y = _speechish(n, 1)
    got = preprocess_audio_pcm(y, target_frames=target, device="cpu")
    want = jax_preprocess(y, target_frames=target)
    assert got.dtype == np.float32
    assert got.shape == want.shape
    print(f"max |delta| preprocess n={n}: {np.abs(got - want).max():.3g} dB")
    assert np.abs(got - want).max() < TOL_DB


def test_kernel_twin_matches_pallas_interpret():
    y = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.2
    before = k1.launches
    got = k1.log_mel_spectrogram_fused(torch.from_numpy(y)).numpy()
    want = np.asarray(
        log_mel_spectrogram_pallas(jnp.asarray(y), interpret=True)
    )
    assert got.shape == want.shape
    print(f"max |delta| K1 twin vs pallas: {np.abs(got - want).max():.3g} dB")
    assert np.abs(got - want).max() < TOL_DB
    assert k1.launches == before  # the CPU twin is no launch


def test_twin_batches_clips_independently():
    ys = np.stack([_speechish(16384, s) for s in (2, 3)])
    batched = k1.log_mel_spectrogram_fused(torch.from_numpy(ys)).numpy()
    for i in range(2):
        one = k1.log_mel_spectrogram_fused(torch.from_numpy(ys[i])).numpy()
        np.testing.assert_allclose(batched[i], one, atol=1e-4, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        k1.log_mel_db(torch.zeros(1, 16384, dtype=torch.float64))
    with pytest.raises(ValueError):
        k1.log_mel_db(torch.zeros(16384))
    with pytest.raises(ValueError):
        k1.log_mel_spectrogram_fused(torch.zeros(2, 2, 16384))
    with pytest.raises(ValueError):
        preprocess_audio_pcm(np.zeros(0, np.float32), device="cpu")
