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


def test_kernel_tables_rebuild_the_bases():
    """The kernel reads basis entry (n, k) as window[n] * twiddle[n*k % 400];
    that rebuilds the twin's (400, 201) bases to 1e-7, and each band's
    support covers every nonzero filterbank weight."""
    wc, ws, fbt = k1._host_tables()
    win, cos, sin, fbt_k, bands = k1._host_kernel_tables()
    idx = (np.arange(400)[:, None] * np.arange(201)[None, :]) % 400
    err_c = np.abs(win[:, None] * cos[idx] - wc).max()
    err_s = np.abs(win[:, None] * sin[idx] - ws).max()
    print(f"max |delta| rebuilt bases: cos {err_c:.3g}, sin {err_s:.3g}")
    assert err_c <= 1e-7 and err_s <= 1e-7
    np.testing.assert_array_equal(fbt_k, fbt)
    for m in range(80):
        nz = np.flatnonzero(fbt[:, m])
        lo, hi = bands[m]
        assert nz.size == 0 or (lo == nz[0] and hi == nz[-1])


def test_quiet_band_floor_is_shared_by_every_fp32_chain():
    """A loud 220 Hz tone over faint noise puts mel bands ~75-80 dB below
    the clip peak. There the twin and the JAX package's default rFFT path
    each sit ~1.5e-3 dB from a float64 DFT of the same chain: a floor of
    fp32, not of the port (ROADMAP.md). Both stay within 2.5e-3 dB."""
    n = 41000
    t = np.arange(n) / 16000.0
    y = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 3e-4 * np.random.RandomState(7).randn(n)).astype(np.float32)
    yp = np.pad(y.astype(np.float64), (200, 200))
    frames = np.lib.stride_tricks.sliding_window_view(yp, 400)[::160]
    power = np.abs(np.fft.rfft(
        frames[: k1.n_frames_for(n)]
        * port_mel.hann_window(400).astype(np.float64), axis=-1)) ** 2
    ref = 10 * np.log10(np.maximum(
        power @ port_mel.mel_filterbank(16000, 400, 80).T.astype(np.float64),
        1e-10)).T
    ref = np.maximum(ref - ref.max(), -80.0)
    twin = k1.log_mel_spectrogram_fused(torch.from_numpy(y)).numpy()
    jax_default = np.asarray(jax_log_mel(jnp.asarray(y)))
    d_twin = np.abs(twin - ref).max()
    d_jax = np.abs(jax_default - ref).max()
    print(f"quiet bands vs float64: twin {d_twin:.3g} dB, "
          f"JAX default {d_jax:.3g} dB")
    assert d_twin <= 2.5e-3 and d_jax <= 2.5e-3


@pytest.mark.parametrize("n,f", [(65536, 3), (262144, 8), (1 << 20, 8)])
def test_frames_per_block_reaches_every_sm(n, f):
    """On 132 SMs: 3 frames per block at R1's 65536-sample bucket (137
    blocks), 8 where 8 still gives every SM a block."""
    t = k1.n_frames_for(n)
    assert k1.frames_per_block(1, t, 132) == f
    assert -(-t // f) >= 132


# ── every parameter set the Pallas kernel takes ──────────────────────────
#
# (sr, n_fft, hop, n_mels) and the other arguments, as the JAX package's
# log_mel_spectrogram_pallas takes them: 22.05 kHz at 128 mels and the
# widest n_fft whose bins fit its 256 lanes, 8 kHz, uncentred frames, a
# filterbank with 13 empty bands, an odd n_fft and no floor.
PARAM_SETS = {
    "defaults": {},
    "22050_510_128_128": dict(sr=22050, n_fft=510, hop_length=128,
                              n_mels=128),
    "8000_256_80_40": dict(sr=8000, n_fft=256, hop_length=80, n_mels=40),
    "16000_320_160_64_uncentred": dict(sr=16000, n_fft=320, hop_length=160,
                                       n_mels=64, center=False),
    "16000_256_160_128_empty_bands": dict(sr=16000, n_fft=256,
                                          hop_length=160, n_mels=128),
    "odd_n_fft_401": dict(n_fft=401),
    "no_floor": dict(top_db=None),
}


def _full(params):
    """The set with every size named, win_length = n_fft as the kernel
    takes it."""
    full = {"sr": 16000, "n_fft": 400, "hop_length": 160, "n_mels": 80,
            **params}
    return {**full, "win_length": full["n_fft"]}


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_kernel_twin_matches_pallas_and_xla_at_every_set(name):
    """The wrapper (the twin on the CPU) against the Pallas kernel in
    interpret mode and the JAX package's XLA chain, < 1e-3 dB."""
    params = _full(PARAM_SETS[name])
    y = _speechish(12000, 5)
    before = k1.launches
    got = k1.log_mel_spectrogram_fused(torch.from_numpy(y), **params).numpy()
    pallas = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(y),
                                                   interpret=True, **params))
    xla = np.asarray(jax_log_mel(jnp.asarray(y), **params))
    assert got.shape == pallas.shape == xla.shape
    assert got.shape[0] == params["n_mels"]
    d_pallas, d_xla = np.abs(got - pallas).max(), np.abs(got - xla).max()
    print(f"max |delta| K1 twin {name}: vs pallas {d_pallas:.3g} dB, "
          f"vs XLA {d_xla:.3g} dB")
    assert d_pallas < TOL_DB and d_xla < TOL_DB
    assert k1.launches == before


PREPROCESS_SETS = sorted(k for k, v in PARAM_SETS.items()
                         if not {"center", "top_db"} & set(v))


@pytest.mark.parametrize("name", PREPROCESS_SETS)
def test_preprocess_audio_pcm_matches_jax_at_every_set(name):
    """The JAX signature (sr, n_mels, hop_length, win_length; n_fft =
    win_length), its bucket and its frame slice, through K1's route."""
    p = _full(PARAM_SETS[name])
    kw = {k: p[k] for k in ("sr", "n_mels", "hop_length", "win_length")}
    y = _speechish(23456, 6)
    got = preprocess_audio_pcm(y, target_frames=150, device="cpu", **kw)
    want = jax_preprocess(y, target_frames=150, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    print(f"max |delta| preprocess {name}: {np.abs(got - want).max():.3g} dB")
    assert np.abs(got - want).max() < TOL_DB


@pytest.mark.parametrize("n_fft,win_length,n_mels,limit", [
    (512, 512, 80, "n_fft"), (400, 400, 160, "n_mels"),
    (400, 320, 80, "win_length")])
def test_out_of_range_sets_raise_in_both_kernels(n_fft, win_length, n_mels,
                                                 limit):
    """n_fft past 511 (257 bins), more than 128 mels, win_length != n_fft:
    the Pallas kernel raises, and the port's wrapper raises ValueError
    naming the limit before any launch."""
    y = _speechish(16384, 7)
    kw = dict(n_fft=n_fft, win_length=win_length, n_mels=n_mels)
    with pytest.raises((ValueError, AssertionError)):
        log_mel_spectrogram_pallas(jnp.asarray(y), interpret=True, **kw)
    with pytest.raises(ValueError, match=limit):
        k1.log_mel_spectrogram_fused(torch.from_numpy(y), **kw)
    with pytest.raises(ValueError, match=limit):
        k1.log_mel_db(torch.from_numpy(y)[None], **kw)


def _failing_k1(*args, **kwargs):
    raise RuntimeError("log_mel kernel launch failed: cudaError 700")


@pytest.mark.parametrize("win_length,n_mels", [(1024, 80), (400, 160)])
def test_preprocess_outside_k1_takes_the_chain(win_length, n_mels,
                                                monkeypatch):
    """Outside K1's range the preprocessing takes ops/mel.py's chain,
    chosen from the parameters alone (a raising K1 is never called), and
    matches the JAX package's default chain."""
    from lipsync_tpu_torch.preprocessing import audio as audio_mod

    monkeypatch.setattr(audio_mod, "log_mel_spectrogram_fused", _failing_k1)
    y = _speechish(20000, 8)
    got = preprocess_audio_pcm(y, win_length=win_length, n_mels=n_mels,
                               device="cpu")
    want = jax_preprocess(y, win_length=win_length, n_mels=n_mels)
    assert got.shape == want.shape == (n_mels, 1 + 20000 // 160)
    print(f"max |delta| preprocess chain win={win_length} mels={n_mels}: "
          f"{np.abs(got - want).max():.3g} dB")
    assert np.abs(got - want).max() < TOL_DB


def test_a_failing_k1_inside_its_range_raises(monkeypatch):
    """Inside the range a K1 failure ends the call; it never falls over to
    the chain."""
    from lipsync_tpu_torch.preprocessing import audio as audio_mod

    monkeypatch.setattr(audio_mod, "log_mel_spectrogram_fused", _failing_k1)
    with pytest.raises(RuntimeError, match="log_mel kernel launch failed"):
        preprocess_audio_pcm(_speechish(16000, 9), win_length=511,
                             n_mels=128, device="cpu")


@pytest.mark.parametrize("name", sorted(set(PARAM_SETS) - {"no_floor"}))
def test_kernel_tables_hold_at_every_set(name):
    """At each set the kernel's twiddles rebuild the twin's bases to 1e-7
    and each band's support covers its nonzero weights; an empty band
    (none at most sets, 13 at 16 kHz, n_fft 256, 128 mels) has support
    (0, -1) and gives 10 log10(1e-10) dB, as the Pallas kernel does."""
    p = _full(PARAM_SETS[name])
    sr, n_fft, n_mels = p["sr"], p["n_fft"], p["n_mels"]
    wc, ws, fbt = k1._host_tables(sr, n_fft, n_mels)
    win, cos, sin, fbt_k, bands = k1._host_kernel_tables(sr, n_fft, n_mels)
    n_bins = n_fft // 2 + 1
    assert wc.shape == (n_fft, n_bins) and fbt.shape == (n_bins, n_mels)
    idx = (np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :]) % n_fft
    assert np.abs(win[:, None] * cos[idx] - wc).max() <= 1e-7
    assert np.abs(win[:, None] * sin[idx] - ws).max() <= 1e-7
    np.testing.assert_array_equal(fbt_k, fbt)
    empty = [m for m in range(n_mels) if not fbt[:, m].any()]
    for m in range(n_mels):
        nz = np.flatnonzero(fbt[:, m])
        want = (0, -1) if nz.size == 0 else (nz[0], nz[-1])
        assert tuple(bands[m]) == want
    assert len(empty) == (13 if name.endswith("empty_bands") else 0)
    if empty:
        y = torch.from_numpy(_speechish(8000, 10))[None]
        db = k1.log_mel_db(y, sr=sr, n_fft=n_fft, win_length=n_fft,
                           hop_length=p["hop_length"], n_mels=n_mels)
        np.testing.assert_allclose(db[0, empty].numpy(), -100.0, atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("n,n_fft,hop,center", [
    (16000, 400, 160, True), (16000, 401, 160, True),
    (12000, 320, 160, False), (12000, 510, 128, True)])
def test_frame_count_follows_the_jax_framing(n, n_fft, hop, center):
    """1 + (n + 2 pad - n_fft) // hop, pad = n_fft // 2 when centred: the
    twin's output length and the JAX chain's."""
    y = _speechish(n, 11)
    t = k1.n_frames_for(n, n_fft, hop, center)
    want = jax_log_mel(jnp.asarray(y), n_fft=n_fft, win_length=n_fft,
                       hop_length=hop, center=center).shape[1]
    got = k1.log_mel_db(torch.from_numpy(y)[None], n_fft=n_fft,
                        win_length=n_fft, hop_length=hop,
                        center=center).shape[2]
    assert t == want == got
