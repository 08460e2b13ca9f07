"""The port's kernels on a CUDA card against their plain twins: the build
of every ``csrc/*.cu`` (no spill, K2 and K5 at two blocks per SM or more,
no ``wgmma`` that ptxas serialised), K1 (log-mel) at every PCM bucket and
parameter set the port runs and the routes around it, K2 (the HF stem) at
every batch the main path, the trainer, the service and the shards give
it, K3 and K4 (the int8 convolution and quantize) bit for bit at every
int8 encoder convolution and at odd shapes, and the layer forms of the JAX
package's blocks on the card against the CPU.

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_*_card.py --noconftest -m card
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.models import (
    LipSyncModel,
    ModelConfig,
    seeded_state_dict,
)
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.ops.kernels import av_stem as k5
from lipsync_tpu_torch.ops.kernels import build
from lipsync_tpu_torch.ops.kernels import hf_stem as k2
from lipsync_tpu_torch.ops.kernels import int8_conv as k3
from lipsync_tpu_torch.ops.kernels import int8_quant as k4
from lipsync_tpu_torch.ops.kernels import mel as k1
from lipsync_tpu_torch.preprocessing import audio as audio_mod
from lipsync_tpu_torch.tools.diagnose_int8 import CONV_SHAPES
from lipsync_tpu_torch.utils import synthetic
from torch_card import card, tf32_off  # noqa: F401
from torch_card import (
    K1_SAMPLES,
    K2_SHAPES,
    SEED,
    bits,
    mel_float64,
    parent_int8_conv,
    plain_int8,
    same_float,
)

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("tf32_off")]
DTYPES = (torch.float32, torch.bfloat16)


def test_every_kernel_builds_without_spills(card, tmp_path, monkeypatch):
    """Each ``csrc/*.cu`` compiles (one nvcc each, into a directory of the
    test's own, so that ptxas reports on every kernel); ptxas spills no
    register of any kernel and serialises no ``wgmma`` (K3); K2 holds two
    blocks per SM or more in both dtypes, and so does K5 in both staging
    variants of both activations (PReLU, Swish)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    logs = build.build()
    assert sorted(logs) == sorted(build.KERNELS)
    ptxas = "\n".join(logs.values())
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", ptxas)]
    assert spills and not any(spills), ptxas
    assert not [ln for ln in ptxas.splitlines()
                if "wgmma" in ln and "serializ" in ln]
    assert min(k2.blocks_per_sm(torch.float32),
               k2.blocks_per_sm(torch.bfloat16)) >= 2
    assert min(k5.blocks_per_sm(aligned, swish) for aligned in (True, False)
               for swish in (False, True)) >= 2


# ── K1 ───────────────────────────────────────────────────────────────────

# K1's parameter sets beyond the defaults, as the JAX package's Pallas
# kernel takes them (tests/test_torch_mel.py holds the twin against it at
# each): 22.05 kHz at 128 mels and the widest n_fft whose bins fit its 256
# lanes, 8 kHz, uncentred frames, a filterbank with 13 empty bands, an odd
# n_fft and no floor.
K1_PARAM_SETS = {
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
# Outside K1's range the audio preprocessing takes ops/mel.py's chain.
K1_OUTSIDE = {"win_length_1024": dict(win_length=1024),
              "n_mels_160": dict(n_mels=160)}


def k1_params(extra: dict) -> dict:
    """K1's keyword arguments for a set of ``K1_PARAM_SETS`` (``top_db`` is
    the wrapper's floor, not the kernel's): every size named, win_length =
    n_fft."""
    full = {"sr": 16000, "n_fft": 400, "hop_length": 160, "n_mels": 80,
            "center": True, **extra}
    full.pop("top_db", None)
    return {**full, "win_length": full["n_fft"]}


@pytest.mark.parametrize("n", K1_SAMPLES)
def test_k1_matches_its_twin(card, n):
    """At the defaults, K1's dB relative to the clip's peak within 1e-3 of
    its twin's on a tone over noise."""
    y = torch.from_numpy(synthetic.pcm(np.random.default_rng(n), n)).to(
        card)[None]
    got = k1.finish_db(k1.log_mel_db(y))
    want = k1.finish_db(k1.log_mel_db_plain(y))
    assert got.shape == (1, 80, k1.n_frames_for(n))
    assert float((got - want).abs().max()) < 1e-3


def test_k1_at_quiet_bands(card):
    """A loud tone over faint noise puts mel bands 75-80 dB below the
    clip's peak, where every fp32 DFT chain rounds to ~1.5e-3 dB: against
    a float64 chain K1 rounds no worse than its twin (+ 2e-4 dB) and stays
    within the 2.5e-3 dB fp32 floor that the CPU tests pin."""
    n = 41000
    rng = np.random.default_rng(SEED)
    y = (0.5 * np.sin(2 * np.pi * 220 * np.arange(n) / 16000.0)
         + 3e-4 * rng.standard_normal(n)).astype(np.float32)
    y2 = torch.from_numpy(y).to(card)[None]
    ref = mel_float64(y)
    got = np.abs(k1.finish_db(k1.log_mel_db(y2))[0].cpu().numpy() - ref)
    twin = np.abs(k1.finish_db(k1.log_mel_db_plain(y2))[0].cpu().numpy()
                  - ref)
    assert got.max() <= twin.max() + 2e-4
    assert got.max() <= 2.5e-3


@pytest.mark.parametrize("name", list(K1_PARAM_SETS))
def test_k1_at_every_parameter_set(card, name):
    """At 65536 samples: on white noise (the JAX package's own signal for
    its < 1e-3 dB bound) within 1e-3 dB of the twin, an empty band at 10
    log10(1e-10) dB; on a tone over noise within the 2.5e-3 dB fp32 floor
    of a float64 chain of the set; at the defaults the run-time-sized
    kernel within 1e-3 dB of the fixed one."""
    extra = K1_PARAM_SETS[name]
    p, top_db = k1_params(extra), extra.get("top_db", 80.0)
    n = 65536
    rng = np.random.default_rng(SEED)
    y = torch.from_numpy(
        (0.2 * rng.standard_normal(n)).astype(np.float32)).to(card)[None]
    t = k1.n_frames_for(n, p["n_fft"], p["hop_length"], p["center"])
    got = k1.finish_db(k1.log_mel_db(y, **p), top_db)
    want = k1.finish_db(k1.log_mel_db_plain(y, **p), top_db)
    assert got.shape == (1, p["n_mels"], t)
    assert float((got - want).abs().max()) < 1e-3

    yq = synthetic.pcm(rng, n)
    got_q = k1.finish_db(k1.log_mel_db(torch.from_numpy(yq).to(card)[None],
                                       **p))[0].cpu().numpy()
    assert np.abs(got_q - mel_float64(yq, **p)).max() <= 2.5e-3

    bands = k1.kernel_tables(card, p["sr"], p["n_fft"], p["n_mels"])[4].cpu()
    empty = [m for m in range(p["n_mels"]) if bands[m, 1] < bands[m, 0]]
    if empty:
        absolute = k1.log_mel_db(y, **p)[0, empty]
        assert float((absolute + 100.0).abs().max()) <= 1e-4
    if name == "defaults":
        general = k1._launch(y, p, t, general=True)
        assert float((general - k1.log_mel_db(y, **p)).abs().max()) < 1e-3


@pytest.mark.parametrize("name", list(K1_OUTSIDE))
def test_outside_k1s_range_the_chain_runs(card, name):
    """Outside K1's range the audio preprocessing takes ``ops/mel.py``'s
    chain (no K1 launch; finite, of the right shape), and K1's wrapper
    raises before any launch."""
    kw = K1_OUTSIDE[name]
    pcm = synthetic.pcm(np.random.default_rng(SEED), 41000)
    before = k1.launches
    mel = audio_mod.preprocess_audio_pcm(pcm, device=card, **kw)
    assert mel.shape == (kw.get("n_mels", 80), 1 + len(pcm) // 160)
    assert np.isfinite(mel).all()
    y = torch.from_numpy(pcm).to(card)[None]
    with pytest.raises(ValueError):
        k1.log_mel_spectrogram_fused(
            y, n_fft=kw.get("win_length", 400),
            win_length=kw.get("win_length", 400),
            n_mels=kw.get("n_mels", 80))
    assert k1.launches == before


class _FailingMelLibrary:
    """K1's library with a launch that fails as a refused launch does."""

    @staticmethod
    def lipsync_log_mel(*args):
        return 700  # cudaErrorIllegalAddress


def test_a_failing_k1_ends_the_preprocessing(card, monkeypatch):
    """Inside K1's range a failed launch raises out of the audio
    preprocessing; it never falls back to the chain."""
    monkeypatch.setattr(k1, "_library", _FailingMelLibrary)
    pcm = synthetic.pcm(np.random.default_rng(SEED), 41000)
    with pytest.raises(RuntimeError, match="log_mel kernel launch failed"):
        audio_mod.preprocess_audio_pcm(pcm, win_length=511, n_mels=128,
                                       device=card)


# ── K2 ───────────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def stem_args(card):
    """K2's operands: a Laplacian's channel mix plus noise, conv1 and its
    BatchNorm, the two BatchNorms after it."""
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(card)

    lap = torch.zeros(3, 3, 3, 3)
    for i in range(3):
        lap[i, i] = torch.tensor([[0., 1, 0], [1, -4, 1], [0, 1, 0]])
    return ((lap.to(card) + randn(3, 3, 3, 3, scale=0.1)),
            randn(32, 3, 3, 3, 3, scale=0.2), randn(32, scale=0.1),
            (torch.rand(32, generator=gen) + 0.5).to(card),
            randn(32, scale=0.1), randn(32, scale=0.1),
            (torch.rand(32, generator=gen) + 0.5).to(card))


@pytest.mark.parametrize("shape", K2_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_matches_its_twin(card, stem_args, shape):
    """fp32 within 2e-5 of the twin; bf16 within |d| <= 8e-3 |fp32| +
    1e-5 of the twin's fp32 result on the same (bf16) input. Each dtype's
    outputs are freed before the next (the batch of 1024 has 9.7 GB of
    fp32 output)."""
    gen = torch.Generator().manual_seed(sum(shape))
    video = torch.rand(*shape, generator=gen).to(card)
    got = k2.hf_stem(video, *stem_args)
    err32 = float((got - k2.hf_stem_plain(video, *stem_args)).abs().max())
    del got
    v16 = video.to(torch.bfloat16)
    del video
    want16 = k2.hf_stem_plain(v16.float(), *stem_args)
    err16 = (k2.hf_stem(v16, *stem_args).float() - want16).abs_()
    used16 = float((err16 / (8e-3 * want16.abs() + 1e-5)).max())
    del err16, want16
    torch.cuda.empty_cache()
    assert err32 <= 2e-5
    assert used16 <= 1.0


# ── K3 and K4 ────────────────────────────────────────────────────────────

# Odd shapes with partial tiles, ((x), (w), stride, padding), channels last:
# five on the wgmma loop, then five on the halo loop: partial tiles at
# every border (the last rows of each frame, of each batch item), C_in 2, 5
# and 8, a row of output cut into tiles, C_out past one block of 64
# channels, a stride-1 stem.
ODD = [((3, 5, 13, 11, 32), (24, 3, 3, 3, 32), (1, 2, 2), (1, 1, 1)),
       ((2, 3, 9, 10, 3), (16, 2, 5, 3, 3), (1, 2, 1), (0, 2, 1)),
       ((3, 11, 9, 1), (8, 7, 7, 1), (2, 2), (3, 3)),
       ((2, 7, 5, 96), (16, 3, 3, 96), (2, 1), (1, 1)),
       ((2, 3, 6, 6, 64), (136, 1, 1, 1, 64), (1, 2, 2), (0, 0, 0)),
       ((3, 5, 21, 23, 3), (16, 3, 7, 7, 3), (1, 2, 2), (1, 3, 3)),
       ((2, 3, 17, 150, 2), (24, 2, 5, 3, 2), (1, 1, 2), (1, 2, 1)),
       ((2, 9, 13, 8), (40, 3, 3, 8), (1, 2), (1, 1)),
       ((2, 4, 15, 17, 3), (8, 3, 7, 7, 3), (1, 1, 1), (1, 3, 3)),
       ((1, 3, 9, 300, 5), (136, 1, 3, 3, 5), (1, 1, 1), (0, 1, 1))]
# ``tools/diagnose_int8.py``'s own list of encoder geometries (one of them
# not the model's), at its batch of 16.
DIAGNOSE = {name: ((16, *x), (co, *ks, ci), st, tuple(d // 2 for d in ks))
            for name, x, ks, ci, co, st in CONV_SHAPES}
# The widths that K3 refuses as they are: layer4 at B = 16 with C_out 100,
# C_in 200 and C_in 320.
REFUSED = {
    "cout_100": ((16, 32, 6, 6, 256), (100, 3, 3, 3, 256), (1, 2, 2),
                 (1, 1, 1)),
    "cin_200": ((16, 32, 3, 3, 200), (200, 3, 3, 3, 200), (1, 1, 1),
                (1, 1, 1)),
    "cin_320": ((16, 32, 3, 3, 320), (320, 3, 3, 3, 320), (1, 1, 1),
                (1, 1, 1)),
}
# The JAX package's (lo, hi) padding pairs, unequal.
UNEQUAL_PAD = ((0, 1), (2, 1), (1, 0))
UNEQUAL = {
    "unequal_3d": ((16, 8, 12, 12, 64), (64, 3, 3, 3, 64), (1, 2, 2),
                   UNEQUAL_PAD),
    "unequal_stem": ((4, 8, 21, 19, 3), (16, 3, 7, 7, 3), (1, 2, 2),
                     ((1, 1), (3, 2), (2, 3))),
    "unequal_2d": ((16, 17, 33, 32), (32, 3, 3, 32), (1, 2),
                   ((2, 0), (0, 1))),
}


@pytest.fixture(scope="module")
def geometries(card):
    """Every int8 encoder convolution of ``ModelConfig()``, ``(x shape, w
    shape, stride, padding)`` at one window, found by one int8 forward."""
    cfg = dataclasses.replace(ModelConfig(), conv_lowering="int8")
    found = []
    real = layers_mod.int8_conv_dequant

    def discover(x, w, scale, bias, out_dtype, stride, padding):
        key = (tuple(x.shape), tuple(w.shape), tuple(map(int, stride)),
               tuple(map(int, padding)))
        if key not in found:
            found.append(key)
        return real(x, w, scale, bias, out_dtype, stride, padding)

    model = LipSyncModel(cfg).to(card).eval()
    layers_mod.int8_conv_dequant = discover
    try:
        with torch.inference_mode():
            model(torch.rand(1, cfg.video_frames, cfg.crop_size,
                             cfg.crop_size, 3, device=card),
                  torch.rand(1, cfg.mel_bins, cfg.audio_frames, 1,
                             device=card) * -80)
    finally:
        layers_mod.int8_conv_dequant = real
    assert {k3.main_loop(x, w) for x, w, _, _ in found} == {"wgmma", "halo"}
    return found


def gen_on(card, seed):
    return torch.Generator(device=card).manual_seed(seed)


def rand_int8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device=gen.device,
                         dtype=torch.int16).to(torch.int8)


def activations(gen, x_shape):
    """K4's input for a convolution over ``x_shape`` (channels last):
    channels-first shape, in both memory layouts."""
    cl = (torch.randn(*x_shape, generator=gen, device=gen.device)
          * 3.0).movedim(-1, 1)
    return {"channels_last": cl, "channels_first": cl.contiguous()}


def assert_k4(gen, x, frames=None, scale=None):
    """K4 against its twins on ``x``, bit for bit (a NaN scale matching a
    NaN): absmax (over ``frames`` if given), quantize at the twin's scale
    or ``scale``, and the single launch's int8 values, scale and K3's
    scale vector on a random ``w_scale``."""
    m = k4.absmax(x, frames)
    m_twin = k4.absmax_plain(x, frames)
    assert same_float(m, m_twin)
    if scale is None:
        scale = torch.clamp(m_twin * layers_mod._INV_127, min=1e-12)
    assert torch.equal(k4.quantize(x, scale), k4.quantize_plain(x, scale))
    w_scale = torch.rand(x.shape[1], generator=gen, device=gen.device)
    fused = k4.absmax_quantize(x, w_scale)
    twin = k4.absmax_quantize_plain(x, w_scale)
    assert torch.equal(fused[0], twin[0])
    assert same_float(fused[1], twin[1]) and same_float(fused[2], twin[2])


def assert_conv(gen, x_shape, w_shape, stride, padding, odd=False):
    """K3 and K4 against their twins at one convolution: K3's int32 entry
    equal, its dequantizing entry bit-equal writing fp32 and bf16 (with a
    bias on the ``odd`` shapes); K4 on the convolution's input as fp32 and
    bf16 in both memory layouts, and on the ``odd`` shapes also over a
    frame range, at exact half-way ties, clamped, and on inputs holding a
    NaN (scale NaN) and a -inf (scale +inf)."""
    dev = gen.device
    x, w = rand_int8(gen, x_shape), rand_int8(gen, w_shape)
    cout = w_shape[0]
    scale = torch.rand(cout, generator=gen, device=dev) * 1e-4 + 1e-6
    bias = (torch.randn(cout, generator=gen, device=dev) if odd else None)
    want = k3.int8_conv_plain(x, w, stride, padding)
    assert torch.equal(k3.int8_conv_int32(x, w, stride, padding), want)
    del want
    for dt in DTYPES:
        assert torch.equal(
            bits(k3.int8_conv_dequant(x, w, scale, bias, dt, stride,
                                      padding)),
            bits(k3.int8_conv_dequant_plain(x, w, scale, bias, dt, stride,
                                            padding)))
    del x, w
    for xf in activations(gen, x_shape).values():
        for dt in DTYPES:
            assert_k4(gen, xf.to(dt))
            if odd:
                assert_k4(gen, xf.to(dt), (1, xf.shape[2] - 1))
    if not odd:
        return
    ties = torch.randint(-127, 127, x_shape, generator=gen,
                         device=dev) + 0.5
    ties[(0,) * ties.dim()] = 127.0  # the single launch's scale: 1
    ties = ties.movedim(-1, 1)
    ones = torch.ones((), device=dev)
    for dt in DTYPES:
        assert_k4(gen, ties.to(dt), scale=ones)
        assert_k4(gen, (ties * 3).to(dt), scale=ones)
    for value in ("nan", "-inf"):
        odd_x = activations(gen, x_shape)["channels_last"]
        odd_x[(0,) * odd_x.dim()] = float(value)
        for dt in DTYPES:
            assert_k4(gen, odd_x.to(dt))


@pytest.mark.parametrize("batch", [1, 8, 16, 128])
def test_k3_k4_equal_their_twins_at_the_encoder(card, geometries, batch):
    """Every int8 encoder convolution of ``ModelConfig()`` at 1, 8 (the
    int8 evaluation batch), 16 and 128 windows, bit for bit."""
    gen = gen_on(card, SEED + batch)
    for x_shape, w_shape, stride, padding in geometries:
        assert_conv(gen, (batch, *x_shape[1:]), w_shape, stride, padding)
        torch.cuda.empty_cache()


@pytest.mark.parametrize("i", range(len(ODD)))
def test_k3_k4_equal_their_twins_at_odd_shapes(card, i):
    assert_conv(gen_on(card, SEED + i), *ODD[i], odd=True)


@pytest.mark.parametrize("name", list(DIAGNOSE))
def test_k3_k4_equal_their_twins_at_diagnose_geometries(card, name):
    assert_conv(gen_on(card, SEED), *DIAGNOSE[name])


def test_int8_conv_equals_the_parent_chain(card, geometries):
    """At 16 windows, every encoder convolution through
    ``layers.int8_conv`` (K4's single launch, then K3 dequantizing) bit for
    bit and stride for stride as the parent's torch chain around K3's int32
    entry, on fp32 and bf16 inputs."""
    gen = gen_on(card, SEED)
    for x_shape, w_shape, stride, padding in geometries:
        xf = activations(gen, (16, *x_shape[1:]))["channels_last"]
        wf = torch.randn(w_shape[0], w_shape[-1], *w_shape[1:-1],
                         generator=gen, device=card) * 0.05
        for dt in DTYPES:
            fused = layers_mod.int8_conv(xf.to(dt), wf, None, stride, padding)
            chain = parent_int8_conv(xf.to(dt), wf, None, stride, padding)
            assert torch.equal(bits(fused), bits(chain)), (x_shape, dt)
            assert fused.stride() == chain.stride()


def int8_conv_launches(x, wf, bias, stride, padding):
    """``layers.int8_conv`` and its launches of K3 and K4."""
    before = k3.launches, k4.launches
    out = layers_mod.int8_conv(x, wf, bias, stride, padding)
    torch.cuda.synchronize()
    return out, (k3.launches - before[0], k4.launches - before[1])


@pytest.mark.parametrize("name", list(REFUSED))
def test_int8_conv_at_widths_k3_refuses(card, monkeypatch, name):
    """``layers.int8_conv`` reshapes what K3 refuses as it is: bit-equal to
    the same call with the twins in the kernels' places, K3 launched, K4
    once."""
    x_shape, w_shape, stride, padding = REFUSED[name]
    gen = gen_on(card, SEED)
    xf = activations(gen, x_shape)["channels_last"]
    wf = torch.randn(w_shape[0], w_shape[-1], *w_shape[1:-1], generator=gen,
                     device=card) * 0.05
    for dt in DTYPES:
        bias = (torch.randn(w_shape[0], generator=gen, device=card)
                if dt == torch.bfloat16 else None)
        got, n = int8_conv_launches(xf.to(dt), wf, bias, stride, padding)
        assert n[0] >= 1 and n[1] == 1
        with monkeypatch.context() as m:
            plain_int8(m)
            want, n = int8_conv_launches(xf.to(dt), wf, bias, stride,
                                         padding)
        assert n == (0, 0)
        assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("name", list(UNEQUAL))
def test_int8_conv_at_unequal_padding(card, monkeypatch, name):
    """Unequal ``(lo, hi)`` padding pairs: K4 on the input, zeros padded
    into the int8 activation (a zero quantizes to 0), K3 with none;
    bit-equal to the twins and to the input padded explicitly."""
    x_shape, w_shape, stride, padding = UNEQUAL[name]
    gen = gen_on(card, SEED)
    xf = activations(gen, x_shape)["channels_last"]
    wf = torch.randn(w_shape[0], w_shape[-1], *w_shape[1:-1], generator=gen,
                     device=card) * 0.05
    bias = torch.randn(w_shape[0], generator=gen, device=card)
    flat = tuple(v for pair in reversed(padding) for v in pair)
    for dt in DTYPES:
        got, n = int8_conv_launches(xf.to(dt), wf, bias, stride, padding)
        assert n[0] >= 1 and n[1] == 1
        padded = layers_mod.int8_conv(F.pad(xf.to(dt), flat), wf, bias,
                                      stride, (0,) * len(padding))
        assert torch.equal(bits(got), bits(padded))
        with monkeypatch.context() as m:
            plain_int8(m)
            want, n = int8_conv_launches(xf.to(dt), wf, bias, stride,
                                         padding)
        assert n == (0, 0)
        assert torch.equal(bits(got), bits(want))


# ── the layer forms of the JAX package's blocks ──────────────────────────

LAYER_FORMS = {
    "conv_shift_matmul": (lambda: layers_mod.ConvBNAct(
        8, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1), bias=True,
        lowering="shift_matmul"), (2, 8, 8, 12, 12)),
    "conv_unequal_pairs": (lambda: layers_mod.ConvBNAct(
        4, 16, (3, 3, 3), (1, 2, 2), UNEQUAL_PAD, bias=True),
        (2, 4, 6, 13, 11)),
    "conv_unequal_pairs_shift_matmul": (lambda: layers_mod.ConvBNAct(
        4, 16, (3, 3, 3), (1, 1, 1), UNEQUAL_PAD, bias=True,
        lowering="shift_matmul"), (2, 4, 6, 13, 11)),
    "residual_shift_matmul": (lambda: layers_mod.ResidualBlockND(
        8, 16, (3, 3, 3), (1, 1, 1), lowering="shift_matmul"),
        (2, 8, 6, 6, 6)),
    "residual_2d_shift_matmul": (lambda: layers_mod.ResidualBlockND(
        8, 8, (3, 3), (1, 1), lowering="shift_matmul"), (2, 8, 20, 16)),
}
POOLS = {"pool_unequal_3d": ((2, 3, 5, 9, 8), (2, 3, 3), (1, 2, 2),
                             UNEQUAL_PAD),
         "pool_unequal_2d": ((2, 4, 9, 10), (3, 3), (2, 2),
                             ((0, 2), (1, 0))),
         "pool_past_half_window": ((2, 3, 7, 7), (3, 3), (2, 2),
                                   ((2, 2), (1, 1)))}


@pytest.mark.parametrize("name", [*LAYER_FORMS, *POOLS])
def test_layer_forms_on_the_card_equal_the_cpu(card, name):
    """``ConvBNAct`` and ``ResidualBlockND`` with ``lowering=
    "shift_matmul"``, ``ConvBNAct`` at unequal ``(lo, hi)`` padding pairs
    and ``max_pool_same`` at unequal pairs and past half its window (padded
    with -inf), on seeded weights: in float64 within 1e-6 of the CPU (the
    same function), in fp32 (TF32 off) within 1e-5, the JAX package's
    bound for the shift_matmul lowering (cuDNN and the CPU sum in other
    orders)."""
    gen = torch.Generator().manual_seed(SEED)
    if name in POOLS:
        shape, window, strides, padding = POOLS[name]

        def run(x):
            return layers_mod.max_pool_same(x, window, strides, padding)
    else:
        make, shape = LAYER_FORMS[name]
        module = make().eval()
        module.load_state_dict(seeded_state_dict(module, SEED))

        def run(x):
            with torch.no_grad():
                return module.to(x.device, x.dtype)(x)
    x = torch.randn(*shape, generator=gen)
    for dt, tol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        want = run(x.to(dt))
        got = run(x.to(card, dt)).cpu()
        assert float((got - want).abs().max()) <= tol, dt
