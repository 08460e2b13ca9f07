"""K5 (``ops/kernels/av_stem.py``, ``csrc/av_stem.cu``) on a CUDA card
against the module chain it replaces (``ResEncoder.frontend3D``: cuDNN's
convolution, PyTorch's BatchNorm, PReLU or Swish and max-pool, each stored
in bf16): bit-equal where every sum is exact, within a stated tolerance on
random inputs, and through the engine at AV-HuBERT LARGE's and
Auto-AVSR's widths. The PReLU instantiation's output at AV-HuBERT's cell
shape is the one the kernel gave before it gained the Swish one
(``PRELU_DIGEST``).

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_av_stem_card.py --noconftest -m card
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models import avhubert
from lipsync_tpu_torch.models.auto_avsr import AutoAVSR, AutoAVSRConfig
from lipsync_tpu_torch.models.avhubert import AVHubertConfig, ResEncoder
from lipsync_tpu_torch.ops.kernels import av_stem as k5

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import auto_avsr as avsr_ref  # noqa: E402
from benchmark.reference import avhubert as ref  # noqa: E402
from torch_card import card  # noqa: E402, F401

# Ragged shapes: partial tiles at the bottom and right, odd widths (the
# kernel's pixel-by-pixel staging), one frame, frames of a few pixels.
RAGGED = [(3, 5, 17, 23), (1, 1, 9, 9), (2, 3, 40, 50), (1, 4, 31, 7),
          (2, 2, 96, 96)]
CELL = (256, 32, 88, 88)
AVSR_CELL = (256, 96, 88, 88)  # auto_avsr.bulk_av_pcm_windows' group


def stem(seed, device, dyadic=False, act="prelu"):
    """The stem as ``AVHubert`` (``act="prelu"``) or ``AutoAVSR``
    (``"swish"``) holds it in bf16 (convolution and PReLU bf16, BatchNorm
    fp32), eval mode, drawn from ``seed``; ``dyadic``: a weight of
    sixteenths in [-1/4, 1/4]."""
    g = torch.Generator().manual_seed(seed)
    enc = ResEncoder(act)
    conv, bn, act_module, _ = enc.frontend3D
    with torch.no_grad():
        if dyadic:
            conv.weight.copy_(torch.randint(-4, 5, k5.WEIGHT_SHAPE,
                                            generator=g) / 16)
        else:
            conv.weight.copy_(torch.randn(k5.WEIGHT_SHAPE, generator=g) / 16)
        bn.running_mean.copy_(torch.randn(64, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(64, generator=g) * 2 + 0.05)
        bn.weight.copy_(torch.randn(64, generator=g) * 0.5 + 1)
        bn.bias.copy_(torch.randn(64, generator=g) * 0.2)
        slopes = torch.rand(64, generator=g) * 0.5
        if act == "prelu":
            act_module.weight.copy_(slopes)
    conv.to(torch.bfloat16)
    act_module.to(torch.bfloat16)
    return enc.eval().to(device)


def pixels(shape, seed, device, dyadic=False):
    """``(B, 1, T, H, W)`` bf16 stem input: normalised grey pixels
    ((u - 0.421) / 0.165 for u uniform in [0, 1]), or ``dyadic``: eighths
    in [-1, 1]."""
    g = torch.Generator().manual_seed(seed)
    b, t, h, w = shape
    if dyadic:
        x = torch.randint(-8, 9, (b, 1, t, h, w), generator=g) / 8
    else:
        x = (torch.rand(b, 1, t, h, w, generator=g) - 0.421) / 0.165
    return x.to(torch.bfloat16).to(device)


def both(enc, x):
    with torch.inference_mode():
        return k5.av_stem(x, *k5.operands(enc.frontend3D)), enc.frontend3D(x)


@pytest.mark.card
@pytest.mark.parametrize("act", ["prelu", "swish"])
@pytest.mark.parametrize("shape", [CELL[:1] + (8,) + CELL[2:], *RAGGED],
                         ids=lambda s: "x".join(map(str, s)))
def test_bit_equal_where_every_sum_is_exact(card, shape, act):
    """Pixels of eighths and weights of sixteenths: every product is a
    multiple of 2^-7 and every partial sum of 245 stays under 2^6, so the
    fp32 sums are exact in any order and the conv output rounds to the
    same bf16 in both. With BatchNorm's statistics, weight and bias drawn
    at random and random slopes, the kernel's BatchNorm, PReLU and pool
    then equal PyTorch's bit for bit; and its Swish (fp32 ``x / (1 +
    exp(-x))``, PyTorch's silu formula) equals ``F.silu``'s."""
    enc = stem(1, card, dyadic=True, act=act)
    got, want = both(enc, pixels(shape, 2, card, dyadic=True))
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("shape, act", [(CELL, "prelu"), (AVSR_CELL, "swish")]
                         + [(s, a) for s in RAGGED
                            for a in ("prelu", "swish")],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_random_inputs_within_the_order_of_the_sum(card, shape, act):
    """Random pixels and weights: the kernel and cuDNN sum the 245 fp32
    products in other orders, a few fp32 steps (~2^-20 of the sum) apart,
    so a conv output whose exact sum lies that close to a bf16 rounding
    boundary (2^-8 of it apart) rounds to the neighbouring bf16: about
    2^-12 of them, and of the pooled values fewer (the pool keeps one of
    nine). Held: at most 1e-3 of the pooled values differ (2.9e-5 at the
    cell's shape on the card), each within ``av_stem.sum_order_bound``
    (per value: what another order of either fp32 sum can move it). The
    Swish instantiation at Auto-AVSR's cell group (96 frames) alike."""
    enc = stem(3, card, act=act)
    x = pixels(shape, 4, card)
    got, want = both(enc, x)
    diff = (got.float() - want.float()).abs()
    share = float((diff > 0).float().mean())
    bound = k5.sum_order_bound(x, *k5.operands(enc.frontend3D))
    used = float((diff / bound).max())
    print(f"{shape}: {share:.3e} of pooled values differ, widest "
          f"{float(diff.max()):.3g}, {used:.3g} of the bound")
    assert share <= 1e-3
    assert used <= 1.0


def windows(n, seed):
    """``n`` windows as the bulk cell makes them: grey uint8 crops
    darkened per window, dB log-mel."""
    cfg = AVHubertConfig()
    rng = np.random.RandomState(seed)
    shape = (n, cfg.video_frames, cfg.crop_size, cfg.crop_size)
    level = rng.randint(64, 257, (n, 1, 1, 1))
    visual = (rng.randint(0, 256, shape) * level // 256).astype(np.uint8)
    mel = (-80 * rng.rand(n, cfg.mel_bins, cfg.audio_frames)).astype(
        np.float32)
    return visual, mel


@pytest.fixture(scope="module")
def engine(card):
    cfg = AVHubertConfig()
    model = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    weights = ref.make_weights(model, 11, card)
    visual, mel = windows(32, 12)
    ref.calibrate(weights, model,
                  torch.from_numpy(visual).to(card).float() / 255,
                  torch.from_numpy(mel).to(card))
    eng = ScoringEngine(weights, cfg, max_batch=256, device=card)
    yield eng
    del eng
    torch.cuda.empty_cache()


@pytest.mark.card
def test_engine_logits_within_two_ulps_of_the_chain(engine, monkeypatch):
    """AV-HuBERT LARGE through ``ScoringEngine`` in bf16 on 512 seeded
    windows, with BatchNorm calibrated on the windows' kind: the logits
    (of order 1-4, where a bf16 step is 2^-7 to 2^-6) stay within 0.03125,
    two steps, of the same engine with the module chain in K5's place. One
    launch of K5 per forward (two groups of 256)."""
    visual, mel = windows(512, 13)
    before = k5.launches
    got = engine.score_logits(visual, mel)
    assert k5.launches == before + 2
    monkeypatch.setattr(avhubert, "stem_takes_kernel", lambda x, m: False)
    want = engine.score_logits(visual, mel)
    assert k5.launches == before + 2
    gap = float(np.abs(got - want).max())
    print(f"engine logits: widest gap {gap:.4g}, "
          f"{float(np.mean(got != want)):.3f} of them differ")
    assert gap <= 0.03125


@pytest.mark.card
def test_one_launch_per_forward(card):
    """``AVHubert.encode_visual`` on a bf16 CUDA batch in inference mode
    launches K5 once a call; in training mode, or with fp32, it launches
    none."""
    cfg = AVHubertConfig(video_frames=4, encoder_layers=1, embed_dim=64,
                         ffn_dim=128, heads=4, conv_pos_groups=4)
    model = avhubert.AVHubert(cfg, dtype=torch.bfloat16).to(card).eval()
    visual = torch.rand(3, 4, 96, 96, device=card)
    before = k5.launches
    with torch.inference_mode():
        for i in range(3):
            model.encode_visual(visual)
            assert k5.launches == before + i + 1
    model.train()
    with torch.no_grad():
        model.encode_visual(visual)
    model32 = avhubert.AVHubert(cfg).to(card).eval()
    with torch.inference_mode():
        model32.encode_visual(visual)
    assert k5.launches == before + 3


# sha256 of K5's PReLU output at AV-HuBERT's cell shape on the inputs of
# :func:`prelu_at_the_cell`, as the kernel gave it before the Swish
# instantiation was added (H100 80GB HBM3).
PRELU_DIGEST = \
    "4dde65eb735246c719f1d3d162ba96cf6532b4ce9f881a2277750f765ca67007"


def prelu_at_the_cell(device):
    """K5's PReLU instantiation on AV-HuBERT's cell group (256 windows of
    32 frames of 88 x 88), from operands drawn on the host with a seeded
    generator and no module, so that any checkout's wrapper takes them."""
    import hashlib

    g = torch.Generator().manual_seed(2025)
    x = ((torch.rand((256, 1, 32, 88, 88), generator=g) - 0.421) / 0.165)
    w = torch.randn(k5.WEIGHT_SHAPE, generator=g) / 16
    bn = (torch.randn(64, generator=g) * 0.5 + 1,
          torch.randn(64, generator=g) * 0.2,
          torch.randn(64, generator=g) * 0.5,
          torch.rand(64, generator=g) * 2 + 0.05)
    slope = torch.rand(64, generator=g) * 0.5
    with torch.inference_mode():
        out = k5.av_stem(x.bfloat16().to(device), w.bfloat16().to(device),
                         *(p.to(device) for p in bn), 1e-5,
                         slope.bfloat16().to(device))
        data = out.contiguous().view(torch.int16).cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()


@pytest.mark.card
def test_prelu_output_is_the_parents(card):
    """The PReLU instantiation, compiled beside the Swish one, writes the
    same bits at AV-HuBERT's cell shape as the kernel did alone."""
    assert prelu_at_the_cell(card) == PRELU_DIGEST


@pytest.mark.card
def test_swish_one_launch_per_forward(card):
    """``AutoAVSR.encode_visual`` on a bf16 CUDA batch in inference mode
    launches K5 (its Swish instantiation) once a call; in training mode,
    or with fp32, it launches none."""
    cfg = AutoAVSRConfig(video_frames=4, audio_frames=16, adim=64, aheads=4,
                         eunits=128, elayers=1, fusion_hdim=128)
    model = AutoAVSR(cfg, dtype=torch.bfloat16).to(card).eval()
    visual = torch.rand(3, 4, 96, 96, device=card)
    before = k5.launches
    with torch.inference_mode():
        for i in range(3):
            model.encode_visual(visual)
            assert k5.launches == before + i + 1
    model.train()
    with torch.no_grad():
        model.encode_visual(visual)
    model32 = AutoAVSR(cfg).to(card).eval()
    with torch.inference_mode():
        model32.encode_visual(visual)
    assert k5.launches == before + 3


def avsr_windows(n, seed):
    """``n`` windows as the Auto-AVSR cell makes them: grey uint8 crops
    darkened per window, and PCM of noise at a level per window."""
    cfg = AutoAVSRConfig()
    rng = np.random.RandomState(seed)
    shape = (n, cfg.video_frames, cfg.crop_size, cfg.crop_size)
    level = rng.randint(64, 257, (n, 1, 1, 1))
    visual = (rng.randint(0, 256, shape) * level // 256).astype(np.uint8)
    pcm = (rng.randn(n, 1, cfg.video_frames * 640)
           * rng.uniform(0.02, 0.3, (n, 1, 1))).astype(np.float32)
    return visual, pcm


@pytest.mark.card
def test_auto_avsr_engine_logits_near_the_chain(card, monkeypatch):
    """Auto-AVSR through ``ScoringEngine`` in bf16 at its published widths
    on 512 seeded windows (two groups of 256), BatchNorm calibrated on
    the windows' kind: one launch of K5's Swish instantiation per forward,
    and the logits no further from the same engine with the module chain
    in K5's place than 1.5 times that chain's own distance from the plain
    reference at the configuration's precision (bf16 everywhere). K5
    changes the order of the stem's fp32 sums, so ~3e-5 of its pooled
    values round to the neighbouring bf16; the two 12-layer conformers on
    seeded weights carry any such difference, as they carry every other
    rounding of the bf16 program, to logit gaps of order 0.1 (at logits of
    -3 to 3.5: 0.121 on the card, where two bf16 steps would be 0.03)."""
    cfg = AutoAVSRConfig()
    model = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    weights = avsr_ref.make_weights(model, 21, card)
    visual, pcm = avsr_windows(32, 22)
    avsr_ref.calibrate(weights, model,
                       torch.from_numpy(visual).to(card).float() / 255,
                       torch.from_numpy(pcm).to(card))
    engine = ScoringEngine(weights, cfg, max_batch=256, device=card)
    visual, pcm = avsr_windows(512, 23)
    before = k5.launches
    got = engine.score_logits(visual, pcm)
    assert k5.launches == before + 2
    monkeypatch.setattr(avhubert, "stem_takes_kernel", lambda x, m: False)
    want = engine.score_logits(visual, pcm)
    assert k5.launches == before + 2
    del engine
    torch.cuda.empty_cache()
    bf16 = {p: {"act": "bf16", "math": "bf16"} for p in avsr_ref.PARTS}
    reference = avsr_ref.logits_in_blocks(
        weights, model, torch.from_numpy(visual).to(card),
        torch.from_numpy(pcm).to(card), bf16, 64).cpu().numpy()
    gap = float(np.abs(got - want).max())
    chain_gap = float(np.abs(want - reference).max())
    print(f"auto_avsr engine logits: widest gap {gap:.4g}, "
          f"{float(np.mean(got != want)):.3f} of them differ, logits "
          f"{float(got.min()):.3f} to {float(got.max()):.3f}; the chain "
          f"{chain_gap:.4g} from the reference")
    assert gap <= 1.5 * chain_gap
