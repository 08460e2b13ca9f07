"""K5 (``ops/kernels/av_stem.py``, ``csrc/av_stem.cu``) on a CUDA card
against the module chain it replaces (``ResEncoder.frontend3D``: cuDNN's
convolution, PyTorch's BatchNorm, PReLU and max-pool, each stored in
bf16): bit-equal where every sum is exact, within a stated tolerance on
random inputs, and through the engine at AV-HuBERT LARGE's widths.

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
from lipsync_tpu_torch.models.avhubert import AVHubertConfig, ResEncoder
from lipsync_tpu_torch.ops.kernels import av_stem as k5

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import avhubert as ref  # noqa: E402

# Ragged shapes: partial tiles at the bottom and right, odd widths (the
# kernel's pixel-by-pixel staging), one frame, frames of a few pixels.
RAGGED = [(3, 5, 17, 23), (1, 1, 9, 9), (2, 3, 40, 50), (1, 4, 31, 7),
          (2, 2, 96, 96)]
CELL = (256, 32, 88, 88)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def stem(seed, device, dyadic=False):
    """The stem as ``AVHubert`` holds it in bf16 (convolution and PReLU
    bf16, BatchNorm fp32), eval mode, drawn from ``seed``; ``dyadic``: a
    weight of sixteenths in [-1/4, 1/4]."""
    g = torch.Generator().manual_seed(seed)
    enc = ResEncoder()
    conv, bn, prelu, _ = enc.frontend3D
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
        prelu.weight.copy_(torch.rand(64, generator=g) * 0.5)
    conv.to(torch.bfloat16)
    prelu.to(torch.bfloat16)
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
@pytest.mark.parametrize("shape", [CELL[:1] + (8,) + CELL[2:], *RAGGED],
                         ids=lambda s: "x".join(map(str, s)))
def test_bit_equal_where_every_sum_is_exact(card, shape):
    """Pixels of eighths and weights of sixteenths: every product is a
    multiple of 2^-7 and every partial sum of 245 stays under 2^6, so the
    fp32 sums are exact in any order and the conv output rounds to the
    same bf16 in both. With BatchNorm's statistics, weight and bias drawn
    at random and random slopes, the kernel's BatchNorm, PReLU and pool
    then equal PyTorch's bit for bit."""
    enc = stem(1, card, dyadic=True)
    got, want = both(enc, pixels(shape, 2, card, dyadic=True))
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("shape", [CELL, *RAGGED],
                         ids=lambda s: "x".join(map(str, s)))
def test_random_inputs_within_the_order_of_the_sum(card, shape):
    """Random pixels and weights: the kernel and cuDNN sum the 245 fp32
    products in other orders, a few fp32 steps (~2^-20 of the sum) apart,
    so a conv output whose exact sum lies that close to a bf16 rounding
    boundary (2^-8 of it apart) rounds to the neighbouring bf16: about
    2^-12 of them, and of the pooled values fewer (the pool keeps one of
    nine). Held: at most 1e-3 of the pooled values differ (2.9e-5 at the
    cell's shape on the card), each within ``av_stem.sum_order_bound``
    (per value: what another order of either fp32 sum can move it)."""
    enc = stem(3, card)
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
