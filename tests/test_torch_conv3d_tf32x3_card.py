"""K6 (``ops/kernels/conv3d_tf32x3.py``, ``csrc/conv3d_tf32x3.cu``) on a
CUDA card: against a float64 convolution at every layers 1-2 geometry,
held to cuDNN's fp32 error and well under single-pass TF32's; at every
input the main path gives it against the fp32 module chain; its launches
in a flagship forward; the served logits against the parent's chain and a
float64 one;
training and int8 untouched; and its time at one window beside the
chain's.

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_conv3d_tf32x3_card.py --noconftest -m card
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.models.layers import ConvBNAct
from lipsync_tpu_torch.models.visual_encoder import VisualEncoder
from lipsync_tpu_torch.ops.kernels import conv3d_tf32x3 as k6

ROOT = Path(__file__).resolve().parents[1]
if str(Path(__file__).parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).parent))

import torch_card  # noqa: E402
from torch_card import K6_CLIPS, card, tf32_off  # noqa: E402, F401

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("tf32_off")]

# name: C_in, C_out, kernel, stride, padding, the input's H = W at 96 x 96
GEOMETRIES = {
    "layer1": (64, 64, (3, 3, 3), (1, 1, 1), (1, 1, 1), 24),
    "layer2.conv1": (64, 128, (3, 3, 3), (1, 2, 2), (1, 1, 1), 24),
    "layer2.conv2": (128, 128, (3, 3, 3), (1, 1, 1), (1, 1, 1), 12),
    "layer2.shortcut": (64, 128, (1, 1, 1), (1, 2, 2), (0, 0, 0), 24),
}
# (B, T, H, W) of the input: B = 1, 16, 256 windows of 32 frames at the
# geometry's frame size, and ragged T, H and W
BATCHES = {"b1": (1, 32, None, None), "b16": (16, 32, None, None),
           "b256": (256, 32, None, None), "ragged": (3, 5, 17, 13),
           "ragged_small": (2, 7, 3, 5)}


def seeded_block(name, seed, device):
    """The geometry's conv and BatchNorm, fan-in scaled weights and drawn
    statistics, in eval mode on ``device``."""
    cin, cout, kernel, stride, padding, _ = GEOMETRIES[name]
    g = torch.Generator().manual_seed(seed)
    block = ConvBNAct(cin, cout, kernel, stride, padding, act=False)
    with torch.no_grad():
        block[0].weight.copy_(torch.randn(block[0].weight.shape, generator=g)
                              * (2 / (cin * np.prod(kernel))) ** 0.5)
        bn = block[1]
        bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
        bn.weight.copy_(torch.randn(cout, generator=g) * 0.3 + 1)
        bn.bias.copy_(torch.randn(cout, generator=g) * 0.2)
    return block.eval().to(device)


def activations(shape, seed, device):
    """Post-ReLU activations: a half-normal, channels last."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).relu_().to(device)


def errors(y, ref):
    """Max and RMS error of ``y`` against ``ref`` (float64), each over the
    reference's max and RMS."""
    d = y.double() - ref
    return (float(d.abs().max() / ref.abs().max()),
            float(d.square().mean().sqrt() / ref.square().mean().sqrt()))


def conv64(x, w, stride, padding):
    return F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double(), None,
                    stride, padding).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fp32_accurate_against_float64(card, name, batch):
    """The convolution alone (identity affine): K6's max and RMS error
    against a float64 convolution at most 2x cuDNN's fp32 (TF32 off) and
    at most 1/20 of the same convolution on TF32-rounded operands, which
    single-pass TF32 computes. With BatchNorm, the residual and ReLU the
    output lies within the convolution's own error bound of float64."""
    cin, cout, kernel, stride, padding, hw = GEOMETRIES[name]
    b, t, h, w = BATCHES[batch]
    x = activations((b, t, h or hw, w or hw, cin), 1, card)
    block = seeded_block(name, 2, card)
    wt = block[0].weight
    with torch.inference_mode():
        ref = conv64(x, wt, stride, padding)
        cudnn = F.conv3d(x.permute(0, 4, 1, 2, 3), wt, None, stride,
                         padding).permute(0, 2, 3, 4, 1)
        e_cudnn = errors(cudnn, ref)
        del cudnn
        e_tf32 = errors(conv64(k6.tf32_round(x), k6.tf32_round(wt), stride,
                               padding), ref)
        p = k6.packed(block)
        ident = p._replace(scale=torch.ones_like(p.scale),
                           shift=torch.zeros_like(p.shift))
        e_k6 = errors(k6.conv3d_tf32x3(x, ident, stride, padding), ref)
        for i in range(2):
            assert e_k6[i] <= 2 * e_cudnn[i], (e_k6, e_cudnn)
            assert e_k6[i] <= e_tf32[i] / 20, (e_k6, e_tf32)

        residual = activations(ref.shape, 3, card) - 0.5
        y = k6.conv3d_tf32x3(x, p, stride, padding, residual, True)
        bn = block[1]
        inv = torch.rsqrt(bn.running_var.double() + bn.eps)
        want = ((ref - bn.running_mean.double()) * inv * bn.weight.double()
                + bn.bias.double() + residual.double()).relu()
        scale = (bn.weight.double() * inv).abs().max()
        tol = 2 * e_cudnn[0] * float(ref.abs().max() * scale) + 4e-7 * float(
            want.abs().max())
        assert float((y.double() - want).abs().max()) <= tol


@pytest.fixture(scope="module")
def visual(card):
    """The flagship's visual encoder in fp32, eval mode, on the card, with
    every BatchNorm calibrated on seeded clips (its layers near unit
    scale)."""
    enc = VisualEncoder().to(card)
    g = torch.Generator().manual_seed(4)
    for bn in layers_mod.batch_norms(enc):
        bn.momentum = None  # cumulative: one batch gives its statistics
    with torch.no_grad():
        enc.train()
        enc(torch.rand(4, 8, 96, 96, 3, generator=g).to(card))
    return enc.eval()


@pytest.mark.parametrize("clip", K6_CLIPS, ids=lambda c: "x".join(map(str, c)))
def test_every_main_path_input_against_the_chain(card, visual, clip):
    """At every input the main path gives K6 (``torch_card.K6_CLIPS``:
    each residual block of the fp32 encoder on the clip, the block's input
    made by the chain) each block on K6 lies within 2e-5 of max(1,
    |chain|) of the fp32 module chain, and launches one K6 per
    convolution."""
    b, t, h, w = clip
    x = torch.rand(b, t, h, w, 3, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        out = visual.stem(x.to(card).permute(0, 4, 1, 2, 3))
        out = layers_mod.max_pool_same(out, (1, 3, 3), (1, 2, 2),
                                       ((0, 0), (1, 1), (1, 1)))
        for name in ("layer1", "layer2", "layer3", "layer4"):
            block = getattr(visual, name)
            before = k6.launches
            got = block(out)
            assert k6.launches - before == 2 + (block.downsample is not None)
            identity = out if block.downsample is None else \
                block.downsample(out)
            want = F.relu(block.conv2(block.conv1(out)) + identity)
            assert k6.launches - before == 2 + (block.downsample is not None)
            tol = 2e-5 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, name
            out = want
            del got


@pytest.mark.parametrize("batch", [1, 256])
def test_layers_1_2_run_on_k6_alone(card, visual, batch):
    """In a profiler trace of layers 1-2 of one group in eval fp32 the
    card runs K6 five times (two convolutions of layer1, layer2's two and
    its shortcut) and no cuDNN convolution; the whole bf16 engine forward
    launches K6 five times a group."""
    x = torch.rand(batch, 32, 96, 96, 3, device=card)
    with torch.inference_mode():
        out = visual.stem(x.permute(0, 4, 1, 2, 3))
        out = layers_mod.max_pool_same(out, (1, 3, 3), (1, 2, 2),
                                       ((0, 0), (1, 1), (1, 1)))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            visual.layer2(visual.layer1(out))
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k6_names = [n for n in names if "conv3d_tf32x3_kernel" in n]
    assert len(k6_names) == 5, names
    conv = [n for n in names if "conv" in n.lower() and n not in k6_names
            or "xmma" in n or "implicit_gemm" in n]
    assert not conv, conv


def test_one_flagship_group_launches_k6_five_times(card):
    weights = LipSyncModel(ModelConfig()).state_dict()
    engine = ScoringEngine(weights, ModelConfig(), device=card)
    visual = np.zeros((256, 32, 96, 96, 3), np.uint8)
    mel = np.zeros((256, 80, 128), np.float32)
    before = k6.launches
    engine.score_logits(visual, mel)
    torch.cuda.synchronize()
    assert k6.launches - before == 5


@pytest.fixture(scope="module")
def calibrated(card):
    return torch_card.weight_sets(ModelConfig(), card)["bn_calibrated"]


def seeded_windows(n, seed):
    rng = np.random.RandomState(seed)
    level = rng.randint(64, 257, (n, 1, 1, 1, 1))
    visual = (rng.randint(0, 256, (n, 32, 96, 96, 3)) * level // 256
              ).astype(np.uint8)
    return visual, (-80 * rng.rand(n, 80, 128)).astype(np.float32)


class Float64(torch.nn.Module):
    """A residual block run in float64 (a copy of ``block``), fp32 out."""

    def __init__(self, block):
        super().__init__()
        self.block = copy.deepcopy(block).double()

    def forward(self, x):
        return self.block(x.double()).float()


def test_served_logits_against_the_parent_chain(card, calibrated,
                                                monkeypatch, capsys):
    """512 seeded windows on BatchNorm-calibrated weights. The fp32 engine
    (K6 in all four layers): logits within 1e-3 of the parent's module
    chain (the predicate refusing every block). The served bf16 engine
    (K6 in layers 1-2: 5 launches a group, 11 in fp32): layer2's output is rounded to bf16
    for layers 3-4, so any change in its last fp32 bits moves a few values
    by a bf16 step, and the logits by a fraction of one of theirs (2^-6 at
    2); so K6's logits are held against those of layers 1-2 in float64,
    at most 1.5x (or 1e-3) as far from them as the parent's chain."""
    visual, mel = seeded_windows(512, 6)
    gaps = {}
    for dtype, use_bf16 in (("fp32", False), ("bf16", True)):
        engine = ScoringEngine(calibrated, ModelConfig(),
                               use_bfloat16=use_bf16, device=card)
        enc = engine.model.visual_encoder
        before = k6.launches
        got = engine.score_logits(visual, mel)
        assert k6.launches - before == (10 if use_bf16 else 22)
        with monkeypatch.context() as m:
            m.setattr(layers_mod, "tf32x3_takes", lambda x, b: False)
            want = engine.score_logits(visual, mel)
            m.setattr(enc, "layer1", Float64(enc.layer1))
            m.setattr(enc, "layer2", Float64(enc.layer2))
            exact = engine.score_logits(visual, mel)
        assert k6.launches - before == (10 if use_bf16 else 22)
        assert np.isfinite(got).all()
        gaps[dtype] = {"k6_vs_chain": float(np.abs(got - want).max()),
                       "k6_vs_float64": float(np.abs(got - exact).max()),
                       "chain_vs_float64": float(np.abs(want - exact).max())}
        del engine
        torch.cuda.empty_cache()
    with capsys.disabled():
        print(json.dumps({"served_logit_gaps": gaps}))
    assert gaps["fp32"]["k6_vs_chain"] <= 1e-3
    bf16 = gaps["bf16"]
    assert bf16["k6_vs_float64"] <= max(1.5 * bf16["chain_vs_float64"], 1e-3)


def test_training_and_int8_run_as_before(card, calibrated, monkeypatch):
    """A training forward (train mode, gradients recorded) and the int8
    engine launch no K6 and give the same bits as with the predicate
    refusing every block."""
    cfg = ModelConfig()
    model = LipSyncModel(cfg).to(card)
    model.load_state_dict(calibrated)
    visual, mel = seeded_windows(4, 7)
    v = torch.from_numpy(visual).to(card).float() / 255
    a = torch.from_numpy(mel).to(card)[..., None]
    int8 = ScoringEngine(calibrated, cfg, quantized_int8=True, device=card)
    runs = []
    for refuse in (False, True):
        with monkeypatch.context() as m:
            if refuse:
                m.setattr(layers_mod, "tf32x3_takes", lambda x, b: False)
            torch.manual_seed(8)
            before = k6.launches
            model.train()
            out = model(v, a)
            logits = int8.score_logits(visual, mel)
            torch.cuda.synchronize()
            assert k6.launches == before
            runs.append((out.detach(), logits))
    assert torch.equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])


def test_time_at_one_window_is_recorded(card, visual, capsys):
    """K6's layers 1-2 at one window beside the chain's (CUDA events,
    device time a call): recorded, not bounded."""
    x = torch.rand(1, 32, 96, 96, 3, device=card)
    with torch.inference_mode():
        out = visual.stem(x.permute(0, 4, 1, 2, 3))
        out = layers_mod.max_pool_same(out, (1, 3, 3), (1, 2, 2),
                                       ((0, 0), (1, 1), (1, 1)))

        def run():
            return visual.layer2(visual.layer1(out))

        times = {}
        for label, takes in (("k6", layers_mod.tf32x3_takes),
                             ("chain", lambda x, b: False),
                             ("k6_again", layers_mod.tf32x3_takes)):
            with pytest.MonkeyPatch.context() as m:
                m.setattr(layers_mod, "tf32x3_takes", takes)
                run()
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    run()
                b.record()
                b.synchronize()
                times[label] = a.elapsed_time(b) / 20
    assert all(np.isfinite(v) and v > 0 for v in times.values())
    with capsys.disabled():
        print(json.dumps({"k6_layers_1_2_ms_at_b1": times,
                          "card": torch.cuda.get_device_name(0)}))
