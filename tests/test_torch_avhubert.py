"""AV-HuBERT LARGE as the port's second detector (``models/avhubert.py``)
against its plain reference (``benchmark/reference/avhubert.py``) on
seeded weights at a small size, and through ``ScoringEngine`` and
``Predictor.predict``.

The small configuration keeps the ResNet at its fixed widths and the
positional convolution's kernel of 128, with 2 layers of width 64, 4
heads, FFN 128, 4 frames and 32-pixel crops. It takes 4 groups for the
positional convolution (16 channels a group) where LARGE takes 16 (64 a
group): PyTorch's CPU bf16 grouped Conv1d with this kernel and padding
returns wrong sums at fewer than 16 channels a group (off by the output's
own size at 4 and 8), a fault of the CPU library and not of the model.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models.avhubert import (
    AVHubert,
    AVHubertConfig,
    fold_weight_norm,
    grey_pixels,
    stack_audio,
)
from lipsync_tpu_torch.models.bridge import seeded_state_dict
from lipsync_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import avhubert as ref  # noqa: E402
from benchmark.reference.model import Run, fp32_precision  # noqa: E402

torch.set_num_threads(1)

SMALL = AVHubertConfig(video_frames=4, crop_size=32, audio_frames=16,
                       encoder_layers=2, embed_dim=64, ffn_dim=128, heads=4,
                       conv_pos_groups=4)
BF16 = {p: {"act": "bf16", "math": "bf16"}
        for p in ("visual_low", "visual_high", "audio", "tokens")}
# The bf16 port against the reference rounding where bf16 rounds: what
# differs is the order of the fp32 sums (oneDNN's algorithms, SDPA's
# tiles) and so which way a few stored values round. The logits are bf16
# (an ulp is 2^-8 in [0.5, 1)). Over 16 windows of each of seeds 0-5, one
# thread: the port's mean gap 2.6e-3 to 5.0e-3 and widest 7.8e-3 to
# 1.56e-2; with int8 in the encoder's linear maps alone (the reference's
# ``tokens`` part), mean 1.26e-2 to 1.64e-2 and widest 2.54e-2 to 4.3e-2.
BF16_MEAN_GAP = 8e-3
BF16_MAX_GAP = 2e-2


def cfg_dict(cfg=SMALL):
    return dataclasses.asdict(cfg)


def inputs(seed, n=3, cfg=SMALL):
    g = torch.Generator().manual_seed(seed)
    visual = torch.randint(0, 256, (n, cfg.video_frames, cfg.crop_size,
                                    cfg.crop_size), generator=g,
                           dtype=torch.uint8)
    mel = -80.0 * torch.rand(n, cfg.mel_bins, cfg.audio_frames, generator=g)
    return visual, mel


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(AVHubert(SMALL), 3)


def model(sd, cfg=SMALL, dtype=torch.float32):
    m = AVHubert(cfg, dtype=dtype)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def test_param_table_is_the_models():
    """The reference's table is the port's state dict, by name and shape,
    and at the published widths AV-HuBERT LARGE has ~325 M parameters."""
    sd = AVHubert(SMALL).state_dict()
    table = ref.param_shapes(cfg_dict())
    assert {k: tuple(v.shape) for k, v in sd.items()} == table
    with torch.device("meta"):
        large = AVHubert().state_dict()
    shapes = ref.param_shapes(cfg_dict(AVHubertConfig()))
    assert {k: tuple(v.shape) for k, v in large.items()} == shapes
    n = sum(math.prod(s) for s in shapes.values())
    assert 3.2e8 < n < 3.3e8
    assert "encoder.pos_conv.0.weight_g" in shapes
    assert "feature_extractor_video.resnet.trunk.layer4.0.downsample.0."\
           "weight" in shapes


@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_logits_are_the_references(weights, seed):
    """fp32 on both sides: the same operations, summed in another order
    (oneDNN's convolution algorithms, SDPA against an explicit softmax),
    so the logits (of order 1) agree to a few fp32 ulps through the ResNet
    and 2 layers; 1e-5 leaves room for that and for nothing else."""
    visual, mel = inputs(seed)
    with torch.no_grad():
        got = model(weights)(visual.float() / 255, mel)
    want = ref.forward(weights, cfg_dict(), visual.float() / 255, mel,
                       Run(fp32_precision()))
    assert got.dtype == torch.float32 and got.shape == (3,)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_logits_are_the_references(weights, seed):
    """bf16 against the reference rounding at the same points, over 16
    windows: the mean and the widest gap within ``BF16_MEAN_GAP`` and
    ``BF16_MAX_GAP``, which int8 in the encoder's linear maps exceeds."""
    visual, mel = inputs(seed, n=16)
    v = visual.float() / 255
    with torch.no_grad():
        got = model(weights, dtype=torch.bfloat16)(v, mel)
    want = ref.forward(weights, cfg_dict(), v, mel, Run(BF16))
    tokens_int8 = dict(BF16, tokens={"act": "bf16", "math": "int8"})
    low = ref.forward(weights, cfg_dict(), v, mel, Run(tokens_int8))
    gap, low_gap = (got - want).abs(), (low - want).abs()
    assert gap.mean() <= BF16_MEAN_GAP < low_gap.mean()
    assert gap.max() <= BF16_MAX_GAP < low_gap.max()


def test_audio_stacking_and_layer_norm():
    """Every 4 mel frames side by side, frame after frame, then a layer
    norm over the 4F features of each video frame with no affine."""
    mel = torch.arange(2 * 8, dtype=torch.float32).view(1, 2, 8)  # F=2
    stacked = stack_audio(mel[..., None], 2)
    assert stacked.shape == (1, 2, 8)
    # frame t holds mel[:, 4t], mel[:, 4t+1], ... each as (bin 0, bin 1)
    assert stacked[0, 0].tolist() == [0, 8, 1, 9, 2, 10, 3, 11]
    assert stacked[0, 1].tolist() == [4, 12, 5, 13, 6, 14, 7, 15]
    with pytest.raises(ValueError):
        stack_audio(mel, 3)
    m = AVHubert(dataclasses.replace(SMALL, mel_bins=2)).eval()
    proj = m.feature_extractor_audio.proj
    row = stacked[0, 0]
    normed = (row - row.mean()) / torch.sqrt(row.var(unbiased=False) + 1e-5)
    with torch.no_grad():
        got = m.feature_extractor_audio(stacked)[0, 0]
    torch.testing.assert_close(got, proj.weight @ normed + proj.bias)


def test_weight_norm_fold(weights):
    """The folded weight is ``g * v / ||v||`` with one norm per tap, as
    ``torch.nn.utils.parametrizations.weight_norm(dim=2)`` computes it;
    it is made when a state dict is loaded."""
    g = weights["encoder.pos_conv.0.weight_g"]
    v = weights["encoder.pos_conv.0.weight_v"]
    by_tap = torch.stack([g[0, 0, k] * v[..., k] / v[..., k].norm()
                          for k in range(v.shape[-1])], dim=-1)
    torch.testing.assert_close(fold_weight_norm(g, v), by_tap)
    conv = torch.nn.Conv1d(v.shape[0], v.shape[0], v.shape[-1],
                           groups=SMALL.conv_pos_groups)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(g)
        conv.parametrizations.weight.original1.copy_(v)
    pos = model(weights).encoder.pos_conv[0]
    torch.testing.assert_close(pos.folded_weight, conv.weight.detach())
    bf = model(weights, dtype=torch.bfloat16).encoder.pos_conv[0]
    assert bf.folded_weight.dtype == torch.bfloat16
    assert bf.weight_v.dtype == torch.float32
    torch.testing.assert_close(bf.folded_weight, by_tap.bfloat16())


def test_centre_crop_margin():
    """The 4-pixel margin a side: 32 -> 24 here, 96 -> 88 at LARGE's
    size, 48 -> 40 at the benchmark's rehearsal size."""
    m = AVHubert(SMALL)
    x = torch.rand(1, 4, 32, 32)
    got = m._pixels(x)
    assert got.shape == (1, 1, 4, 24, 24)
    torch.testing.assert_close(got[0, 0], (x[0, :, 4:28, 4:28] - 0.421)
                               / 0.165)
    for size, want in ((96, 88), (48, 40)):
        cfg = dataclasses.replace(SMALL, crop_size=size)
        assert AVHubert(cfg)._pixels(torch.rand(1, 1, size, size)
                                     ).shape[-1] == want


def test_state_dict_round_trip(weights):
    """``state_dict`` out of one model loads into another with
    ``strict=True`` (the folded weight is no entry) and gives the same
    logits; a missing or extra entry is refused."""
    a = model(weights)
    out = a.state_dict()
    assert set(out) == set(weights)
    b = model(out)
    visual, mel = inputs(2)
    with torch.no_grad():
        assert torch.equal(a(visual.float() / 255, mel),
                           b(visual.float() / 255, mel))
    with pytest.raises(RuntimeError):
        AVHubert(SMALL).load_state_dict(
            {k: v for k, v in weights.items() if "weight_g" not in k})
    with pytest.raises(RuntimeError):
        AVHubert(SMALL).load_state_dict(dict(weights, extra=torch.ones(1)))


def test_grey_pixels_are_cv2s():
    cv2 = pytest.importorskip("cv2")
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 9, 3), np.uint8)
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in rgb])
    np.testing.assert_array_equal(grey_pixels(rgb), want)
    f = rgb.astype(np.float32) / 255
    np.testing.assert_allclose(
        grey_pixels(f), f @ np.array([0.299, 0.587, 0.114], np.float32),
        rtol=1e-6)


def engine(weights, **kw):
    return ScoringEngine(weights, SMALL, use_bfloat16=False, max_batch=4,
                         device="cpu", **kw)


def test_engine_score_logits_is_the_forward(weights):
    """Grey uint8 windows in groups of ``max_batch`` (two in flight):
    the model's own forward on ``/255`` pixels; RGB windows are made grey
    on the host first."""
    visual, mel = inputs(4, n=6)
    eng = engine(weights)
    got = eng.score_logits(visual.numpy(), mel.numpy())
    with torch.no_grad():
        want = model(weights)(visual.float() / 255, mel).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rgb = np.random.RandomState(1).randint(
        0, 256, tuple(visual.shape) + (3,), np.uint8)
    with torch.no_grad():
        want = model(weights)(torch.from_numpy(grey_pixels(rgb)).float()
                              / 255, mel).numpy()
    np.testing.assert_allclose(eng.score_logits(rgb, mel.numpy()), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True])
def test_engine_track_logits(weights, shared):
    """A grey track's windows gathered on the device: per window, each
    window's forward; with shared encoding, the whole padded track's video
    features gathered per window (interior windows see real neighbours in
    the 3D stem)."""
    t = SMALL.video_frames
    g = torch.Generator().manual_seed(5)
    crops = torch.randint(0, 256, (11, 32, 32), generator=g,
                          dtype=torch.uint8)
    starts = [0, 3, 7]
    _, mel = inputs(6, n=3)
    eng = engine(weights, shared_visual_encoding=shared)
    got = eng.score_track_logits(crops.numpy(), starts, mel.numpy())
    m = model(weights)
    idx = torch.tensor(starts)[:, None] + torch.arange(t)
    with torch.no_grad():
        if not shared:
            want = m(crops[idx].float() / 255, mel)
        else:
            n_pad = t
            while n_pad < 11:
                n_pad *= 2
            track = torch.cat([crops, crops[-1:].expand(n_pad - 11, -1, -1)])
            feat, none = m.encode_visual(track[None].float() / 255)
            assert none is None
            want = m.score_encoded(feat[0][idx], None, None, mel)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    rgb = np.repeat(crops.numpy()[..., None], 3, axis=-1)  # grey in RGB
    np.testing.assert_allclose(eng.score_track_logits(rgb, starts,
                                                      mel.numpy()),
                               got, rtol=0, atol=1e-6)


def test_engine_refuses_the_flagships_lowerings(weights):
    for kw in ({"quantized_int8": True}, {"fold_hf_stem": True}):
        with pytest.raises(ValueError, match="AVHubertConfig"):
            engine(weights, **kw)


def test_spans_and_counter(weights):
    """No profiler session: nothing recorded. Under one, ``avhubert.
    visual`` and ``avhubert.encoder`` open inside ``engine.forward`` and
    ``avhubert.encoder_tokens`` counts the rows dispatched (the bucket)
    times the frames."""
    visual, mel = inputs(7, n=4)
    eng = engine(weights)
    profiling.clear()
    eng.score_logits(visual.numpy(), mel.numpy())
    assert profiling.records() == [] and profiling.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.score_logits(visual.numpy(), mel.numpy())
    records = profiling.records()
    by_id = {r.id: r for r in records}
    for name in ("avhubert.visual", "avhubert.encoder"):
        mine = [r for r in records if r.name == name]
        assert len(mine) == 1
        assert by_id[mine[0].parent].name == "engine.forward"
    assert profiling.counters()["avhubert.encoder_tokens"] == \
        4 * SMALL.video_frames
    profiling.clear()


def test_predict_runs_avhubert(tmp_path, weights):
    """``Predictor.predict`` with ``architecture="avhubert_large"`` on a
    short synthetic clip: the model sees grey ``(B, T, H, W)`` crops and a
    26-bin log-mel from K1's twin, and the response is whole."""
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.preprocessing import mux
    from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
    from lipsync_tpu_torch.serving.config import Settings
    from tests.fixtures import speechish_pcm, synthetic_frames

    cfg = dataclasses.replace(SMALL, video_frames=8, audio_frames=32)
    clip = mux.write_video(tmp_path / "short.avi", synthetic_frames(n=8),
                           fps=15.0, pcm=speechish_pcm(seconds=8 / 15),
                           sample_rate=16000)
    eng = ScoringEngine(weights, cfg, use_bfloat16=False, device="cpu")
    seen = []
    inner = eng.model.forward

    def spy(visual, audio):
        seen.append((tuple(visual.shape), tuple(audio.shape)))
        return inner(visual, audio)

    eng.model.forward = spy
    settings = Settings(architecture="avhubert_large", device="cpu")
    config = settings.to_predictor_config()
    assert config.architecture == "avhubert_large"
    with pytest.raises(ValueError):
        PredictorConfig(architecture="resnet")
    predictor = Predictor(config=config, model_config=cfg, engine=eng,
                          detector_backend=FakeDetector(
                              lambda i: [(60, 70, 110, 105)]),
                          device="cpu")
    result = predictor.predict(clip)
    assert seen and all(v[1:] == (8, 32, 32) and a[1:3] == (26, 32)
                        for v, a in seen)
    assert result["verdict"] in ("real", "fake", "uncertain")
    assert 0.0 <= result["confidence"] <= 1.0
    default = Predictor(config=config, engine=eng, device="cpu")
    assert default.model_config == AVHubertConfig()
    from lipsync_tpu_torch.models import ModelConfig

    with pytest.raises(ValueError, match="AVHubertConfig"):
        Predictor(config=config, model_config=ModelConfig(), engine=eng,
                  device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        Predictor(config=PredictorConfig(), model_config=cfg, engine=eng,
                  device="cpu")
