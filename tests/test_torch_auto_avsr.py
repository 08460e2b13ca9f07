"""Auto-AVSR's audio-visual conformer as the port's third detector
(``models/auto_avsr.py``) against its plain reference
(``benchmark/reference/auto_avsr.py``) on seeded weights at a small size,
and through ``ScoringEngine`` and ``Predictor.predict``.

The small configuration keeps the ResNets at their fixed widths and the
depthwise kernel of 31, with 2 conformer blocks an encoder of width 64, 4
heads, FFN 128, a fusion of 128, 8 frames (5,120 PCM samples) and 32-pixel
crops.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.models.auto_avsr import (
    PCM_HOP,
    SAMPLES_PER_FRAME,
    AutoAVSR,
    AutoAVSRConfig,
    frame_pcm,
    normalise_pcm,
    rel_positions,
    rel_shift,
)
from lipsync_tpu_torch.models.avhubert import grey_pixels
from lipsync_tpu_torch.models.bridge import seeded_state_dict
from lipsync_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import auto_avsr as ref  # noqa: E402
from benchmark.reference.model import Run, fp32_precision  # noqa: E402

torch.set_num_threads(1)

SMALL = AutoAVSRConfig(video_frames=8, crop_size=32, audio_frames=32,
                       adim=64, aheads=4, eunits=128, elayers=2,
                       fusion_hdim=128)
BF16 = {p: {"act": "bf16", "math": "bf16"} for p in ref.PARTS}
# The bf16 port against the reference rounding where bf16 rounds: what
# differs is the order of the fp32 sums (oneDNN's algorithms, the matmuls'
# tiles) and so which way a few stored values round. The logits are bf16
# (an ulp is 2^-7 in [1, 2)). Over 16 windows of each of seeds 0-5, one
# thread: the port's mean gap 2.0e-3 to 4.4e-3 and widest 7.8e-3 (one
# ulp) on every seed; with int8 in the conformers, fusion and head alone
# (the reference's ``tokens`` part), mean 1.22e-2 to 1.66e-2 and widest
# 2.34e-2 to 3.13e-2.
BF16_MEAN_GAP = 8e-3
BF16_MAX_GAP = 1.6e-2


def cfg_dict(cfg=SMALL):
    return dataclasses.asdict(cfg)


def inputs(seed, n=3, cfg=SMALL):
    """``n`` uint8 grey windows and their PCM (noise at a level of its own
    per window)."""
    g = torch.Generator().manual_seed(seed)
    visual = torch.randint(0, 256, (n, cfg.video_frames, cfg.crop_size,
                                    cfg.crop_size), generator=g,
                           dtype=torch.uint8)
    level = 0.02 + 0.28 * torch.rand(n, 1, 1, generator=g)
    pcm = torch.randn(n, 1, cfg.video_frames * SAMPLES_PER_FRAME,
                      generator=g) * level
    return visual, pcm


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(AutoAVSR(SMALL), 3)


def model(sd, cfg=SMALL, dtype=torch.float32):
    m = AutoAVSR(cfg, dtype=dtype)
    m.load_state_dict(sd, strict=True)
    return m.eval()


def test_param_table_is_the_models():
    """The reference's table is the port's state dict, by name and shape,
    and at the published widths the encoder pair, front ends and fusion
    hold ~376 M parameters."""
    sd = AutoAVSR(SMALL).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        ref.param_shapes(cfg_dict())
    with torch.device("meta"):
        large = AutoAVSR().state_dict()
    shapes = ref.param_shapes(cfg_dict(AutoAVSRConfig()))
    assert {k: tuple(v.shape) for k, v in large.items()} == shapes
    n = sum(math.prod(s) for s in shapes.values())
    assert 3.75e8 < n < 3.77e8
    for name in ("encoder.frontend.frontend3D.0.weight",
                 "encoder.encoders.3.self_attn.linear_pos.weight",
                 "encoder.encoders.11.self_attn.pos_bias_u",
                 "aux_encoder.frontend.trunk.conv1.weight",
                 "aux_encoder.encoders.0.conv_module.depthwise_conv.weight",
                 "fusion.fc1.weight", "fusion.bn1.running_var",
                 "head.weight"):
        assert name in shapes, name
    assert shapes["encoder.encoders.0.conv_module.depthwise_conv.weight"] \
        == (768, 1, 31)


@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_logits_are_the_references(weights, seed):
    """fp32 on both sides: the same operations, summed in another order
    (oneDNN's convolution algorithms, the linear maps as matmuls), so the
    logits (of order 1) agree to a few fp32 ulps through both ResNets and
    the two encoders; 1e-5 leaves room for that and for nothing else."""
    visual, pcm = inputs(seed)
    v = visual.float() / 255
    with torch.no_grad():
        got = model(weights)(v, pcm)
    want = ref.forward(weights, cfg_dict(), v, pcm, Run(fp32_precision()))
    assert got.dtype == torch.float32 and got.shape == (3,)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_logits_are_the_references(weights, seed):
    """bf16 against the reference rounding at the same points, over 16
    windows: the mean and the widest gap within ``BF16_MEAN_GAP`` and
    ``BF16_MAX_GAP``, which int8 in the conformers exceeds."""
    visual, pcm = inputs(seed, n=16)
    v = visual.float() / 255
    with torch.no_grad():
        got = model(weights, dtype=torch.bfloat16)(v, pcm)
    want = ref.forward(weights, cfg_dict(), v, pcm, Run(BF16))
    tokens_int8 = dict(BF16, tokens={"act": "bf16", "math": "int8"})
    low = ref.forward(weights, cfg_dict(), v, pcm, Run(tokens_int8))
    gap, low_gap = (got - want).abs(), (low - want).abs()
    assert gap.mean() <= BF16_MEAN_GAP < low_gap.mean()
    assert gap.max() <= BF16_MAX_GAP < low_gap.max()


@pytest.mark.parametrize("t", [5, 8], ids=["odd", "even"])
def test_relative_position_term_is_a_gather_by_offset(t):
    """``rel_shift`` (a strided view) takes for query i and key j the
    product with the table row of relative position ``i - j``, as a direct
    gather by ``i - j`` does, at odd and even T; the table's row r is
    position ``T - 1 - r`` with sines on even features and cosines on odd
    ones, the reference's table."""
    d = 6
    table = rel_positions(t, d)
    assert table.shape == (2 * t - 1, d)
    torch.testing.assert_close(table, ref.rel_table(t, d))
    for r in (0, t - 1, 2 * t - 2):
        p = t - 1 - r
        w = 10000.0 ** (-torch.arange(0, d, 2) / d)
        torch.testing.assert_close(table[r, 0::2], torch.sin(p * w))
        torch.testing.assert_close(table[r, 1::2], torch.cos(p * w))
    g = torch.Generator().manual_seed(t)
    q = torch.randn(2, 3, t, d, generator=g)
    scores = q @ table.T  # (2, 3, T, 2T - 1)
    got = rel_shift(scores)
    want = torch.empty(2, 3, t, t)
    for i in range(t):
        for j in range(t):
            want[..., i, j] = q[..., i, :] @ table[t - 1 - (i - j)]
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(ref.rel_term(scores), want)
    assert got.data_ptr() == scores.data_ptr() + (t - 1) * 4  # a view
    with pytest.raises(ValueError):
        rel_shift(torch.zeros(t, 2 * t))


def block_input(seed, cfg=SMALL, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, cfg.video_frames, cfg.adim, generator=g)


def test_macaron_half_steps(weights):
    """A conformer block with its attention and convolution modules made
    the identity's residual (zero output): ``norm_final(y + FFN(LN y) /
    2)`` with ``y = x + FFN_mac(LN x) / 2``, each FFN ``w_2(ReLU(w_1 x))``
    and each LayerNorm ESPnet's (eps 1e-12)."""
    m = model(weights)
    layer = m.encoder.encoders[0]
    pos = rel_positions(SMALL.video_frames, SMALL.adim)
    x = block_input(4)
    with torch.no_grad():
        layer.self_attn.linear_out.weight.zero_()
        layer.self_attn.linear_out.bias.zero_()
        layer.conv_module.pointwise_cov2.weight.zero_()
        layer.conv_module.pointwise_cov2.bias.zero_()
        got = layer(x, pos)

        def ln(mod, v):
            return F.layer_norm(v, (SMALL.adim,), mod.weight, mod.bias, 1e-12)

        def ffn(mod, v):
            return mod.w_2(F.relu(mod.w_1(v)))

        y = x + 0.5 * ffn(layer.feed_forward_macaron,
                          ln(layer.norm_ff_macaron, x))
        y = y + 0.5 * ffn(layer.feed_forward, ln(layer.norm_ff, y))
        want = ln(layer.norm_final, y)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert layer.norm_ff.eps == 1e-12


def test_convolution_module(weights):
    """The convolution module alone: pointwise Conv1d to twice the width,
    GLU (first half times the sigmoid of the second), depthwise Conv1d of
    kernel 31 padded 15 (the same length out), eval BatchNorm1d, Swish,
    pointwise Conv1d, as ``nn.Conv1d`` modules on ``(B, C, T)`` compute
    it."""
    conv = model(weights).encoder.encoders[1].conv_module
    assert conv.depthwise_conv.kernel_size == (31,)
    assert conv.depthwise_conv.groups == SMALL.adim
    x = block_input(5)
    with torch.no_grad():
        got = conv(x)
        y = conv.pointwise_cov1(x.transpose(1, 2))
        a, b = y.chunk(2, dim=1)
        y = conv.depthwise_conv(a * torch.sigmoid(b))
        assert y.shape[-1] == SMALL.video_frames
        y = conv.norm(y)
        want = conv.pointwise_cov2(y * torch.sigmoid(y)).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("frames", [1, 8, 96])
def test_pcm_trim_and_pool(frames):
    """640 T samples give T frames: Conv1d k80 s4 p38 to 160 T, strides 2,
    2, 2 to 20 T, ``AvgPool1d(21, 20, 1)`` to T; more samples than that
    are trimmed after the normalisation over the window, as Conv1dResNet
    trims."""
    trunk = AutoAVSR(SMALL).aux_encoder.frontend.eval()
    n = frames * SAMPLES_PER_FRAME
    g = torch.Generator().manual_seed(frames)
    pcm = torch.randn(2, 1, n + 300, generator=g) * 0.1
    x = normalise_pcm(pcm, frames)
    assert x.shape == (2, 1, n)
    full = (pcm - pcm.mean(-1, keepdim=True)) / torch.sqrt(
        pcm.var(-1, unbiased=False, keepdim=True) + 1e-8)
    torch.testing.assert_close(x, full[..., :n], rtol=0, atol=1e-5)
    with torch.no_grad():
        assert trunk(x).shape == (2, frames, 512)
    with pytest.raises(ValueError):
        normalise_pcm(pcm[..., :n - 1], frames)


def test_framed_pcm_is_the_mels_columns():
    """``frame_pcm``: as many 160-sample columns as the centred log-mel
    has frames (``1 + len // 160``), column c the samples from ``160 c``,
    padded like the mel; the model's ``host_audio`` lays a window of such
    columns end to end as ``(N, 1, S)`` PCM and takes PCM as it is."""
    pcm = np.arange(1000, dtype=np.float32)
    framed = frame_pcm(pcm)
    assert framed.shape == (PCM_HOP, 1 + 1000 // PCM_HOP)
    assert framed[:, 2].tolist() == list(range(320, 480))
    assert framed[40:, -1].tolist() == [0.0] * 120  # past the end
    padded = frame_pcm(pcm, 10)
    assert padded.shape == (PCM_HOP, 10)
    assert (padded[:, 7:] == padded[:, 6:7]).all()
    assert frame_pcm(pcm, 3).tolist() == framed[:, :3].tolist()
    window = np.stack([framed[:, 1:5], framed[:, 2:6]])
    laid = AutoAVSR.host_audio(window)
    assert laid.shape == (2, 1, 640)
    assert laid[1, 0].tolist() == list(range(320, 960))
    assert (AutoAVSR.host_audio(window[..., None]) == laid).all()
    assert AutoAVSR.host_audio(laid) is laid
    with pytest.raises(ValueError):
        AutoAVSR.host_audio(np.zeros((2, 80, 4), np.float32))


def test_state_dict_round_trip(weights):
    """``state_dict`` out of one model loads into another with
    ``strict=True`` and gives the same logits (in bf16 too, the norms kept
    fp32); a missing or extra entry is refused."""
    a = model(weights)
    out = a.state_dict()
    assert set(out) == set(weights)
    b = model(out)
    visual, pcm = inputs(2)
    v = visual.float() / 255
    with torch.no_grad():
        assert torch.equal(a(v, pcm), b(v, pcm))
    bf = model(out, dtype=torch.bfloat16)
    assert bf.encoder.encoders[0].self_attn.pos_bias_u.dtype == torch.bfloat16
    assert bf.encoder.encoders[0].norm_mha.weight.dtype == torch.float32
    assert bf.fusion.bn1.weight.dtype == torch.float32
    with pytest.raises(RuntimeError):
        AutoAVSR(SMALL).load_state_dict(
            {k: v for k, v in weights.items() if "pos_bias_v" not in k})
    with pytest.raises(RuntimeError):
        AutoAVSR(SMALL).load_state_dict(dict(weights, extra=torch.ones(1)))


def test_config_checks_the_audio_frames():
    with pytest.raises(ValueError, match="audio_frames"):
        AutoAVSR(dataclasses.replace(SMALL, audio_frames=33))
    with pytest.raises(ValueError, match="odd"):
        AutoAVSR(dataclasses.replace(SMALL, cnn_module_kernel=30))


def engine(weights, **kw):
    return ScoringEngine(weights, SMALL, use_bfloat16=False, max_batch=4,
                         device="cpu", **kw)


def test_engine_score_logits_is_the_forward(weights):
    """Grey uint8 windows and ``(N, 1, S)`` PCM in groups of ``max_batch``
    (two in flight): the model's own forward on ``/255`` pixels; RGB
    windows are made grey on the host, and framed PCM is laid end to end
    first."""
    visual, pcm = inputs(4, n=6)
    eng = engine(weights)
    got = eng.score_logits(visual.numpy(), pcm.numpy())
    with torch.no_grad():
        want = model(weights)(visual.float() / 255, pcm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rgb = np.repeat(visual.numpy()[..., None], 3, axis=-1)
    framed = pcm.numpy()[:, 0].reshape(6, -1, PCM_HOP).transpose(0, 2, 1)
    np.testing.assert_allclose(eng.score_logits(rgb, framed), got, rtol=0,
                               atol=1e-6)
    eng.warmup()


@pytest.mark.parametrize("shared", [False, True])
def test_engine_track_logits(weights, shared):
    """A grey track's windows gathered on the device: per window, each
    window's forward; with shared encoding, the whole padded track's video
    features gathered per window (interior windows see real neighbours in
    the 3D stem)."""
    t = SMALL.video_frames
    g = torch.Generator().manual_seed(5)
    crops = torch.randint(0, 256, (19, 32, 32), generator=g,
                          dtype=torch.uint8)
    starts = [0, 3, 11]
    _, pcm = inputs(6, n=3)
    eng = engine(weights, shared_visual_encoding=shared)
    got = eng.score_track_logits(crops.numpy(), starts, pcm.numpy())
    m = model(weights)
    idx = torch.tensor(starts)[:, None] + torch.arange(t)
    with torch.no_grad():
        if not shared:
            want = m(crops[idx].float() / 255, pcm)
        else:
            n_pad = t
            while n_pad < 19:
                n_pad *= 2
            track = torch.cat([crops, crops[-1:].expand(n_pad - 19, -1, -1)])
            feat, none = m.encode_visual(track[None].float() / 255)
            assert none is None
            want = m.score_encoded(feat[0][idx], None, None, pcm)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)


def test_engine_refuses_the_flagships_lowerings(weights):
    for kw in ({"quantized_int8": True}, {"fold_hf_stem": True}):
        with pytest.raises(ValueError, match="AutoAVSRConfig"):
            engine(weights, **kw)


def test_spans_and_counters(weights):
    """No profiler session: nothing recorded. Under one, ``auto_avsr.
    video``, ``.video_encoder``, ``.audio``, ``.audio_encoder`` and
    ``.fusion`` open inside ``engine.forward``, in that order, and
    ``auto_avsr.encoder_tokens`` counts the rows dispatched (the bucket)
    times the frames once a forward."""
    visual, pcm = inputs(7, n=4)
    eng = engine(weights)
    profiling.clear()
    eng.score_logits(visual.numpy(), pcm.numpy())
    assert profiling.records() == [] and profiling.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.score_logits(visual.numpy(), pcm.numpy())
    records = profiling.records()
    by_id = {r.id: r for r in records}
    names = ("auto_avsr.video", "auto_avsr.video_encoder", "auto_avsr.audio",
             "auto_avsr.audio_encoder", "auto_avsr.fusion")
    mine = [r for r in records if r.name in names]
    assert [r.name for r in sorted(mine, key=lambda r: r.t0_ns)] == \
        list(names)
    assert all(by_id[r.parent].name == "engine.forward" for r in mine)
    counters = profiling.counters()
    assert counters["auto_avsr.encoder_tokens"] == 4 * SMALL.video_frames
    assert not [k for k in counters if "stem" in k]  # K5 is the card's
    profiling.clear()


def test_predict_runs_auto_avsr(tmp_path, weights):
    """``Predictor.predict`` with ``architecture="auto_avsr"`` on a short
    synthetic clip: the model sees grey ``(B, T, H, W)`` crops and ``(B,
    1, 640 T)`` PCM (the clip's samples, aligned as its log-mel windows
    are), never a log-mel, and the response is whole."""
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.preprocessing import mux
    from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
    from lipsync_tpu_torch.serving.config import Settings
    from tests.fixtures import speechish_pcm, synthetic_frames

    pcm = speechish_pcm(seconds=8 / 15)
    clip = mux.write_video(tmp_path / "short.avi", synthetic_frames(n=8),
                           fps=15.0, pcm=pcm, sample_rate=16000)
    eng = ScoringEngine(weights, SMALL, use_bfloat16=False, device="cpu")
    seen = []
    inner = eng.model.forward

    def spy(visual, audio):
        seen.append((tuple(visual.shape), audio.clone()))
        return inner(visual, audio)

    eng.model.forward = spy
    settings = Settings(architecture="auto_avsr", device="cpu")
    config = settings.to_predictor_config()
    assert config.architecture == "auto_avsr"
    predictor = Predictor(config=config, model_config=SMALL, engine=eng,
                          detector_backend=FakeDetector(
                              lambda i: [(60, 70, 110, 105)]),
                          device="cpu")
    result = predictor.predict(clip)
    assert seen
    for v, audio in seen:
        assert v[1:] == (8, 32, 32)
        assert tuple(audio.shape[1:]) == (1, 8 * SAMPLES_PER_FRAME)
    # The full window's PCM is the clip's samples from 0, as read back
    # from the file (the clip's audio is shorter: its last column repeats).
    from lipsync_tpu_torch.preprocessing import ingest

    read = ingest.read_audio(clip, sr=16000)
    full = seen[0][1][0, 0].numpy()
    n = min(len(read) // PCM_HOP * PCM_HOP, full.size)
    np.testing.assert_array_equal(full[:n], read[:n])
    assert result["verdict"] in ("real", "fake", "uncertain")
    assert 0.0 <= result["confidence"] <= 1.0
    assert "mouth_motion_check" in result
    default = Predictor(config=config, engine=eng, device="cpu")
    assert default.model_config == AutoAVSRConfig()
    from lipsync_tpu_torch.models import ModelConfig

    with pytest.raises(ValueError, match="AutoAVSRConfig"):
        Predictor(config=config, model_config=ModelConfig(), engine=eng,
                  device="cpu")
    with pytest.raises(ValueError, match="architecture"):
        PredictorConfig(architecture="conformer")


def test_grey_crops_from_rgb():
    rgb = np.random.RandomState(0).randint(0, 256, (2, 3, 5, 5, 3), np.uint8)
    np.testing.assert_array_equal(AutoAVSR.host_pixels(rgb),
                                  grey_pixels(rgb))
    grey = rgb[..., 0]
    assert AutoAVSR.host_pixels(grey) is grey
