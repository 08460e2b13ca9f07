"""The engine on a CUDA card at the model's published widths: its pinned
staging and per-group read-back (logits bit-equal to the plain blocking
upload for bf16 and int8, the caller's arrays free to reuse once a
dispatch returns, concurrent callers each given their own logits, the
copies running beside the forward, every byte of a bulk call staged);
the requests R1-R3 served with the kernels against the same requests with
their twins; its streaming and upload options; and the single-card options
of ``Settings`` (shared encoding, the fold, int8), each with the kernels it
launches and its bound.

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_engine_card.py --noconftest -m card
"""

import threading
import types

import numpy as np
import pytest
import torch

import torch_card
from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
from lipsync_tpu_torch.inference.predictor import Predictor
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.serving.config import Settings
from lipsync_tpu_torch.utils import profiling
from torch_card import card, main_path_inputs  # noqa: F401
from torch_card import launched, launches, serve, track_inputs

# Every K1 and K2 input of this file's runs is one the kernel tests hold.
pytestmark = pytest.mark.usefixtures("main_path_inputs")


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return LipSyncModel(ModelConfig()).state_dict()


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def engine(request, card, weights):
    eng = ScoringEngine(weights, ModelConfig(), device=card,
                        quantized_int8=request.param)
    yield eng
    del eng
    torch.cuda.empty_cache()


def windows(n, seed):
    """``n`` windows: uint8 crops darkened per window, dB log-mel."""
    cfg = ModelConfig()
    rng = np.random.RandomState(seed)
    shape = (n, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3)
    level = rng.randint(64, 257, (n, 1, 1, 1, 1))
    visual = (rng.randint(0, 256, shape) * level // 256).astype(np.uint8)
    mel = (-80 * rng.rand(n, cfg.mel_bins, cfg.audio_frames)).astype(
        np.float32)
    return visual, mel


def plain(engine, monkeypatch):
    """``engine`` with every upload a plain blocking ``.to(device)``."""
    monkeypatch.setattr(engine, "_ring", lambda dev: None)
    return engine


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 7, 256, 1031])
def test_staged_logits_equal_the_plain_upload(engine, monkeypatch, n):
    """Groups of 1, 7 and 256 windows and a call of 1,031 (four groups of
    256 and a ragged seven) score bit for bit as with blocking uploads."""
    visual, mel = windows(n, n)
    staged = engine.score_logits(visual, mel)
    with monkeypatch.context() as m:
        want = plain(engine, m).score_logits(visual, mel)
    np.testing.assert_array_equal(staged, want)


@pytest.mark.card
def test_staged_track_logits_equal_the_plain_upload(engine, monkeypatch):
    """The track path (the crops, then each shard's starts and mel, each
    through a slot of the ring) scores bit for bit as with blocking
    uploads, over three groups of 16 windows."""
    visual, mel = windows(48, 3)
    crops = visual.reshape(-1, *visual.shape[2:])[:200]
    starts = list(range(0, 200 - ModelConfig().video_frames, 4))[:48]
    monkeypatch.setattr(engine, "max_batch", 16)
    staged = engine.score_track_logits(crops, starts, mel)
    with monkeypatch.context() as m:
        want = plain(engine, m).score_track_logits(crops, starts, mel)
    np.testing.assert_array_equal(staged, want)


@pytest.mark.card
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_two_shards_on_one_card_equal_the_plain_upload(card, weights,
                                                       monkeypatch, int8):
    """A mesh of two shards on the card (under int8 in lockstep threads,
    each staging through the device's ring) scores windows and a track
    with shared encoding bit for bit as with blocking uploads."""
    eng = ScoringEngine(weights, ModelConfig(), mesh=[card, card],
                        quantized_int8=int8, shared_visual_encoding=True,
                        max_batch=32)
    visual, mel = windows(70, 4)
    crops = visual.reshape(-1, *visual.shape[2:])[:120]
    starts = list(range(0, 120 - ModelConfig().video_frames, 2))[:40]
    staged = (eng.score_logits(visual, mel),
              eng.score_track_logits(crops, starts, mel[:40]))
    with monkeypatch.context() as m:
        plain(eng, m)
        want = (eng.score_logits(visual, mel),
                eng.score_track_logits(crops, starts, mel[:40]))
    for s, w in zip(staged, want):
        np.testing.assert_array_equal(s, w)
    del eng
    torch.cuda.empty_cache()


@pytest.mark.card
def test_predictor_streams_through_read_back(engine):
    """The predictor's double-buffered window stream reads each group back
    through the engine and gives ``score_probs``' probabilities."""
    from lipsync_tpu_torch.inference.predictor import Predictor

    visual, mel = windows(300, 5)
    host = types.SimpleNamespace(engine=engine, _score_windows=None)
    got = Predictor._score_window_iter(host, zip(visual, mel))
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  engine.score_probs(visual, mel))


@pytest.mark.card
def test_callers_arrays_are_free_once_dispatch_returns(engine):
    """Overwriting the arrays right after ``dispatch_logits`` returns
    leaves the group's logits as they were."""
    visual, mel = windows(256, 1)
    want = engine.score_logits(visual, mel)
    logits = engine.dispatch_logits(visual, mel)
    visual[:] = 0
    mel[:] = 0.0
    np.testing.assert_array_equal(engine.read_back(logits, 256), want)


@pytest.mark.card
def test_concurrent_callers_get_their_own_logits(engine):
    """Four threads, two through ``score_logits`` and two through
    ``dispatch_logits``, at once and three times each: each gets the
    logits of its own windows."""
    inputs = [windows(n, 10 + i) for i, n in enumerate((300, 64, 256, 9))]
    want = [engine.score_logits(v, a) for v, a in inputs]
    got = [[] for _ in inputs]
    errors = []

    def caller(i):
        v, a = inputs[i]
        try:
            for _ in range(3):
                if i % 2:
                    got[i].append(engine.read_back(
                        engine.dispatch_logits(v, a), len(v)))
                else:
                    got[i].append(engine.score_logits(v, a))
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for mine, w in zip(got, want):
        assert len(mine) == 3
        for g in mine:
            np.testing.assert_array_equal(g, w)


@pytest.mark.card
def test_copies_overlap_the_forward_and_all_bytes_are_staged(engine):
    """Under ``torch.profiler`` a call of 1,024 windows runs at least one
    host-to-device copy while a kernel runs, and every byte it uploads
    goes through the pinned ring."""
    from torch.profiler import ProfilerActivity, profile

    visual, mel = windows(1024, 2)
    engine.score_logits(visual, mel)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.score_logits(visual, mel)
        torch.cuda.synchronize()
    counters = profiling.counters()
    profiling.clear()
    assert counters["engine.upload_staged_bytes"] == \
        counters["engine.upload_bytes"] > 0
    copies, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if "Memcpy HtoD" in e.name():
            copies.append(iv)
        elif "Memcpy" not in e.name() and "Memset" not in e.name():
            kernels.append(iv)
    assert copies and kernels
    assert any(s < kt and ks < t for s, t in copies for ks, kt in kernels)


# ── the requests R1-R3 on seeded and BatchNorm-calibrated weights ────────

@pytest.fixture(scope="module")
def weight_sets(card):
    return torch_card.weight_sets(ModelConfig(), card)


@pytest.fixture(scope="module")
def requests(card):
    return torch_card.requests()


@pytest.fixture(scope="module")
def engines(card, weight_sets):
    """(bf16, fp32) engines on each set of weights."""
    yield {name: (ScoringEngine(w, ModelConfig(), device=card),
                  ScoringEngine(w, ModelConfig(), use_bfloat16=False,
                                device=card))
           for name, w in weight_sets.items()}
    torch.cuda.empty_cache()


NO_LAUNCH = {name: 0 for name in torch_card.KERNELS}


@pytest.mark.card
@pytest.mark.parametrize("weights", ["seeded", "bn_calibrated"])
@pytest.mark.parametrize("name", ["R1", "R2", "R3"])
def test_requests_with_the_kernels_match_their_twins(engines, requests,
                                                     monkeypatch, weights,
                                                     name):
    """Each request as a user's runs (crop, log-mel on K1, align, the
    engine with K2 inside): the bf16 engine launches K1 and K2; the fp32
    engine's logits lie within 1e-3 of the same request with every
    kernel's twin in its place, and the bf16 probabilities within 4e-3 of
    fp32's."""
    e16, e32 = engines[weights]
    req = requests[name]
    before = launches()
    probs16 = serve(e16, *req)
    n = launched(before)
    assert n["log_mel"] >= 1 and n["hf_stem"] >= 1
    logits32 = serve(e32, *req, probs=False)
    with monkeypatch.context() as m:
        torch_card.plain_kernels(m)
        before = launches()
        logits_plain = serve(e32, *req, probs=False)
        assert launched(before) == NO_LAUNCH
    assert probs16.shape == logits32.shape == logits_plain.shape
    assert np.isfinite(probs16).all() and np.isfinite(logits32).all()
    assert np.abs(logits32 - logits_plain).max() <= 1e-3
    assert np.abs(probs16 - e32.calibrator(logits32)).max() <= 4e-3


@pytest.mark.card
def test_calibrated_logits_spread(engines, requests):
    """The bf16 bound says little on logits that barely vary: on the
    calibrated weights R1-R3's fp32 logits spread (std >= 0.1)."""
    e32 = engines["bn_calibrated"][1]
    logits = np.concatenate([serve(e32, *req, probs=False)
                             for req in requests.values()])
    assert logits.std() >= 0.1


def r2_track(requests, device):
    crops, audio = track_inputs(ModelConfig(), requests["R2"], device)
    starts = list(range(0, len(crops) - ModelConfig().video_frames + 1,
                        torch_card.STRIDE))
    return crops, starts, audio


@pytest.mark.card
def test_groups_in_flight_give_the_same_logits(card, weight_sets, engines,
                                               requests):
    """R2 in fp32 streamed in groups of 4 windows, one and two groups in
    flight: equal logits, within 1e-3 of the one-group engine's."""
    crops, starts, audio = r2_track(requests, card)
    logits = [ScoringEngine(weight_sets["bn_calibrated"], ModelConfig(),
                            use_bfloat16=False, max_batch=4,
                            max_in_flight=k, device=card)
              .score_track_logits(crops, starts, audio) for k in (1, 2)]
    np.testing.assert_array_equal(logits[0], logits[1])
    one_group = engines["bn_calibrated"][1].score_track_logits(crops, starts,
                                                               audio)
    assert np.abs(logits[1] - one_group).max() <= 1e-3


@pytest.mark.card
def test_windows_off_the_uint8_grid_upload_unrounded(card, weight_sets,
                                                     engines, requests):
    """R2's windows a third of a uint8 step off the grid, uploaded
    unrounded (``transfer_uint8=False``), score as the model does on those
    fp32 windows (1e-5) and otherwise than the rounded default; uint8
    windows score alike in both."""
    cfg = ModelConfig()
    crops, starts, audio = r2_track(requests, card)
    windows = np.clip(np.stack([crops[s: s + cfg.video_frames]
                                for s in starts]) + 0.3 / 255.0, 0.0, 1.0)
    windows = windows.astype(np.float32)
    eng32 = engines["bn_calibrated"][1]
    raw_eng = ScoringEngine(weight_sets["bn_calibrated"], cfg,
                            use_bfloat16=False, transfer_uint8=False,
                            device=card)
    raw = raw_eng.score_logits(windows, audio)
    bucket = 1 << (len(windows) - 1).bit_length()

    def padded(x):
        return np.concatenate([x, np.repeat(x[-1:], bucket - len(x), 0)])

    with torch.inference_mode():
        direct = raw_eng.model(
            torch.from_numpy(padded(windows)).to(card),
            torch.from_numpy(padded(audio)[..., None]).to(card)
        )[: len(windows)].cpu().numpy()
    assert np.abs(raw - direct).max() <= 1e-5
    assert np.abs(raw - eng32.score_logits(windows, audio)).max() > 0
    u8 = np.clip(windows * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(raw_eng.score_logits(u8, audio),
                                  eng32.score_logits(u8, audio))


# ── the single-card options of ``Settings`` ──────────────────────────────

OPTIONS = {"default": {}, "shared": {"shared_visual_encoding": True},
           "fold": {"fold_hf_stem": True}, "int8": {"quantized_int8": True}}


def forwards_of(engine):
    """Forwards of ``engine``'s model, counted at the audio encoder, which
    every forward runs once (the shared path calls the model's
    ``encode_visual`` and ``score_encoded``, not ``forward``)."""
    n = [0]
    engine.model.audio_encoder.register_forward_pre_hook(
        lambda *_: n.__setitem__(0, n[0] + 1))
    return n


@pytest.fixture(scope="module")
def option_runs(card, weight_sets, requests, tmp_path_factory):
    """Each option as ``Settings(option)`` serves it on the calibrated
    weights: a bf16 ``Predictor`` and an fp32 one over ``load_engine``'s
    engine, each on clips S and L, and the fp32 engine on R1-R3. Returns
    the runs' launches and forwards, the predictions, the fp32 logits and
    the fp32 engines."""
    cfg = ModelConfig()
    model_path = tmp_path_factory.mktemp("options") / "calibrated.pth"
    torch.save({k: v.detach().cpu()
                for k, v in weight_sets["bn_calibrated"].items()}, model_path)
    _, memory, boxes, paths = torch_card.clip_set()
    preds, engs, n_fwd = {}, {}, {}
    for name, opt in OPTIONS.items():
        settings = Settings(model_path=model_path, **opt)
        preds[name, "bf16"] = Predictor(
            model_path=settings.model_path,
            config=settings.to_predictor_config(), model_config=cfg,
            detector_backend=boxes, device=card)
        engs[name] = load_engine(model_path, cfg, use_bfloat16=False,
                                 device=card, **opt)
        preds[name, "fp32"] = Predictor(
            config=settings.to_predictor_config(), model_config=cfg,
            engine=engs[name], detector_backend=boxes, device=card)
        for dtype in ("bf16", "fp32"):
            n_fwd[name, dtype] = forwards_of(preds[name, dtype].engine)
    rows, results, logits = {}, {}, {}
    with pytest.MonkeyPatch.context() as m:
        memory.install(m)
        for (name, dtype), pred in preds.items():
            for clip in ("S", "L"):
                f0, before = n_fwd[name, dtype][0], launches()
                results[name, dtype, clip] = pred.predict(paths[clip])
                rows[name, dtype, clip] = (launched(before),
                                           n_fwd[name, dtype][0] - f0)
        for name in OPTIONS:
            for rname, req in requests.items():
                f0, before = n_fwd[name, "fp32"][0], launches()
                logits[name, rname] = serve(engs[name], *req, probs=False)
                rows[name, "fp32", rname] = (launched(before),
                                             n_fwd[name, "fp32"][0] - f0)
    yield rows, results, logits, engs
    del preds, engs
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("option", list(OPTIONS))
def test_each_option_launches_its_kernels(option_runs, option):
    """K1 in every run; K2 in every run but the fold's, none under the
    fold; K3 and K4 only in the int8 runs, once each per int8 convolution
    of a forward (24 of them)."""
    rows, _, _, engs = option_runs
    int8_convs = sum(isinstance(m, layers_mod.ConvBNAct)
                     and m.lowering == "int8"
                     for m in engs["int8"].model.modules())
    assert int8_convs == 24
    for (name, dtype, run), (n, f) in rows.items():
        if name != option:
            continue
        assert f >= 1 and n["log_mel"] >= 1, (dtype, run, n)
        assert (n["hf_stem"] == 0) == (name == "fold"), (dtype, run, n)
        per_forward = int8_convs * f if name == "int8" else 0
        assert n["int8_conv"] == n["int8_quant"] == per_forward, (dtype, run)


@pytest.mark.card
def test_shared_encoding_scores_a_window_as_the_default(card, option_runs,
                                                        engines, requests):
    """Shared encoding: L's window probabilities finite in bf16 and fp32,
    and a one-window track within 1e-5 of the per-window engine in
    fp32."""
    _, results, _, engs = option_runs
    for dtype in ("bf16", "fp32"):
        probs = torch_card.window_probs(results["shared", dtype, "L"])
        assert np.isfinite(probs).all()
    crops, audio = track_inputs(ModelConfig(), requests["R2"], card)
    frames = crops[: ModelConfig().video_frames]
    one = engs["shared"].score_track_logits(frames, [0], audio[:1])
    want = engines["bn_calibrated"][1].score_track_logits(frames, [0],
                                                          audio[:1])
    assert np.abs(one - want).max() <= 1e-5


@pytest.fixture(scope="module")
def seeded_options(card, weight_sets):
    """fp32 engines on the seeded weights with the fold and with int8."""
    yield {opt: ScoringEngine(weight_sets["seeded"], ModelConfig(),
                              use_bfloat16=False, device=card, **{opt: True})
           for opt in ("fold_hf_stem", "quantized_int8")}
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("name", ["R1", "R2", "R3"])
def test_fold_and_int8_on_seeded_weights(engines, seeded_options, requests,
                                         name):
    """On the seeded weights in fp32, against the default engine: the fold
    within 1e-3 in probability (the JAX package's bound), int8 within
    5e-3."""
    want = serve(engines["seeded"][1], *requests[name])
    fold = serve(seeded_options["fold_hf_stem"], *requests[name])
    int8 = serve(seeded_options["quantized_int8"], *requests[name])
    assert np.abs(fold - want).max() <= 1e-3
    assert np.abs(int8 - want).max() <= 5e-3


@pytest.mark.card
@pytest.mark.parametrize("name", ["R1", "R2", "R3"])
def test_int8_kernels_match_their_twins(option_runs, requests, monkeypatch,
                                        name):
    """The int8 fp32 engine's logits within 1e-4 of the same run with K3's
    and K4's twins in their places, which launch neither."""
    _, _, logits, engs = option_runs
    with monkeypatch.context() as m:
        torch_card.plain_int8(m)
        before = launches()
        twin = serve(engs["int8"], *requests[name], probs=False)
        n = launched(before)
    assert n["int8_conv"] == n["int8_quant"] == 0
    assert np.abs(logits["int8", name] - twin).max() <= 1e-4


# ── two shards on the one card against one device ────────────────────────

def one_and_two_shards(card, weight_sets, **kw):
    """fp32 engines on the calibrated weights: one device, and ``[card,
    card]``."""
    w = weight_sets["bn_calibrated"]
    return (ScoringEngine(w, ModelConfig(), use_bfloat16=False, device=card,
                          **kw),
            ScoringEngine(w, ModelConfig(), use_bfloat16=False,
                          mesh=[card, card], **kw))


def sigmoid(x):
    return 1 / (1 + np.exp(-np.asarray(x, np.float64)))


@pytest.mark.card
@pytest.mark.parametrize("shared", [False, True], ids=["default", "shared"])
def test_two_shards_score_tracks_as_one_device(card, weight_sets, requests,
                                               shared):
    """R2's and R3's tracks over two shards: by default within 2e-5 in
    probability of one device, K2 launched once per shard, and a ragged
    bucket of 5 windows alike; with shared encoding (frame shards with a
    halo) within 1e-4 in logit."""
    cfg = ModelConfig()
    single, sharded = one_and_two_shards(card, weight_sets,
                                         shared_visual_encoding=shared)
    for name in ("R2", "R3"):
        crops, audio = track_inputs(cfg, requests[name], card)
        starts = list(range(0, len(crops) - cfg.video_frames + 1,
                            torch_card.STRIDE))
        want = single.score_track_logits(crops, starts, audio)
        before = launches()
        got = sharded.score_track_logits(crops, starts, audio)
        if shared:
            assert np.abs(got - want).max() <= 1e-4
            continue
        assert launched(before)["hf_stem"] == 2
        assert np.abs(sigmoid(got) - sigmoid(want)).max() <= 2e-5
    if not shared:
        windows = np.stack([crops[s: s + cfg.video_frames]
                            for s in starts[:5]])
        got = sharded.score_logits(windows, audio[:5])
        want = single.score_logits(windows, audio[:5])
        assert np.abs(sigmoid(got) - sigmoid(want)).max() <= 2e-5


@pytest.mark.card
def test_two_int8_shards_in_lockstep_score_as_one_device(card, weight_sets,
                                                         requests,
                                                         monkeypatch):
    """int8 over two shards, which reduce each activation scale in
    lockstep and take K4's two launches: 1 and 32 of R3's windows within
    1e-5 in logit of one device, the stem's scale on both shards the one
    device's, K3 24 and K4 48 times per shard."""
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.parallel import mesh as mesh_lib

    cfg = ModelConfig()
    single, sharded = one_and_two_shards(card, weight_sets,
                                         quantized_int8=True)
    scales = []
    real_max, real_fused = mesh_lib.all_max, layers_mod.absmax_quantize

    def shard_max(value):  # a shard: the scale of the max over both shards
        result = real_max(value)
        scales.append(float(torch.clamp(result * k4.INV_127, min=1e-12)))
        return result

    def one_device(x, w_scale=None):  # K4's single launch
        result = real_fused(x, w_scale)
        scales.append(float(result[1]))
        return result

    monkeypatch.setattr(mesh_lib, "all_max", shard_max)
    monkeypatch.setattr(layers_mod, "absmax_quantize", one_device)
    crops, audio = track_inputs(cfg, requests["R3"], card)
    windows = np.stack([crops[s: s + cfg.video_frames]
                        for s in range(0, 32 * torch_card.STRIDE,
                                       torch_card.STRIDE)])
    for n in (1, 32):
        scales.clear()
        want = single.score_logits(windows[:n], audio[:n])
        stem_scale = scales[0]
        scales.clear()
        before = launches()
        got = sharded.score_logits(windows[:n], audio[:n])
        counts = launched(before)
        assert counts["int8_conv"] == 2 * 24
        assert counts["int8_quant"] == 2 * 48
        assert scales[:2] == [stem_scale] * 2
        assert np.abs(got - want).max() <= 1e-5
