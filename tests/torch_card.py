"""Shared set-up of the port's card tests (``tests/test_torch_*_card.py``):
the ``card`` fixture, the three requests R1-R3 and how a user's request
runs them, the seeded and BatchNorm-calibrated weights, the kernels' twins
in the kernels' places, clips served from memory, and the references the
tests hold the kernels and the train step against.

This module imports no JAX, so that the card tests run where JAX is absent:

    python -m pytest tests/test_torch_*_card.py --noconftest -m card
"""

from __future__ import annotations

import contextlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.inference.policy import align_audio_chunk
from lipsync_tpu_torch.models import (
    LipSyncModel,
    audio_encoder,
    bn_calibrated_state_dict,
    seeded_state_dict,
    visual_encoder,
)
from lipsync_tpu_torch.models import artifact as artifact_mod
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.ops import mel as mel_ops
from lipsync_tpu_torch.ops.kernels import hf_stem as k2
from lipsync_tpu_torch.ops.kernels import int8_conv as k3
from lipsync_tpu_torch.ops.kernels import int8_quant as k4
from lipsync_tpu_torch.ops.kernels import mel as k1
from lipsync_tpu_torch.preprocessing import audio as audio_mod
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
from lipsync_tpu_torch.utils import synthetic

SEED = 0
STRIDE = 8  # the requests' window stride
KERNELS = {"log_mel": k1, "hf_stem": k2, "int8_conv": k3, "int8_quant": k4}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tf32_off(monkeypatch):
    """fp32 convolutions and matmuls in fp32, as the port's entry points
    set them for the process (PyTorch's default takes TF32 in cuDNN)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def launches() -> dict:
    """Every kernel's launch count, K1 to K4."""
    return {name: k.launches for name, k in KERNELS.items()}


def launched(before: dict) -> dict:
    """The launches of each kernel since ``before`` (:func:`launches`)."""
    torch.cuda.synchronize()
    return {name: n - before[name] for name, n in launches().items()}


# ── the inputs at which the kernel tests hold K1 and K2 ──────────────────

# K1 at its defaults, one clip a call: the requests' PCM buckets (R1's is
# 65536 samples), 128k (tracks of 120 frames: 8 s of PCM) and a clip of a
# minute.
K1_SAMPLES = (16384, 32768, 65536, 1 << 17, 262144, 1 << 20)
K1_DEFAULTS = dict(sr=k1.SR, n_fft=k1.N_FFT, hop_length=k1.HOP,
                   win_length=k1.N_FFT, n_mels=k1.N_MELS, center=True)
# K2 in fp32 and bf16, (B, T, H, W, 3): the main path's buckets of 1, 16
# and 128 windows; an odd, non-square shape with partial output tiles; the
# refinement's half windows of clip S in their bucket of 4 and its halves
# on two shards; the trainers' validation batches of 2, 3 and 6; the
# service's warmup and coalesced buckets (2, 4, 8); the shards' halves (64
# of R3's 128, 8 of R2's 16, 4 of a ragged 8); groups of 32; the engine's
# full group of 256 (the bulk cells' batch); a batch of 1024; and the entry
# points' dry run (4 frames of 32 x 32, a bucket of 4 and its halves).
K2_SHAPES = [(2, 4, 15, 10, 3), (4, 16, 96, 96, 3), (2, 16, 96, 96, 3),
             *((b, 32, 96, 96, 3)
               for b in (1, 2, 3, 4, 6, 8, 16, 32, 64, 128, 256, 1024)),
             (2, 4, 32, 32, 3), (4, 4, 32, 32, 3)]


def unchecked(seen: dict) -> dict:
    """The inputs in ``seen`` (:func:`main_path_inputs`) that
    ``tests/test_torch_kernels_card.py`` does not hold against the twin."""
    k1_held = {((1, n), "float32", tuple(sorted(K1_DEFAULTS.items())))
               for n in K1_SAMPLES}
    k2_held = {(s, dt) for s in K2_SHAPES for dt in ("float32", "bfloat16")}
    return {"log_mel": sorted(seen["log_mel"] - k1_held, key=str),
            "hf_stem": sorted(seen["hf_stem"] - k2_held, key=str)}


@pytest.fixture(scope="module")
def main_path_inputs(card):
    """While a module's tests run, the shape and dtype of every input that
    the main path gives K1 (with its parameters) and K2; at the module's
    end, each must be one at which the kernel tests hold the kernel
    against its twin."""
    seen = {"log_mel": set(), "hf_stem": set()}
    log_mel_db, hf_stem = k1.log_mel_db, artifact_mod.hf_stem
    k1_args = inspect.signature(log_mel_db)

    def k1_call(*args, **kwargs):
        bound = k1_args.bind(*args, **kwargs)
        bound.apply_defaults()
        y, *_ = bound.arguments.values()
        params = {k: v for k, v in bound.arguments.items() if k != "y"}
        seen["log_mel"].add((tuple(y.shape), str(y.dtype)[6:],
                             tuple(sorted(params.items()))))
        return log_mel_db(*args, **kwargs)

    def k2_call(video, *args, **kwargs):
        seen["hf_stem"].add((tuple(video.shape), str(video.dtype)[6:]))
        return hf_stem(video, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(k1, "log_mel_db", k1_call)
        m.setattr(artifact_mod, "hf_stem", k2_call)
        yield seen
    assert seen["log_mel"] and seen["hf_stem"]
    assert not any(unchecked(seen).values()), unchecked(seen)


# ── requests and weights ─────────────────────────────────────────────────

def requests() -> dict:
    """R1 (32 frames of 360x640 + 2.2 s of PCM, one window), R2 (150
    frames, 15 windows) and R3 (600 frames, 72 windows), each with whether
    it is served as a track."""
    return {name: (*req, name != "R1")
            for name, req in synthetic.requests(SEED).items()}


def track_inputs(cfg, req, device):
    """A track request's crops and aligned mel windows, as :func:`serve`
    makes them on ``device``."""
    frames, boxes, y = req[:3]
    crops = crop_track_on_device(frames, boxes, 0, cfg.crop_size,
                                 device=device)
    mel = audio_mod.preprocess_audio_pcm(y, device=device)
    n = len(crops)
    return crops, np.stack([
        align_audio_chunk(mel, s, n, cfg.audio_frames, cfg.video_frames)
        for s in range(0, n - cfg.video_frames + 1, STRIDE)])


def serve(engine, frames, boxes, y, track, probs=True):
    """crop -> log-mel (K1) -> align -> engine (K2 inside), as a user's
    request runs: probabilities, or logits with ``probs=False``."""
    cfg, dev = engine.config, engine.device
    if track:
        crops, audio = track_inputs(cfg, (frames, boxes, y), dev)
        starts = list(range(0, len(crops) - cfg.video_frames + 1, STRIDE))
        fn = engine.score_track_probs if probs else engine.score_track_logits
        return fn(crops, starts, audio)
    crops = crop_track_on_device(frames, boxes, 0, cfg.crop_size, device=dev)
    mel = audio_mod.preprocess_audio_pcm(y, device=dev)
    audio = align_audio_chunk(mel, 0, len(crops), cfg.audio_frames,
                              cfg.video_frames)[None]
    fn = engine.score_probs if probs else engine.score_logits
    return fn(crops[None, : cfg.video_frames], audio)


def weight_sets(cfg, device) -> dict:
    """Two sets of weights from the seed: ``seeded`` as they are (their
    logits barely vary) and ``bn_calibrated``, the same with every
    BatchNorm calibrated on R2's windows (activations near unit scale,
    logits that spread)."""
    seeded = seeded_state_dict(LipSyncModel(cfg), SEED)
    visual, audio = synthetic.track_windows(
        synthetic.requests(SEED)["R2"], cfg.video_frames, cfg.crop_size,
        cfg.audio_frames, STRIDE, device=device)
    return {"seeded": seeded,
            "bn_calibrated": bn_calibrated_state_dict(cfg, seeded, visual,
                                                      audio)}


# ── the twins in the kernels' places ─────────────────────────────────────

def plain_log_mel(y, top_db=80.0, **params):
    """``log_mel_spectrogram_fused`` of one clip with K1's twin in the
    kernel's place."""
    return k1.finish_db(k1.log_mel_db_plain(y[None], **params), top_db)[0]


def plain_int8(m) -> None:
    """The int8 lowering with K3's and K4's twins in the kernels' places,
    set through the monkeypatch ``m``."""
    m.setattr(layers_mod, "int8_conv_dequant", k3.int8_conv_dequant_plain)
    m.setattr(layers_mod, "int8_conv_int32", k3.int8_conv_plain)
    m.setattr(layers_mod, "absmax", k4.absmax_plain)
    m.setattr(layers_mod, "quantize", k4.quantize_plain)
    m.setattr(layers_mod, "absmax_quantize", k4.absmax_quantize_plain)


def plain_kernels(m) -> None:
    """The whole path with every kernel's twin in its place."""
    m.setattr(audio_mod, "log_mel_spectrogram_fused", plain_log_mel)
    m.setattr(artifact_mod, "hf_stem", k2.hf_stem_plain)
    plain_int8(m)


def parent_int8_conv(x, weight, bias, stride, padding):
    """The int8 lowering as the port ran it before K4 and K3's epilogue
    (``models/layers.py::int8_conv`` until then): torch's elementwise chain
    around K3's int32 entry. The yardstick of the whole fused convolution."""
    x32, w32 = x.float(), weight.float()
    w_scale = torch.clamp(
        w32.abs().amax(dim=tuple(range(1, w32.dim()))) * layers_mod._INV_127,
        min=1e-12)
    x_scale = torch.clamp(x32.abs().max() * layers_mod._INV_127, min=1e-12)
    w_q = k4.quantize_int8(w32, w_scale.view(-1, *[1] * (w32.dim() - 1)))
    x_q = k4.quantize_int8(x32, x_scale)
    last = lambda t: t.movedim(1, -1).contiguous()  # noqa: E731
    y = k3.int8_conv_int32(last(x_q), last(w_q), stride, padding)
    out = y.float() * (x_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.movedim(-1, 1).to(x.dtype)


def bits(t):
    """``t``'s bit patterns, so that equality is bit for bit."""
    return t.view({4: torch.int32, 2: torch.int16}.get(t.element_size(),
                                                      t.dtype))


def same_float(a, b) -> bool:
    """``a`` and ``b`` bit for bit, a NaN matching any NaN."""
    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        bits(torch.where(na, 0, a)), bits(torch.where(nb, 0, b))))


def mel_float64(y, sr=16000, n_fft=400, hop_length=160, n_mels=80,
                center=True, **_):
    """The log-mel chain of PCM ``y`` in float64, K1's frames: (centred)
    n_fft-sample Hann frames at the hop, power rFFT, the mel bands, dB to
    the clip's peak floored at -80."""
    pad = n_fft // 2 if center else 0
    yp = np.pad(np.asarray(y, np.float64), (pad, pad))
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop_length]
    power = np.abs(np.fft.rfft(
        frames[: k1.n_frames_for(len(y), n_fft, hop_length, center)]
        * mel_ops.hann_window(n_fft).astype(np.float64), axis=-1)) ** 2
    ref = 10 * np.log10(np.maximum(
        power @ mel_ops.mel_filterbank(sr, n_fft, n_mels).T.astype(
            np.float64), 1e-10)).T
    return np.maximum(ref - ref.max(), -80.0)


# ── clips held in memory ─────────────────────────────────────────────────

class MemoryClips:
    """Readers with the signatures of ``preprocessing/ingest.py`` that
    serve clips held in memory, by path or by the bytes of a file that
    holds a clip's upload token (the HTTP service writes each upload to a
    temporary file and predicts that path); any other path raises
    ``FileNotFoundError``. A card's host may lack the FFmpeg that the
    native ingest builds against; everything from the frames onward is the
    port's."""

    def __init__(self):
        self.clips, self.uploads = {}, {}

    def add(self, name: str, frames, pcm) -> str:
        path = f"/in-memory/{name}.avi"
        self.clips[path] = (frames, pcm)
        self.uploads[self.upload(name)] = path
        return path

    @staticmethod
    def upload(name: str) -> bytes:
        """The bytes a client uploads for clip ``name``."""
        return f"in-memory clip {name}".encode()

    def _get(self, path):
        key = str(path)
        if key not in self.clips and Path(key).is_file():
            key = self.uploads.get(Path(key).read_bytes(), key)
        try:
            return self.clips[key]
        except KeyError:
            raise FileNotFoundError(str(path)) from None

    def probe(self, path):
        frames, _ = self._get(path)
        return ingest.MediaInfo(
            width=frames.shape[2], height=frames.shape[1],
            fps=synthetic.FPS, duration_sec=len(frames) / synthetic.FPS,
            nb_frames=len(frames), has_audio=True, sample_rate=16000)

    def read_video(self, path, target_fps=15.0, max_total_frames=None,
                   out_size=None):
        assert target_fps == synthetic.FPS and out_size is None
        return self._get(path)[0][:max_total_frames].copy()

    def read_audio(self, path, sr=16000):
        assert sr == 16000
        return self._get(path)[1].copy()

    def install(self, m) -> None:
        """Stand in for ``ingest``'s readers through the monkeypatch
        ``m``."""
        for name in ("probe", "read_video", "read_audio"):
            m.setattr(ingest, name, getattr(self, name))


class ClipBoxes:
    """A detector for many clips at once: each known frame's mouth box,
    looked up by a fingerprint of the frame's pixels; other frames have
    none. It keeps no per-video state, so concurrent requests can share
    it."""

    name = "fake"

    def __init__(self):
        self.boxes = {}

    @staticmethod
    def key(frame) -> bytes:
        return frame[::29, ::31].tobytes()

    def add(self, frames, boxes) -> None:
        for f, b in zip(frames, boxes):
            self.boxes[self.key(f)] = tuple(b)
        assert len({self.key(f) for f in frames}) == len(frames)

    def reset(self) -> None:
        pass

    def detect(self, frame):
        from lipsync_tpu_torch.preprocessing.face_detection import Detection

        box = self.boxes.get(self.key(frame))
        return [] if box is None else [Detection(bbox=box, detector="fake")]


def clip_set():
    """Clips S (30 frames + 2.0 s: the short path) and L (150 frames + 10
    s: the long path) in memory, with a detector that knows their boxes:
    ``(clips, memory, boxes, paths)``."""
    rng = np.random.default_rng(SEED)
    clips = {"S": synthetic.request(rng, 30, 2.0),
             "L": synthetic.request(rng, 150, 150 / synthetic.FPS)}
    memory, boxes = MemoryClips(), ClipBoxes()
    paths = {}
    for name, (frames, bx, pcm) in clips.items():
        paths[name] = memory.add(name, frames, pcm)
        boxes.add(frames, bx)
    return clips, memory, boxes, paths


def window_probs(result):
    return np.asarray(result["tracks"][0]["window_confidences"])


# ── one train step on one activation pattern ─────────────────────────────

class SGD1:
    """``torch.optim.SGD(lr=1)`` with the port optimizer's interface: the
    step's parameters minus its gradients."""

    def __init__(self, model):
        self.opt = torch.optim.SGD(model.parameters(), lr=1.0)
        self.param_groups = self.opt.param_groups

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        self.opt.step()


def conv_biases_before_batchnorm(model) -> set:
    """A conv bias in front of a training-mode BatchNorm has a zero
    gradient in exact arithmetic: two runs hold rounding noise there."""
    zero = set()
    for name, mod in model.named_modules():
        kids = list(mod.children()) if isinstance(mod, torch.nn.Sequential) \
            else []
        for i, (a, b) in enumerate(zip(kids, kids[1:])):
            if (isinstance(a, torch.nn.modules.conv._ConvNd)
                    and a.bias is not None
                    and isinstance(b, torch.nn.modules.batchnorm._BatchNorm)):
                zero.add(f"{name}.{i}.bias")
    return zero


@contextlib.contextmanager
def activation_pattern(tape: list, replay: bool, seen: dict, shard=None):
    """Record (``replay`` False) or replay, in call order, every ReLU mask
    and max-pool choice of the port's model and losses. A gradient is
    discontinuous where a ReLU input or two pooled values lie within
    rounding of each other, and two devices or two summation orders may
    take different sides there; replaying one run's pattern in the other
    compares the gradients of the same smooth function. A replaying rank
    (``shard``) takes its block of rows of each recorded choice of the
    model (axis 0 of a global-batch tensor); the losses' ReLUs run on
    gathered global tensors and take the whole. ``seen["flips"]`` counts
    the choices the replaying run would have made otherwise."""
    relu, pool = F.relu, visual_encoder.max_pool_same
    it = iter(tape)
    seen.update(flips=0)

    def rows(rec, x):
        rec = rec.to(x.device)
        if shard is None or rec.shape[0] == x.shape[0]:
            return rec
        b = x.shape[0]
        return rec[shard.rank * b:(shard.rank + 1) * b]

    # A replayed output keeps the memory layout of the op's own output:
    # dropout lays its noise out in memory order, so the layout decides
    # which element draws which number.
    def relu_(x, inplace=False):
        if not replay:
            tape.append(x > 0)
            return relu(x)
        mask = rows(next(it), x)
        seen["flips"] += int(((x > 0) != mask).sum())
        return torch.empty_like(x).copy_(x * mask)

    def pool_(x, window, strides, padding):
        fn = {2: F.max_pool2d, 3: F.max_pool3d}[len(window)]
        out, idx = fn(x, tuple(window), tuple(strides),
                      tuple(p[0] for p in padding), return_indices=True)
        if not replay:
            tape.append(idx)
            return out
        rec = rows(next(it), x)
        seen["flips"] += int((rec != idx).sum())
        return torch.empty_like(out).copy_(
            x.flatten(2).gather(2, rec.flatten(2)).view(rec.shape))

    F.relu = relu_
    visual_encoder.max_pool_same = audio_encoder.max_pool_same = pool_
    try:
        yield
    finally:
        F.relu = relu
        visual_encoder.max_pool_same = audio_encoder.max_pool_same = pool


def step_gaps(ref, other, zero: set) -> dict:
    """``other``'s train step against ``ref``'s, each ``(metrics, grads,
    BatchNorm statistics)``: metrics relative to ``ref``, statistics to
    max(1, their largest), each gradient to its tensor's largest (those in
    ``zero`` apart), and the largest of ``zero``'s gradients on either
    side."""
    return {
        "metric_rel": {k: abs(other[0][k] - v) / max(abs(v), 1e-6)
                       for k, v in ref[0].items()},
        "grad_rel": {n: float((other[1][n] - g).abs().max() / g.abs().max())
                     for n, g in ref[1].items() if n not in zero},
        "stat_rel": max(float((other[2][n] - s).abs().max()
                              / max(1.0, float(s.abs().max())))
                        for n, s in ref[2].items()),
        "zero_max": max(float(side[1][n].abs().max())
                        for side in (ref, other) for n in zero),
    }
