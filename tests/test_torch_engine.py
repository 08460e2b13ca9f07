"""The port's crop, alignment, calibration and scoring engine against the
JAX package (CPU, fp32).

Tolerances: crops atol 1e-5; alignment exact; calibrated probabilities
1e-7; engine logits atol 1e-4.
"""

import itertools
import sys
import threading

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.calibration import Calibrator as JCalibrator
from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.policy import align_audio_chunk as j_align
from lipsync_tpu.preprocessing.video import (
    crop_track_on_device as j_crop_track,
)
from lipsync_tpu_torch.inference.calibration import Calibrator
from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
from lipsync_tpu_torch.inference.staging import StagingRing
from lipsync_tpu_torch.inference.policy import align_audio_chunk
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
from lipsync_tpu_torch.preprocessing.video import _bucket, crop_track_on_device
from lipsync_tpu_torch.utils import profiling, synthetic
from tests.torch_parity import seeded_pair

torch.set_num_threads(1)


def _frames_and_boxes(rng, n=20, h=60, w=80):
    frames = rng.randint(0, 256, (n + 5, h, w, 3)).astype(np.uint8)
    boxes = []
    for _ in range(n):
        x1, y1 = rng.randint(-4, w - 10), rng.randint(-4, h - 10)
        bw, bh = rng.randint(1, 40), rng.randint(1, 30)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    return frames, boxes


@pytest.mark.parametrize("start", [0, 3])
def test_crop_track_on_device_matches_jax(start):
    frames, boxes = _frames_and_boxes(np.random.RandomState(start))
    got = crop_track_on_device(frames, boxes, start, crop_size=24,
                               device="cpu")
    want = j_crop_track(frames, boxes, start, crop_size=24)
    assert got.shape == want.shape == (20, 24, 24, 3)
    print(f"max |delta| crops start={start}: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_crop_bucket_and_empty_track():
    assert [_bucket(n) for n in (1, 32, 33, 100)] == [32, 32, 64, 128]
    out = crop_track_on_device(np.zeros((4, 8, 8, 3), np.uint8), [], 0,
                               crop_size=16, device="cpu")
    assert out.shape == (0, 16, 16, 3)


@pytest.mark.parametrize("reference_slice", [False, True])
@pytest.mark.parametrize("v_start,total_v", [(0, 150), (64, 150), (140, 150),
                                             (0, 20), (9, 12)])
def test_align_audio_chunk_matches_jax(reference_slice, v_start, total_v):
    mel = np.random.RandomState(v_start).randn(80, 1 + total_v * 100 // 15)
    got = align_audio_chunk(mel, v_start, total_v,
                            reference_slice=reference_slice)
    want = j_align(mel, v_start, total_v, reference_slice=reference_slice)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(method="none"),
    dict(method="temperature", temperature=1.7),
    dict(method="platt", platt_a=0.8, platt_b=-0.3),
])
def test_calibrator_matches_jax(kwargs):
    logits = np.linspace(-6, 6, 25).astype(np.float32)
    got = Calibrator.from_config(**kwargs)(logits)
    want = JCalibrator.from_config(**kwargs)(logits)
    print(f"max |delta| calibrator {kwargs['method']}: "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.fixture(scope="module")
def engines():
    model, cfg, variables, jcfg = seeded_pair(5)
    port = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False)
    jax_engine = JEngine(variables, jcfg, use_bfloat16=False)
    return port, jax_engine, cfg


def test_score_logits_matches_jax(engines):
    port, jax_engine, cfg = engines
    rng = np.random.RandomState(11)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)  # bucket 4
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    got = port.score_logits(vis, aud)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.score_logits(vis, aud)
    assert got.shape == want.shape == (3,)
    print(f"max |delta| score_logits: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.score_probs(vis, aud),
                               port.calibrator(got), atol=0, rtol=0)


def test_score_track_logits_matches_jax(engines):
    port, jax_engine, cfg = engines
    rng = np.random.RandomState(12)
    crops = rng.rand(19, 32, 32, 3).astype(np.float32)
    starts = [0, 5, 11]  # odd count: bucket 4, crop span padded to 32
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    got = port.score_track_logits(crops, starts, aud)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.score_track_logits(crops, starts, aud)
    assert got.shape == want.shape == (3,)
    print(f"max |delta| score_track_logits: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.score_track_probs(crops, starts, aud),
                               port.calibrator(got), atol=0, rtol=0)


def test_warmup_runs_the_canonical_shapes(engines):
    port, _, _ = engines
    port.warmup()


def test_track_windows_equal_direct_windows(engines):
    """The on-device gather scores the same windows as score_logits, and
    groups of max_batch stream back in order."""
    port, _, cfg = engines
    rng = np.random.RandomState(13)
    crops = (rng.rand(14, 32, 32, 3) * 255).astype(np.uint8)
    starts = [0, 2, 6]
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    direct = port.score_logits(
        np.stack([crops[s : s + 8] for s in starts]), aud)
    port.max_batch = 2
    try:
        tracked = port.score_track_logits(crops, starts, aud)
    finally:
        port.max_batch = 256
    np.testing.assert_allclose(tracked, direct, atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", ["mesh"])
def test_waiting_options_raise(option):
    """``mesh`` waited for data parallelism and is ported now: an engine
    over two shards scores as the engine on one device
    (``test_torch_parallel_engine.py`` holds it against the JAX mesh), and
    a mesh of things that are not devices still raises."""
    model, cfg, variables, _ = seeded_pair(5)
    with pytest.raises((TypeError, RuntimeError)):
        ScoringEngine(variables, cfg, device="cpu", **{option: [object()]})
    sharded = ScoringEngine(variables, cfg, use_bfloat16=False,
                            **{option: ["cpu", "cpu"]})
    single = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False)
    rng = np.random.RandomState(14)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    np.testing.assert_allclose(sharded.score_logits(vis, aud),
                               single.score_logits(vis, aud), atol=1e-5,
                               rtol=0)


def test_load_engine_needs_an_existing_path(tmp_path, monkeypatch):
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(FileNotFoundError):
        load_engine(None, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_engine(tmp_path / "missing.pth", device="cpu")


@pytest.mark.parametrize("fmt", [".pth", ".npz"])
def test_load_engine_from_file(engines, tmp_path, fmt):
    port, _, cfg = engines
    _, _, variables, _ = seeded_pair(5)
    path = tmp_path / f"weights{fmt}"
    if fmt == ".pth":
        torch.save({"model_state_dict": port.model.state_dict()}, path)
    else:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = np.asarray(v)

        walk(variables, "")
        np.savez(path, **flat)
    loaded = load_engine(path, cfg, device="cpu", use_bfloat16=False)
    for k, v in port.model.state_dict().items():
        torch.testing.assert_close(loaded.model.state_dict()[k], v,
                                   atol=0, rtol=0)


def test_synthetic_track_windows_follow_the_request_path():
    """The measurement scripts' windows are the request's crops, sliced at
    the stride, with the aligned mel of each start."""
    req = synthetic.request(np.random.default_rng(0), 20, 20 / synthetic.FPS)
    visual, audio = synthetic.track_windows(req, 8, 32, 32, 6, device="cpu")
    frames, boxes, y = req
    crops = crop_track_on_device(frames, boxes, 0, 32, device="cpu")
    mel = preprocess_audio_pcm(y, device="cpu")
    assert visual.shape == (3, 8, 32, 32, 3)
    assert audio.shape == (3, 80, 32, 1)
    for i, s in enumerate((0, 6, 12)):
        np.testing.assert_array_equal(visual[i].numpy(), crops[s : s + 8])
        np.testing.assert_array_equal(
            audio[i, ..., 0].numpy(), align_audio_chunk(mel, s, 20, 32, 8))


def test_transfer_uint8_false_matches_jax(engines):
    """``transfer_uint8=False``: float windows off the uint8 grid reach the
    forward unrounded, as the JAX engine's ``_fwd`` takes them (logits
    atol 1e-4), and score otherwise than the rounded default, which shows
    that the flag acts. uint8 windows still take the /255 path."""
    port, jax_engine, cfg = engines
    _, _, variables, _ = seeded_pair(5)
    raw = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False,
                        transfer_uint8=False)
    assert not raw.transfer_uint8 and port.transfer_uint8
    rng = np.random.RandomState(15)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(3, 80, 32) * 80 - 80).astype(np.float32)
    got = raw.score_logits(vis, aud)
    jax_engine.transfer_uint8 = False
    try:
        with jax.default_matmul_precision("highest"):
            want = jax_engine.score_logits(vis, aud)
    finally:
        jax_engine.transfer_uint8 = True
    print(f"max |delta| score_logits transfer_uint8=False: "
          f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    rounded = port.score_logits(vis, aud)
    print(f"max |unrounded - rounded|: {np.abs(got - rounded).max():.3g}")
    assert np.abs(got - rounded).max() > 1e-6
    u8 = (vis * 255).astype(np.uint8)
    np.testing.assert_array_equal(raw.score_logits(u8, aud),
                                  port.score_logits(u8, aud))


class _Spy:
    """Stands for a group's device logits and logs when it is read."""

    def __init__(self, logits, log):
        self.logits, self.log = logits, log

    def __getitem__(self, item):
        self.log.append("read")
        return self.logits[item]


@pytest.mark.parametrize("track", [False, True], ids=["windows", "track"])
@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_max_in_flight_streams_groups(engines, in_flight, track):
    """Over more windows than ``max_batch`` holds, ``max_in_flight`` groups
    are dispatched before the first is read back (as the JAX engine keeps
    them), and the logits are the same for 1, 2 and 3 and in order."""
    _, _, cfg = engines
    _, _, variables, _ = seeded_pair(5)
    eng = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False,
                        max_batch=2, max_in_flight=in_flight)
    rng = np.random.RandomState(16)
    crops = (rng.rand(24, 32, 32, 3) * 255).astype(np.uint8)
    starts = [0, 2, 4, 7, 9, 12, 16]  # 4 groups, the last ragged
    aud = (rng.rand(7, 80, 32) * 80 - 80).astype(np.float32)
    log = []
    name = "dispatch_track_logits" if track else "dispatch_logits"
    real = getattr(eng, name)

    def spy(*args):
        log.append("dispatch")
        return _Spy(real(*args), log)

    setattr(eng, name, spy)
    if track:
        got = eng.score_track_logits(crops, starts, aud)
    else:
        got = eng.score_logits(np.stack([crops[s : s + 8] for s in starts]),
                               aud)
    assert log[:min(in_flight, 4)] == ["dispatch"] * min(in_flight, 4)
    assert log.count("dispatch") == log.count("read") == 4
    pending = 0
    for event in log:
        pending += 1 if event == "dispatch" else -1
        assert 0 <= pending <= in_flight
    one = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False,
                        max_batch=2, max_in_flight=1)
    want = (one.score_track_logits(crops, starts, aud) if track
            else one.score_logits(
                np.stack([crops[s : s + 8] for s in starts]), aud))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("track", [False, True], ids=["windows", "track"])
def test_spans_and_upload_bytes_under_a_profiler(engines, track):
    """Under a CPU profiler one call over 2.5 groups records one
    ``engine.score`` and, per group, an ``engine.dispatch`` holding
    ``engine.pad``, ``engine.upload`` and ``engine.forward`` (which holds
    the visual encoder's ``visual.low``), and an ``engine.readback``;
    ``engine.upload_bytes`` is the bytes of the padded
    group arrays; the logits are bit-equal with tracing off."""
    from torch.profiler import ProfilerActivity, profile

    _, _, cfg = engines
    _, _, variables, _ = seeded_pair(5)
    eng = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False,
                        max_batch=4)
    rng = np.random.RandomState(17)
    crops = rng.rand(40, 32, 32, 3).astype(np.float32)
    starts = [0, 3, 5, 8, 11, 14, 17, 20, 25, 31]
    aud = (rng.rand(10, 80, 32) * 80 - 80).astype(np.float32)

    def call():
        if track:
            return eng.score_track_logits(crops, starts, aud)
        return eng.score_logits(np.stack([crops[s:s + 8] for s in starts]),
                                aud)

    profiling.clear()
    off = call()
    assert profiling.records() == [] and profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    recs = profiling.records()
    bytes_ = profiling.counters()["engine.upload_bytes"]
    profiling.clear()
    np.testing.assert_array_equal(on, off)
    score = [r for r in recs if r.name == "engine.score"]
    assert len(score) == 1 and score[0].parent is None
    assert {r.root for r in recs} == {score[0].id}
    dispatch = [r for r in recs if r.name == "engine.dispatch"]
    readback = [r for r in recs if r.name == "engine.readback"]
    assert len(dispatch) == len(readback) == 3
    assert all(r.parent == score[0].id for r in dispatch + readback)
    # The track path uploads the group's crops, then each shard's starts
    # and mel windows: two uploads a group on one device.
    uploads = ["engine.upload"] * (2 if track else 1)
    for d in dispatch:
        kids = sorted(r.name for r in recs if r.parent == d.id)
        assert kids == ["engine.forward", "engine.pad"] + uploads
        forward = [r for r in recs
                   if r.parent == d.id and r.name == "engine.forward"][0]
        assert [r.name for r in recs if r.parent == forward.id] == \
            ["visual.low"]
    assert len(recs) == 1 + 3 * (5 + len(uploads))
    buckets = (4, 4, 2)
    window_bytes = 80 * 32 * 4 + (8 if track else 8 * 32 * 32 * 3)
    # The track path uploads its crops padded to 8 * 2^k frames per group.
    crop_bytes = 3 * 64 * 32 * 32 * 3 if track else 0
    assert bytes_ == sum(buckets) * window_bytes + crop_bytes


# ── the pinned staging ring's bookkeeping, driven with fake events ────────


class _FakeLink:
    """A :class:`CudaLink` with CPU buffers and events that only log. It
    checks, as the ring calls it, that a pinned buffer is rewritten only
    after the host waited on the event of the copy that last read it, and
    a device buffer only after the copy stream waited on the event
    recorded after its last read (``read`` stands for a forward)."""

    copy_stream = "copy"

    def __init__(self):
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.synced, self.waited = set(), {}
        self.copied_from, self.consumed = {}, {}
        self.unread_reads = {}  # stream -> device buffers read since
        self.last_copy = {}  # thread -> the pinned buffer it copied last
        self.faults = []

    @staticmethod
    def buf(t):
        return t.untyped_storage().data_ptr()

    @staticmethod
    def covered(event, done):
        """Whether waiting on ``done`` covers ``event``: an event of the
        same stream recorded no earlier (a stream runs in order)."""
        return any(d[1] == event[1] and d[0] >= event[0] for d in done)

    def fresh(self, t):
        """A new buffer has no history, at whatever address it lands."""
        with self.lock:
            self.copied_from.pop(self.buf(t), None)
            self.consumed.pop(self.buf(t), None)
        return t

    def host(self, nbytes):
        return self.fresh(torch.full((nbytes,), 7, dtype=torch.uint8))

    def device_buffer(self, nbytes):
        return self.fresh(torch.full((nbytes,), 9, dtype=torch.uint8))

    def event(self, stream):
        with self.lock:
            e = (next(self.ids), stream)
            src = self.last_copy.pop(threading.get_ident(), None)
            if stream == self.copy_stream and src is not None:
                self.copied_from[src] = e
            for d in self.unread_reads.pop(stream, ()):
                self.consumed[d] = e
            return e

    def wait(self, stream, event):
        with self.lock:
            self.waited.setdefault(stream, set()).add(event)

    def sync(self, event):
        with self.lock:
            self.synced.add(event)

    def stage(self, dst, src):
        with self.lock:
            e = self.copied_from.get(self.buf(dst))
            if e is not None and not self.covered(e, self.synced):
                self.faults.append("pinned rewritten before its copy")
        dst.copy_(src)

    def copy(self, dst, src):
        with self.lock:
            e = self.consumed.get(self.buf(dst))
            if e is not None and not self.covered(
                    e, self.waited.get("copy", ())):
                self.faults.append("device rewritten before its read")
            self.last_copy[threading.get_ident()] = self.buf(src)
        dst.copy_(src)

    def read(self, stream, slot, views):
        """A forward on ``stream``: it must wait for the slot's copy."""
        with self.lock:
            if not self.covered(slot.copied, self.waited.get(stream, ())):
                self.faults.append("read before the copy's event")
            self.unread_reads.setdefault(stream, []).append(
                self.buf(views[0]))
        return [v.clone() for v in views]


def _group(rng, n):
    """Crops and mel as a dispatch hands them over (the mel's new last
    axis has numpy's stride 0)."""
    return [(rng.rand(n, 4, 6, 6, 3) * 255).astype(np.uint8),
            rng.rand(n, 5, 7).astype(np.float32)[..., None]]


def _use(ring, slot, arrays, stream="compute"):
    """What a dispatch does with a slot: fill, wait, read, release."""
    link = ring.link
    before = (slot.device, slot.consumed)
    views = ring.fill(slot, arrays)
    if slot.device is not before[0] and before[1] is not None:
        # A device buffer is dropped only once its last read was waited on.
        assert link.covered(before[1], link.synced)
    ring.ready(slot, stream)
    got = link.read(stream, slot, views)
    ring.release(slot, stream)
    for g, v, a in zip(got, views, arrays):
        np.testing.assert_array_equal(g.numpy(), a)
        # The strides ``.to(device)`` would give: kernels may pick by them.
        assert v.stride() == torch.from_numpy(a).stride()


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_staging_ring_waits_before_each_rewrite(slots):
    """Rings of one slot, of the engine's two and of three: one caller
    streaming ragged groups (growing a slot where a group
    is larger than any it held), in and out of inference mode, then
    callers that hold several slots at once: every pinned and device
    rewrite waits on the right event, each
    read sees its own group, and ``acquire`` gives None while every slot
    is held."""
    link = _FakeLink()
    ring = StagingRing(slots, link)
    rng = np.random.RandomState(slots)
    for i, n in enumerate((3, 8, 8, 1, 8, 5, 8, 16, 2, 16, 16, 7)):
        # Callers run under inference mode (a shard's call) or not (a
        # track's crops): slots made in the one are rewritten in the other.
        with torch.inference_mode(i < 4 or i % 2 == 0):
            _use(ring, ring.acquire(), _group(rng, n))
    held = [ring.acquire() for _ in range(slots)]
    assert all(s is not None for s in held)
    assert len({id(s) for s in held}) == slots
    assert ring.acquire() is None
    for s in reversed(held):
        _use(ring, s, _group(rng, int(rng.randint(1, 20))))
    assert not link.faults
    assert not any(s.held for s in ring.slots)


def test_staging_ring_fake_link_sees_a_missing_wait():
    """The checks above catch a ring that skips its waits."""
    link = _FakeLink()
    link.sync = link.wait = lambda *a: None
    ring = StagingRing(1, link)
    rng = np.random.RandomState(0)
    for n in (2, 2):
        slot = ring.acquire()
        views = ring.fill(slot, _group(rng, n))
        link.read("compute", slot, views)
        ring.release(slot, "compute")
    assert set(link.faults) == {"pinned rewritten before its copy",
                                "device rewritten before its read",
                                "read before the copy's event"}


def test_staging_ring_under_concurrent_callers():
    """Sixteen callers on one ring of the engine's two slots, switching
    often: no rewrite skips its wait, each caller reads its own group, and
    a caller that finds every slot held gets None (the engine's plain
    upload) instead of waiting."""
    link = _FakeLink()
    ring = StagingRing(2, link)
    errors, misses = [], []

    def caller(i):
        rng = np.random.RandomState(100 + i)
        try:
            for _ in range(25):
                slot = ring.acquire()
                if slot is None:
                    misses.append(i)
                    continue
                _use(ring, slot, _group(rng, int(rng.randint(1, 12))),
                     stream=f"compute{i % 3}")
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert not link.faults
    assert not any(s.held for s in ring.slots)


def test_cpu_engine_uploads_and_reads_back_plainly(engines):
    """On the CPU the engine makes no staging ring and counts no staged
    bytes, and its logits are the plain forward's over the padded bucket,
    bit for bit, for a group in each bucket from 1 to 256 and on the
    track path."""
    from torch.profiler import ProfilerActivity, profile

    from lipsync_tpu_torch.inference.engine import _pad_rows, _to_uint8

    port, _, cfg = engines
    rng = np.random.RandomState(18)
    vis = rng.rand(256, 8, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(256, 80, 32) * 80 - 80).astype(np.float32)

    def plain(v, a, bucket):
        v = torch.from_numpy(_pad_rows(_to_uint8(v), bucket))
        a = torch.from_numpy(_pad_rows(a[..., None], bucket))
        with torch.inference_mode():
            return port.model(v.float() / 255.0, a).numpy()

    for n, bucket in ((1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32),
                      (33, 64), (65, 128), (129, 256)):
        np.testing.assert_array_equal(port.score_logits(vis[:n], aud[:n]),
                                      plain(vis[:n], aud[:n], bucket)[:n])
    crops = (rng.rand(19, 32, 32, 3) * 255).astype(np.uint8)
    starts = [0, 5, 11]
    tracked = port.score_track_logits(crops, starts, aud[:3])
    windows = np.stack([_pad_rows(crops, 32)[s:s + 8] for s in starts])
    np.testing.assert_array_equal(
        tracked, plain(windows.astype(np.float32) / 255, aud[:3], 4)[:3])
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        port.score_logits(vis[:3], aud[:3])
    counters = profiling.counters()
    profiling.clear()
    assert counters["engine.upload_bytes"] > 0
    assert "engine.upload_staged_bytes" not in counters
    assert port._rings == {}
