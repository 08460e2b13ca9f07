"""The port's host detection, tracking, crops and VAD against the JAX
package's, on the same frames and signals.

Tolerances: boxes, tracks and masks exact; host crops within one uint8
step of the JAX function with OpenCV and exact against its numpy branch;
device crops of a track atol 1e-5 (the crop tolerance of
``test_torch_engine.py``).
"""

import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from lipsync_tpu.ops.vad import detect_voice_activity_pcm as j_vad
from lipsync_tpu.preprocessing import face_detection as j_fd
from lipsync_tpu.preprocessing import lip_localizer as j_lip
from lipsync_tpu.preprocessing import tracker as j_tracker
from lipsync_tpu.preprocessing import video as j_video
from lipsync_tpu_torch.ops.vad import detect_voice_activity_pcm
from lipsync_tpu_torch.preprocessing import face_detection as fd
from lipsync_tpu_torch.preprocessing import lip_localizer
from lipsync_tpu_torch.preprocessing import tracker
from lipsync_tpu_torch.preprocessing import video
from tests.fixtures import speechish_pcm, synthetic_frames

torch.set_num_threads(1)


def _boxes(dets):
    return [[(tuple(int(v) for v in d.bbox), d.detector) for d in frame]
            for frame in dets]


def _track_fields(results):
    return [(r.track_id, [tuple(b) for b in r.boxes], r.hits, r.total_frames,
             r.stability, r.consecutive_miss_max, r.track_start_frame,
             r.track_end_frame) for r in results]


@pytest.fixture(scope="module")
def backends():
    """The default chains of both packages: cascades + the learned lip
    localizer (the committed weights)."""
    port, jax_backend = fd.get_default_backend(), j_fd.get_default_backend()
    assert port.name == jax_backend.name == "cascade+lipnet"
    return port, jax_backend


@pytest.mark.parametrize("kw", [dict(n=12), dict(n=12, h=240, w=320, seed=4),
                                dict(n=6, face=False, seed=2)],
                         ids=["face", "face_large", "noise"])
def test_default_backend_boxes_match_jax(backends, kw):
    frames = synthetic_frames(**kw)
    out = []
    for backend in backends:
        backend.reset()
        out.append(_boxes([backend.detect(f) for f in frames]))
    assert out[0] == out[1]
    if kw.get("face", True):
        assert all(len(f) == 1 for f in out[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_refiners_match_jax(seed):
    """The image-evidence refiner and the learned localizer on the same
    heuristic boxes."""
    rng = np.random.RandomState(seed)
    frames = synthetic_frames(n=4, h=240, w=320, seed=seed)
    localizer = lip_localizer.load_default_localizer()
    j_localizer = j_lip.load_default_localizer()
    patches = rng.rand(3, lip_localizer.PATCH, lip_localizer.PATCH,
                       3).astype(np.float32)
    np.testing.assert_array_equal(
        lip_localizer.forward(localizer.params, patches),
        j_lip.forward(np, j_localizer.params, patches))
    for frame in frames:
        for _ in range(5):
            x1, y1 = rng.randint(0, 200), rng.randint(0, 150)
            box = (x1, y1, x1 + rng.randint(4, 120), y1 + rng.randint(4, 90))
            assert fd.refine_mouth_box(frame, box) == j_fd.refine_mouth_box(
                frame, box)
            assert localizer.refine(frame, box) == j_localizer.refine(frame,
                                                                      box)


def _script(kind):
    """Per-frame detections (lists of boxes) for the tracker scenarios."""
    out = []
    for t in range(48):
        if kind == "dropout" and 12 <= t < 18:
            out.append([])
        elif kind == "two_faces":
            boxes = [(50 + t, 60, 100 + t, 100), (150, 40 + t // 2, 190, 80)]
            out.append(boxes if t % 11 else boxes[:1])
        elif kind == "jitter":
            j = (t * 7) % 5 - 2
            out.append([(60 + j, 70 - j, 110 + j, 105)] if t % 5 else [])
        elif kind == "transient":
            boxes = [(40, 50, 90, 95)]
            if t in (5, 6, 30):
                boxes.append((5, 5, 20, 20))
            out.append(boxes)
        else:
            out.append([(50 + 2 * t, 60, 100 + 2 * t, 100)])
    return out


@pytest.mark.parametrize("kind", ["steady", "dropout", "two_faces", "jitter",
                                  "transient"])
def test_track_faces_matches_jax(kind):
    script = _script(kind)
    got = tracker.track_faces(
        [[fd.Detection(bbox=b) for b in f] for f in script], 120, 240,
        max_tracks=3)
    want = j_tracker.track_faces(
        [[j_fd.Detection(bbox=b) for b in f] for f in script], 120, 240,
        max_tracks=3)
    assert _track_fields(got) == _track_fields(want)
    assert got


@pytest.mark.parametrize("stride", [1, 2])
def test_streaming_tracker_matches_jax(stride):
    """Frame by frame, with coasting at stride 2: the same finalized
    prefixes while streaming and the same tracks at the end."""
    script = _script("dropout")
    st = tracker.StreamingTracker(120, 240, detection_stride=stride)
    jst = j_tracker.StreamingTracker(120, 240, detection_stride=stride)
    for t, boxes in enumerate(script):
        if t % stride == 0:
            st.update([fd.Detection(bbox=b) for b in boxes])
            jst.update([j_fd.Detection(bbox=b) for b in boxes])
        else:
            st.coast()
            jst.coast()
        assert ([st.finalized_length(s) for s in st.all_states()]
                == [jst.finalized_length(s) for s in jst.all_states()])
    assert _track_fields(st.finalize()) == _track_fields(jst.finalize())


@pytest.mark.parametrize("seed,seconds,kind", [(0, 3.0, "speech"),
                                               (1, 0.7, "speech"),
                                               (2, 2.0, "silence"),
                                               (3, 0.0, "empty")])
def test_vad_matches_jax(seed, seconds, kind):
    y = speechish_pcm(seconds=seconds, seed=seed)
    if kind == "silence":
        y = np.zeros_like(y)
    got, dur = detect_voice_activity_pcm(y)
    want, j_dur = j_vad(y)
    np.testing.assert_array_equal(got, want)
    assert dur == j_dur


def _crop_cases():
    rng = np.random.RandomState(5)
    frame = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    boxes = [(10, 20, 70, 60), (0, 0, 120, 90), (100, 80, 140, 120),
             (-5, -3, 12, 9), (30, 30, 31, 31), (50, 10, 53, 80)]
    return frame, boxes


@pytest.mark.parametrize("out_size", [24, 48, 96])
def test_crop_mouth_uint8_within_one_step_of_jax(out_size):
    """Both packages call cv2 when it is importable (it is here), and
    their numpy branch otherwise (as on a machine without OpenCV): the
    port's crops equal the JAX package's with cv2 visible on both sides,
    and with it hidden on both; the two branches are within one uint8 step
    of each other."""
    pytest.importorskip("cv2")
    frame, boxes = _crop_cases()
    for box in boxes:
        got = video.crop_mouth_uint8(frame, box, out_size)
        with_cv2 = j_video.crop_mouth_uint8(frame, box, out_size)
        assert got.shape == with_cv2.shape == (out_size, out_size, 3)
        np.testing.assert_array_equal(got, with_cv2)
        with mock.patch.dict(sys.modules, {"cv2": None}):
            numpy_branch = j_video.crop_mouth_uint8(frame, box, out_size)
            np.testing.assert_array_equal(
                video.crop_mouth_uint8(frame, box, out_size), numpy_branch)
        step = np.abs(numpy_branch.astype(int) - with_cv2.astype(int)).max()
        assert step <= 1, (box, step)


def test_detect_and_crop_tracks_matches_jax(backends):
    """The default chain, the tracker and the device crops (the CPU here)
    of a whole clip."""
    frames = synthetic_frames(n=10, seed=7)
    port, jax_backend = backends
    got = video.detect_and_crop_tracks(frames, port, crop_size=32,
                                       device="cpu")
    want = j_video.detect_and_crop_tracks(frames, jax_backend, crop_size=32)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert (g.track_id, g.hits, g.total_frames, g.stability,
                g.consecutive_miss_max, g.track_start_frame,
                g.track_end_frame, g.mean_bbox) == (
            w.track_id, w.hits, w.total_frames, w.stability,
            w.consecutive_miss_max, w.track_start_frame, w.track_end_frame,
            w.mean_bbox)
        np.testing.assert_allclose(g.crops, w.crops, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,max_frames", [(0, 8), (5, 8), (8, 8), (13, 8)])
def test_fit_to_window_and_mean_box_match_jax(t, max_frames):
    crops = np.random.RandomState(t).rand(t, 4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(video._fit_to_window(crops, max_frames),
                                  j_video._fit_to_window(crops, max_frames))
    boxes = [(i, 2 * i, 10 + i, 20 + 3 * i) for i in range(t)]
    assert video.mean_box(boxes) == j_video.mean_box(boxes)


@pytest.mark.parametrize("tier", ["MediaPipeDetector",
                                  "MediaPipeFaceDetectionDetector"])
def test_mediapipe_tiers_raise_import_error(tier):
    """Without the ``mediapipe`` wheel the port's MediaPipe tiers raise
    ImportError, as the JAX package's do, and the default chain starts at
    the cascades in both (``test_torch_mediapipe.py`` holds the tiers
    against the JAX ones through a stub wheel)."""
    with mock.patch.dict(sys.modules, {"mediapipe": None}):
        with pytest.raises(ImportError):
            getattr(fd, tier)(max_num_faces=2)
        with pytest.raises(ImportError):
            getattr(j_fd, tier)(max_num_faces=2)


def test_chained_and_fake_detectors_match_jax():
    frame = np.zeros((40, 40, 3), np.uint8)

    class Broken:
        name = "broken"

        def detect(self, frame):
            raise RuntimeError("tier down")

    script = [[(1, 2, 10, 12)], [], [(3, 4, 20, 22), (5, 5, 9, 9)]]
    port = fd.ChainedDetector([Broken(), fd.FakeDetector(script)])
    jax_chain = j_fd.ChainedDetector([Broken(), j_fd.FakeDetector(script)])
    for _ in range(4):
        assert _boxes([port.detect(frame)]) == _boxes([jax_chain.detect(frame)])
    assert fd.center_crop_box(90, 160, 48) == j_fd.center_crop_box(90, 160, 48)
    assert fd.face_bbox_to_mouth_bbox(10, 20, 50, 60, 64, 64) == (
        j_fd.face_bbox_to_mouth_bbox(10, 20, 50, 60, 64, 64))


def test_default_backend_state_is_per_thread(backends):
    """Two clips detected on two threads in strict alternation through the
    one shared default backend, as the service's handler threads do, give
    each clip's boxes detected alone; the relaxed retry's min_neighbors set
    on one thread is not seen by the other."""
    port = backends[0]
    clips = [synthetic_frames(n=12),
             synthetic_frames(n=12, h=240, w=320, seed=4),
             synthetic_frames(n=12, h=240, w=320, seed=5)]
    relaxed = [False, True, False]

    def detect_all(frames, relax):
        port.reset()
        if relax:
            port.min_neighbors = 1
        try:
            return _boxes([port.detect(f) for f in frames])
        finally:
            port.min_neighbors = 3

    alone = [detect_all(f, r) for f, r in zip(clips, relaxed)]
    got, seen = [None] * len(clips), [[] for _ in clips]
    barrier = threading.Barrier(len(clips))

    def run(k):
        port.reset()
        if relaxed[k]:
            port.min_neighbors = 1
        out = []
        for frame in clips[k]:
            for turn in range(len(clips)):
                barrier.wait()
                if turn == k:
                    out.append(port.detect(frame))
                    seen[k].append(port.min_neighbors)
        got[k] = _boxes(out)

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == alone
    assert alone[0] != alone[1] != alone[2]
    assert [set(s) for s in seen] == [{3}, {1}, {3}]
    assert port.min_neighbors == 3
