"""The port's two MediaPipe detector tiers and its default ladder against
the JAX package's, through the stub ``mediapipe`` module of
``tests/test_mediapipe_stub.py`` (no machine here has the wheel).

Each side gets its own stub with the same scripted results; boxes,
detector names, scores and constructor arguments must be equal.
"""

import sys
import threading
from unittest import mock

import numpy as np
import pytest

from lipsync_tpu.preprocessing import face_detection as j_fd
from lipsync_tpu_torch.preprocessing import face_detection as fd
from tests.test_mediapipe_stub import (
    H,
    W,
    _FDDetection,
    _FDResult,
    _make_stub,
    _mesh_face,
    _MeshResult,
    _RelBox,
)

FRAME = np.zeros((H, W, 3), np.uint8)
LIPS = fd.MediaPipeDetector.mouth_landmarks


def _mesh_script():
    return [
        _MeshResult([_mesh_face([(100.0, 300.0), (200.0, 345.0)], LIPS)]),
        _MeshResult(None),
        _MeshResult([_mesh_face([(5.0, 10.0), (630.0, 475.0)], LIPS),
                     _mesh_face([(301.5, 40.25), (333.75, 90.5)], LIPS)]),
        _MeshResult([]),
        _MeshResult([_mesh_face([(17.3, 451.9), (64.8, 470.1)], LIPS)]),
    ]


def _fd_script():
    return [
        _FDResult([_FDDetection(_RelBox(0.25, 0.2, 0.5, 0.6), 0.87)]),
        _FDResult(None),
        _FDResult([_FDDetection(_RelBox(0.1, 0.1, 0.002, 0.002), 0.9)]
                  + [_FDDetection(_RelBox(0.05 + 0.18 * i, 0.1, 0.15, 0.3),
                                  0.5 + 0.1 * i) for i in range(4)]),
        _FDResult([_FDDetection(_RelBox(0.9, 0.9, 0.3, 0.3), 0.4)]),
    ]


def _boxes(detections):
    return [(d.bbox, d.detector, d.score) for d in detections]


def _run(module, tier, kwargs, stub, n):
    with mock.patch.dict(sys.modules, {"mediapipe": stub}):
        det = getattr(module, tier)(**kwargs)
        return [_boxes(det.detect(FRAME)) for _ in range(n)]


@pytest.mark.parametrize("tier,script,kwargs", [
    ("MediaPipeDetector", _mesh_script,
     dict(max_num_faces=3, min_detection_confidence=0.4,
          min_tracking_confidence=0.2)),
    ("MediaPipeFaceDetectionDetector", _fd_script,
     dict(max_num_faces=3, min_detection_confidence=0.4)),
])
def test_tiers_match_jax(tier, script, kwargs):
    key = "mesh" if tier == "MediaPipeDetector" else "fd"
    stubs = [_make_stub(**{f"{key}_results": script()}) for _ in range(2)]
    n = len(script())
    got = _run(fd, tier, kwargs, stubs[0], n)
    want = _run(j_fd, tier, kwargs, stubs[1], n)
    assert got == want
    assert any(got) and not all(got)  # faces and empty frames both scripted
    assert (stubs[0]._calls[f"{key}_kwargs"]
            == stubs[1]._calls[f"{key}_kwargs"])


def _ladder(module, stub, n):
    with mock.patch.dict(sys.modules, {"mediapipe": stub}), \
            mock.patch.object(module, "_default_backend", None):
        chain = module.get_default_backend()
        names = [b.name for b in chain.backends]
        found = []
        for _ in range(n):
            found.append(_boxes(chain.detect(FRAME)))
        return names, found


def test_default_ladder_matches_jax():
    """The first tier that finds a face wins: FaceMesh on frame 0,
    FaceDetection where FaceMesh is empty."""
    mesh = [_mesh_script()[0], _MeshResult(None), _MeshResult(None)]
    fds = [_FDResult([_FDDetection(_RelBox(0.25, 0.2, 0.5, 0.6), 0.6)]),
           _FDResult([_FDDetection(_RelBox(0.3, 0.3, 0.2, 0.2), 0.7)])]
    got = _ladder(fd, _make_stub(mesh_results=mesh, fd_results=fds), 2)
    want = _ladder(j_fd, _make_stub(mesh_results=mesh, fd_results=fds), 2)
    assert got[0] == want[0] == ["facemesh", "facedetection",
                                 want[0][2]]
    assert got[1] == want[1]
    assert [d[0][1] for d in got[1]] == ["facemesh", "facedetection"]


def test_ladder_skips_a_tier_that_raises():
    got, want = [], []
    for module, out in ((fd, got), (j_fd, want)):
        stub = _make_stub(fd_results=_fd_script())
        with mock.patch.dict(sys.modules, {"mediapipe": stub}):
            chain = module.ChainedDetector(
                [_Raises(), module.MediaPipeFaceDetectionDetector()])
            out.extend(_boxes(chain.detect(FRAME)))
    assert got == want and got[0][1] == "facedetection"


class _Raises:
    name = "raises"

    def detect(self, frame):
        raise RuntimeError("tier down")


def test_facemesh_is_one_instance_per_thread():
    """FaceMesh tracks across frames, so each thread that detects gets its
    own instance, built with the same arguments."""
    stub = _make_stub()
    made = []
    real = stub.solutions.face_mesh.FaceMesh

    def counting(**kwargs):
        made.append(kwargs)
        return real(**kwargs)

    stub.solutions.face_mesh.FaceMesh = counting
    with mock.patch.dict(sys.modules, {"mediapipe": stub}):
        det = fd.MediaPipeDetector(max_num_faces=2)
        det.detect(FRAME)
        threads = [threading.Thread(target=det.detect, args=(FRAME,))
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        det.detect(FRAME)
    assert len(made) == 3 and all(k == made[0] for k in made)


def test_without_the_wheel_the_ladder_starts_at_the_cascades():
    with mock.patch.dict(sys.modules, {"mediapipe": None}):
        for module in (fd, j_fd):
            with mock.patch.object(module, "_default_backend", None):
                backend = module.get_default_backend()
                assert not isinstance(backend, module.ChainedDetector)
