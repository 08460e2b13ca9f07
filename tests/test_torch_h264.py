"""The port's H.264 round trip and codec-selecting ``write_video`` against
the JAX package's.

Both packages encode through the same ``native/mux.cc`` with the same x264
options (``crf=<crf>:preset=veryfast:bf=0``; x264 is deterministic for one
option string) and decode with ``cv2.VideoCapture``, so the tolerance is
none: the arrays are equal.
"""

import numpy as np
import pytest
import torch

from lipsync_tpu.preprocessing import mux as j_mux
from lipsync_tpu_torch.preprocessing import ingest, mux
from tests.fixtures import synthetic_frames

torch.set_num_threads(1)


def _frames(n):
    return synthetic_frames(n, h=96, w=96, seed=n)


def _mse(a, b):
    return float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))


@pytest.mark.parametrize("n", [8, 20], ids=["8_padded", "20"])
@pytest.mark.parametrize("crf", [18, 35])
def test_h264_roundtrip_equals_jax(n, crf):
    frames = _frames(n)
    got = mux.h264_roundtrip(frames, crf)
    want = j_mux.h264_roundtrip(frames, crf)
    assert got.shape == frames.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_h264_crf_orders_loss():
    """CRF 18 keeps the frames closer than CRF 35, and close to the input."""
    frames = _frames(20)
    e18 = _mse(mux.h264_roundtrip(frames, 18), frames)
    e35 = _mse(mux.h264_roundtrip(frames, 35), frames)
    assert e18 < e35
    assert np.sqrt(e18) < 25.0


def test_write_video_libx264_round_trips(tmp_path):
    """``write_video(vcodec="libx264")`` writes the same file as the JAX
    package's, and cv2 decodes every frame of it, close to the input."""
    import cv2

    frames = _frames(12)
    opts = "crf=18:preset=veryfast:bf=0"
    path = mux.write_video(tmp_path / "p.mp4", frames, vcodec="libx264",
                           vcodec_opts=opts)
    j_path = j_mux.write_video(tmp_path / "j.mp4", frames, vcodec="libx264",
                               vcodec_opts=opts)
    assert path.read_bytes() == j_path.read_bytes()
    cap = cv2.VideoCapture(str(path))
    back = []
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            back.append(bgr[..., ::-1])
    finally:
        cap.release()
    back = np.stack(back)
    assert back.shape == frames.shape
    assert np.sqrt(_mse(back, frames)) < 25.0


def test_write_video_default_codec_is_mpeg4(tmp_path):
    """Without ``vcodec`` both packages write the same mpeg4 ``.avi``."""
    frames = _frames(6)
    path = mux.write_video(tmp_path / "p.avi", frames)
    j_path = j_mux.write_video(tmp_path / "j.avi", frames)
    assert path.read_bytes() == j_path.read_bytes()
    assert ingest.read_video(path).shape == frames.shape
