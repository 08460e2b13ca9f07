"""The port's ingest and muxer against the JAX package's, on the same files.

Both packages bind the same ``native/ingest.cc`` and ``native/mux.cc``; the
port compiles them into ``build/lipsync_tpu_torch_native/``. Tolerance:
none, every result is bit-equal.
"""

import numpy as np
import pytest
import torch

from lipsync_tpu.preprocessing import ingest as j_ingest
from lipsync_tpu.preprocessing.audio import (
    detect_voice_activity as j_detect_voice_activity,
)
from lipsync_tpu.preprocessing.audio import preprocess_audio as j_preprocess_audio
from lipsync_tpu_torch.preprocessing import ingest, mux
from lipsync_tpu_torch.preprocessing.audio import (
    detect_voice_activity,
    preprocess_audio,
)
from tests.fixtures import (
    speechish_pcm,
    synthetic_frames,
    write_av_video,
    write_wav,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """An A/V clip written by each package's muxer, a silent-video clip and
    a WAV file."""
    d = tmp_path_factory.mktemp("ingest")
    frames = synthetic_frames(n=20, seed=3)
    pcm = speechish_pcm(seconds=20 / 15.0, seed=3)
    return {
        "jax_mux": write_av_video(d / "jax.avi", frames, pcm=pcm),
        "port_mux": mux.write_video(d / "port.avi", frames, fps=15.0, pcm=pcm),
        "no_audio": mux.write_video(d / "mute.avi", synthetic_frames(n=12)),
        "wav": write_wav(d / "speech.wav", seconds=1.5),
    }


@pytest.mark.parametrize("name", ["jax_mux", "port_mux", "no_audio", "wav"])
def test_probe_matches_jax(clips, name):
    assert ingest.probe(clips[name]) == ingest.MediaInfo(
        **vars(j_ingest.probe(clips[name])))


@pytest.mark.parametrize("name", ["jax_mux", "port_mux", "no_audio"])
@pytest.mark.parametrize("fps,cap", [(15.0, None), (10.0, None), (15.0, 7)])
def test_read_video_matches_jax(clips, name, fps, cap):
    got = ingest.read_video(clips[name], fps, cap)
    want = j_ingest.read_video(clips[name], fps, cap)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["jax_mux", "port_mux", "no_audio", "wav"])
def test_read_audio_matches_jax(clips, name):
    got = ingest.read_audio(clips[name])
    want = j_ingest.read_audio(clips[name])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_port_muxer_writes_what_the_jax_muxer_writes(clips):
    """The same frames and PCM through either muxer decode to the same
    frames and samples."""
    np.testing.assert_array_equal(ingest.read_video(clips["port_mux"]),
                                  ingest.read_video(clips["jax_mux"]))
    np.testing.assert_array_equal(ingest.read_audio(clips["port_mux"]),
                                  ingest.read_audio(clips["jax_mux"]))


@pytest.mark.parametrize("name", ["jax_mux", "wav"])
def test_preprocess_audio_and_vad_from_files_match_jax(clips, name):
    """File -> log-mel (the K1 twin on the CPU; < 1e-3 dB, the JAX package's
    mel tolerance) and file -> VAD mask (exact)."""
    got = preprocess_audio(clips[name], target_frames=64, device="cpu")
    want = j_preprocess_audio(clips[name], target_frames=64)
    assert got.shape == want.shape == (80, 64)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    (mask, dur), (j_mask, j_dur) = (detect_voice_activity(clips[name]),
                                    j_detect_voice_activity(clips[name]))
    np.testing.assert_array_equal(mask, j_mask)
    assert dur == j_dur


def test_audio_of_a_clip_without_sound(clips):
    """An empty audio stream: preprocess_audio raises ValueError in both
    packages (the predictor then scores against silence)."""
    assert ingest.read_audio(clips["no_audio"]).size == 0
    for fn, kw in ((preprocess_audio, {"device": "cpu"}),
                   (j_preprocess_audio, {})):
        with pytest.raises(ValueError):
            fn(clips["no_audio"], **kw)


def test_missing_file(tmp_path):
    """No such file: the same empty probe, the same error on decode."""
    path = tmp_path / "missing.avi"
    assert ingest.probe(path) == ingest.MediaInfo(**vars(j_ingest.probe(path)))
    for read in (ingest.read_video, j_ingest.read_video):
        with pytest.raises(ValueError):
            read(path)
