"""The port's data tools against the JAX package's scripts of the same
names, on the CPU: the synthetic generator, precompute, validation of a
precomputed directory, and the hygiene tools (filter, convert, audio-swap
fakes).

Tolerances: the generator's frames and PCM bit-equal (numpy on both
sides); precompute's manifest records equal, uint8 crops within one step
(fp32 ``fixed_clip`` crops 1e-5, ``tests/test_torch_detection.py:205``);
the log-mel within 1e-3 dB of the JAX package's (``tests/test_ops.py:161-170``)
at every band within 60 dB of the clip's peak, and both packages' within
2.5e-3 dB of a float64 chain everywhere. The generator's clips are silent
between syllables, so most of their bands sit 60-80 dB down, where every
fp32 chain rounds to ~1-2e-3 dB (the floor that
``tests/test_torch_mel.py::test_quiet_band_floor_is_shared_by_every_fp32_chain``
pins; its 1e-3 dB bound is held on signals of ~50 dB range). The hygiene
tools' decoded outputs equal.
"""

import inspect
import json
import shutil
import sys
from argparse import Namespace
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import convert_videos as j_convert  # noqa: E402
import filter_corrupt_videos as j_filter  # noqa: E402
import generate_audio_swap_fakes as j_swap  # noqa: E402
import make_synthetic_dataset as j_gen  # noqa: E402
import precompute_training_tensors as j_pre  # noqa: E402
import validate_preprocessed as j_valpre  # noqa: E402

from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu_torch.ops import mel as port_mel
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from lipsync_tpu_torch.tools import convert_videos, filter_corrupt_videos
from lipsync_tpu_torch.tools import generate_audio_swap_fakes
from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
from lipsync_tpu_torch.tools import precompute_training_tensors as pre
from lipsync_tpu_torch.tools import validate_preprocessed
from lipsync_tpu_torch.training.data import LipSyncDataset
from tests.fixtures import speechish_pcm, synthetic_frames, write_av_video

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
# A mouth box inside the generator's 140 x 180 frames.
BOX = (50, 60, 130, 120)


# ── the synthetic generator ──────────────────────────────────────────────


def _captured(module, argv, out):
    """The clips ``module.main(argv)`` writes: (relative path, frames, fps,
    pcm, sample rate) per clip, in order, and the sidecars' text."""
    clips = []

    def write(path, frames, fps, pcm=None, sample_rate=16000, **_):
        clips.append((Path(path).relative_to(out).as_posix(), frames, fps,
                      pcm, sample_rate))
        return Path(path)

    with mock.patch.object(module, "write_video", write):
        module.main(argv)
    sidecars = {p.name: p.read_text() for p in sorted(out.glob("*.json"))}
    return clips, sidecars


STYLES = {
    "envelope": ["--n-per-class", "3", "--jitter", "--hard-negatives"],
    "phoneme": ["--n-per-class", "9", "--jitter", "--fake-modes",
                "shift,swap,scramble,warp,splice,freeze,revoice,retime,"
                "composite", "--interference-prob", "0.5"],
    "multiface": ["--n-per-class", "1", "--n-faces", "3",
                  "--articulation-gain", "1.3"],
}


@pytest.mark.parametrize("style", sorted(STYLES))
def test_generator_matches_the_jax_script(tmp_path, style):
    argv = ["--style", style, "--seconds", "1.0", "--seed", "3",
            *STYLES[style]]
    got = _captured(gen, ["--output-dir", str(tmp_path / "p"), *argv],
                    tmp_path / "p")
    want = _captured(j_gen, ["--output-dir", str(tmp_path / "j"), *argv],
                     tmp_path / "j")
    assert got[1] == want[1]
    assert [c[0] for c in got[0]] == [c[0] for c in want[0]]
    assert len(got[0]) == {"envelope": 6, "phoneme": 18, "multiface": 5}[
        style]
    for g, w in zip(got[0], want[0]):
        assert g[1].dtype == w[1].dtype == np.uint8
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[4] == w[4]
        np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("name", ["render_clip", "render_phoneme_clip",
                                  "render_multiface_clip"])
def test_render_functions_keep_their_signatures(name):
    assert inspect.signature(getattr(gen, name)) == inspect.signature(
        getattr(j_gen, name))


def test_envelope_clips_render_what_main_writes(tmp_path):
    clips, _ = _captured(gen, ["--output-dir", str(tmp_path), "--seconds",
                               "1.0", "--n-per-class", "2", "--seed", "7",
                               "--hard-negatives"], tmp_path)
    memory = list(gen.envelope_clips(2, 1.0, 15.0, 16000, 7,
                                     hard_negatives=True))
    assert [m[0] for m in memory] == [c[0] for c in clips]
    for (_, frames, pcm), c in zip(memory, clips):
        np.testing.assert_array_equal(frames, c[1])
        np.testing.assert_array_equal(pcm, c[3])


def test_phoneme_pair_renders_what_write_phoneme_pair_writes(tmp_path):
    args = Namespace(sr=16000, fps=15.0, seconds=1.0, jitter=True,
                     no_head_motion=False)
    pair = gen.phoneme_pair(args, np.random.RandomState(4), 2)
    written = []
    with mock.patch.object(j_gen, "write_video",
                           lambda p, f, fps, pcm, sr: written.append(
                               (f, pcm))):
        j_gen.write_phoneme_pair(args, np.random.RandomState(4), tmp_path,
                                 tmp_path, 2)
    for (frames, pcm), (wf, wp) in zip(pair, written):
        np.testing.assert_array_equal(frames, wf)
        np.testing.assert_array_equal(pcm, wp)


# ── precompute ───────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Two real and two fake 2 s clips of the generator, muxed to .avi."""
    out = tmp_path_factory.mktemp("raw")
    gen.main(["--output-dir", str(out), "--n-per-class", "2", "--seconds",
              "2.0", "--seed", "5", "--jitter", "--hard-negatives"])
    return out


def _run_jax(argv, backend=None):
    """The JAX script's ``main`` on ``argv`` (it reads ``sys.argv``), with
    ``backend`` in place of its default detector."""
    real = j_pre.precompute_one

    def one(*args, **kwargs):
        if backend is not None:
            kwargs["backend"] = backend()
        return real(*args, **kwargs)

    with mock.patch.object(sys, "argv", ["precompute", *argv]), \
            mock.patch.object(j_pre, "precompute_one", one):
        j_pre.main()


def _stored(out):
    ds = LipSyncDataset(preprocessed_dir=out)
    return ds._manifest, [ds._load_tensors(r) for r in ds._manifest]


def _mel_float64(path, target_frames):
    """The log-mel chain of ``path``'s PCM in float64: centred 400-sample
    Hann frames at hop 160, power rFFT, 80 mel bands, dB to the clip's peak
    floored at -80, then cut or padded to ``target_frames``."""
    pcm = ingest.read_audio(path, sr=16000).astype(np.float64)
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(pcm, (200, 200)), 400)[::160][: 1 + len(pcm) // 160]
    power = np.abs(np.fft.rfft(
        frames * port_mel.hann_window(400).astype(np.float64), axis=-1)) ** 2
    ref = 10 * np.log10(np.maximum(
        power @ port_mel.mel_filterbank(16000, 400, 80).T.astype(np.float64),
        1e-10)).T
    ref = np.maximum(ref - ref.max(), -80.0)
    if target_frames is None:
        return ref
    return port_mel.pad_or_truncate_frames(ref, target_frames)


def _assert_same_store(port_dir, jax_dir, raw):
    port_recs, port_arrays = _stored(port_dir)
    jax_recs, jax_arrays = _stored(jax_dir)
    assert port_recs == jax_recs
    assert len(port_recs) == 4
    assert {r["source_path"] for r in port_recs} == {
        str(p) for p in raw.rglob("*.avi")}
    for rec, (pv, pa), (jv, ja) in zip(port_recs, port_arrays, jax_arrays):
        assert pv.dtype == jv.dtype and pv.shape == jv.shape
        assert pa.shape == ja.shape and pa.dtype == ja.dtype == np.float32
        if pv.dtype == np.uint8:
            assert np.abs(pv.astype(int) - jv.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(pv, jv, atol=1e-5, rtol=0)
        ref = _mel_float64(rec["source_path"],
                           pa.shape[1] if rec["precompute_mode"]
                           == "fixed_clip" else None)
        loud = ref > -60.0
        assert loud.mean() > 0.1
        assert np.abs(pa - ja)[loud].max() < 1e-3
        assert np.abs(pa - ref).max() <= 2.5e-3
        assert np.abs(ja - ref).max() <= 2.5e-3


CASES = {
    "full_sequence_npy_detector": ("full_sequence", "npy", True),
    "full_sequence_zarr_center": ("full_sequence", "zarr", False),
    "full_sequence_lmdb_center": ("full_sequence", "lmdb", False),
    "fixed_clip_npy_center": ("fixed_clip", "npy", False),
    "fixed_clip_zarr_detector": ("fixed_clip", "zarr", True),
    "fixed_clip_lmdb_detector": ("fixed_clip", "lmdb", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_precompute_matches_the_jax_script(tmp_path, raw_dir, case):
    mode, fmt, detect = CASES[case]
    argv = ["--data-dir", str(raw_dir), "--mode", mode, "--storage-format",
            fmt, "--video-frames", "8", "--audio-frames", "32"]
    if not detect:
        argv.append("--no-face-detection")
    counts = pre.main([*argv, "--output-dir", str(tmp_path / "p"), *CPU],
                      backend=FakeDetector(lambda i: [BOX]))
    _run_jax([*argv, "--output-dir", str(tmp_path / "j")],
             backend=lambda: JFake(lambda i: [BOX]))
    assert counts == {"new": 4, "failed": 0, "total": 4}
    _assert_same_store(tmp_path / "p", tmp_path / "j", raw_dir)


def test_precompute_resumes_by_source_path(tmp_path, raw_dir):
    raw = tmp_path / "raw"
    shutil.copytree(raw_dir, raw)
    extra = raw / "1_fake" / "fake_0001.avi"
    held = extra.rename(tmp_path / "held.avi")
    argv = ["--data-dir", str(raw), "--storage-format", "zarr",
            "--no-face-detection"]
    for out in ("p", "j"):
        args = [*argv, "--output-dir", str(tmp_path / out)]
        if out == "p":
            first = pre.main([*args, *CPU])
        else:
            _run_jax(args)
    assert first == {"new": 3, "failed": 0, "total": 3}
    held.rename(extra)
    again = pre.main([*argv, "--output-dir", str(tmp_path / "p"), *CPU])
    assert again == {"new": 1, "failed": 0, "total": 4}
    assert pre.main([*argv, "--output-dir", str(tmp_path / "p"),
                     *CPU]) == {"new": 0, "failed": 0, "total": 4}
    _run_jax([*argv, "--output-dir", str(tmp_path / "j")])
    _assert_same_store(tmp_path / "p", tmp_path / "j", raw)
    assert [r["key"] for r in _stored(tmp_path / "p")[0]] == [
        f"sample_{i:06d}" for i in range(4)]


def test_precompute_counts_unusable_files_as_failed(tmp_path, raw_dir):
    """An undecodable file, a clip without audio and a clip without a face
    track are counted as failed, as in the JAX script; the rest go on."""
    raw = tmp_path / "raw"
    shutil.copytree(raw_dir, raw)
    (raw / "0_real" / "broken.avi").write_bytes(b"not a video")
    from lipsync_tpu_torch.preprocessing.mux import write_video

    write_video(raw / "1_fake" / "mute.avi", synthetic_frames(20), 15.0)
    common = ["--data-dir", str(raw), "--storage-format", "npy"]
    counts = pre.main([*common, "--no-face-detection", "--output-dir",
                       str(tmp_path / "p"), *CPU])
    assert counts == {"new": 4, "failed": 2, "total": 4}
    no_faces = pre.main([*common, "--output-dir", str(tmp_path / "q"),
                         *CPU], backend=FakeDetector(lambda i: []))
    assert no_faces == {"new": 0, "failed": 6, "total": 0}


def test_validate_preprocessed_matches_the_jax_script(tmp_path, raw_dir,
                                                      capsys):
    pre.main(["--data-dir", str(raw_dir), "--output-dir", str(tmp_path),
              "--no-face-detection", *CPU])
    (tmp_path / "manifest.jsonl").open("a").write(json.dumps(
        {"key": "sample_missing", "label": 0, "source_path": "x",
         "precompute_mode": "full_sequence", "storage_format": "zarr"})
        + "\n")
    argv = ["--preprocessed-dir", str(tmp_path)]
    got = validate_preprocessed.main(argv)
    out_port = capsys.readouterr().out
    want = j_valpre.main(argv)
    out_jax = capsys.readouterr().out
    assert got == want == 1
    assert out_port == out_jax
    assert "4/5 samples load (labels: 2 real / 2 fake)" in out_port


# ── hygiene tools ────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("tree")
    (d / "a").mkdir()
    write_av_video(d / "a" / "one.avi", synthetic_frames(20, seed=1),
                   fps=15.0, pcm=speechish_pcm(1.4, seed=1))
    write_av_video(d / "two.avi", synthetic_frames(24, seed=2), fps=15.0,
                   pcm=speechish_pcm(1.6, seed=2))
    write_av_video(d / "three.avi", synthetic_frames(18, seed=3),
                   fps=15.0, pcm=speechish_pcm(1.2, seed=3))
    (d / "broken.mp4").write_bytes(b"not a video at all")
    return d


def _decoded(root):
    out = {}
    for p in sorted(root.rglob("*.avi")):
        out[p.relative_to(root).as_posix()] = (
            ingest.read_video(p, 15.0), ingest.read_audio(p, 16000))
    return out


def _assert_same_files(a, b):
    got, want = _decoded(a), _decoded(b)
    assert sorted(got) == sorted(want) and got
    for name in got:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        np.testing.assert_array_equal(got[name][1], want[name][1])


@pytest.mark.parametrize("face_check", [False, True])
def test_filter_corrupt_videos_matches_the_jax_script(tmp_path, tiny_tree,
                                                      face_check):
    moved = {}
    for side, fn in (("p", filter_corrupt_videos.main),
                     ("j", j_filter.main)):
        root = tmp_path / side
        shutil.copytree(tiny_tree, root / "data")
        argv = ["--data-dir", str(root / "data")]
        if not face_check:
            argv.append("--no-face-check")
        moved[side] = fn([*argv, *CPU] if side == "p" else argv)
    assert moved["p"] == moved["j"] >= 1
    for sub in ("data", "corruptedclips"):
        names = [sorted(p.relative_to(tmp_path / side / sub).as_posix()
                        for p in (tmp_path / side / sub).rglob("*"))
                 for side in ("p", "j")]
        assert names[0] == names[1]
    assert (tmp_path / "p" / "corruptedclips" / "broken.mp4").exists()


def test_convert_videos_matches_the_jax_script(tmp_path, tiny_tree):
    argv = ["--input-dir", str(tiny_tree), "--fps", "10"]
    n = convert_videos.main([*argv, "--output-dir", str(tmp_path / "p")])
    assert n == j_convert.main([*argv, "--output-dir",
                                str(tmp_path / "j")]) == 3
    _assert_same_files(tmp_path / "p", tmp_path / "j")


def test_generate_audio_swap_fakes_matches_the_jax_script(tmp_path,
                                                         tiny_tree):
    argv = ["--real-dir", str(tiny_tree), "--limit", "4", "--seed", "3"]
    made = generate_audio_swap_fakes.main(
        [*argv, "--output-dir", str(tmp_path / "p")])
    # The broken file fails each swap it is drawn into, in both.
    assert made == j_swap.main([*argv, "--output-dir",
                                str(tmp_path / "j")]) == 2
    _assert_same_files(tmp_path / "p", tmp_path / "j")
