"""The raw-video dataset skips only what a host stage could not use.

``training/data.py::LipSyncDataset`` in raw-video mode (``--data-dir``)
decodes on the host and computes the crops and the log-mel (K1) on its
device. A file that ingest cannot read, or that has no audio, is a skipped
sample with a warning, as in the JAX package; a failing kernel, a CUDA
error or a shape fault propagates and ends ``run_training``. Preprocessed
mode runs no kernel and keeps its per-sample skip.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.preprocessing import audio as audio_mod
from lipsync_tpu_torch.preprocessing import video as video_mod
from lipsync_tpu_torch.preprocessing.mux import write_video
from lipsync_tpu_torch.training import data as tdata
from lipsync_tpu_torch.training import train as train_mod
from lipsync_tpu_torch.utils import synthetic

torch.set_num_threads(1)

GEOMETRY = ["--video-frames", "4", "--audio-frames", "16", "--crop-size",
            "8"]


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Two readable clips per class (1.5 s with audio)."""
    out = tmp_path_factory.mktemp("raw")
    for sub, seed in (("0_real", 1), ("0_real", 2), ("1_fake", 3),
                      ("1_fake", 4)):
        (out / sub).mkdir(exist_ok=True)
        write_video(out / sub / f"clip{seed}.avi",
                    synthetic.synthetic_frames(n=22, seed=seed), 15.0,
                    synthetic.speechish_pcm(22 / 15.0, seed=seed), 16000)
    return out


def _dataset(data_dir):
    return tdata.LipSyncDataset(data_dir=data_dir, video_frames=4,
                                audio_frames=16,
                                require_face_detection=False, device="cpu")


def _failing_k1(y, *args, **kwargs):
    raise RuntimeError("log_mel kernel launch failed: cudaError 700")


@pytest.fixture
def warnings():
    """The dataset logger's warnings while the test runs."""
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    tdata.logger.addHandler(handler)
    yield records
    tdata.logger.removeHandler(handler)


def test_a_failing_k1_ends_get_item(raw_dir, monkeypatch):
    ds = _dataset(raw_dir)
    assert ds.get_item(0) is not None
    monkeypatch.setattr(audio_mod, "log_mel_spectrogram_fused", _failing_k1)
    with pytest.raises(RuntimeError, match="log_mel kernel launch failed"):
        ds.get_item(0)
    assert ds._failed == {}


def test_a_failing_crop_ends_get_item(raw_dir, monkeypatch):
    """A fault on the device side of the crops (here a shape fault)
    propagates as K1's does."""
    def bad_crop(*args, **kwargs):
        raise ValueError("expected (N, H, W, 3) frames, got (22, 120)")

    monkeypatch.setattr(video_mod, "crop_track_on_device", bad_crop)
    with pytest.raises(ValueError, match="expected"):
        _dataset(raw_dir).get_item(1)


def test_a_failing_k1_ends_run_training(raw_dir, tmp_path, monkeypatch):
    """The loader's producer hands the kernel's exception to the trainer,
    which ends with it: the run does not train on nothing."""
    monkeypatch.setattr(audio_mod, "log_mel_spectrogram_fused", _failing_k1)
    args = train_mod.build_argparser().parse_args(
        ["--data-dir", str(raw_dir), "--output-dir", str(tmp_path / "w"),
         "--epochs", "1", "--batch-size", "2", "--max-steps-per-epoch", "1",
         *GEOMETRY])
    with pytest.raises(RuntimeError, match="log_mel kernel launch failed"):
        train_mod.run_training(args, device="cpu")
    assert not (tmp_path / "w" / "best_model_accuracy").exists()


def test_unreadable_and_silent_files_are_skipped(raw_dir, tmp_path,
                                                 warnings):
    """A file ingest cannot decode and a clip without an audio stream are
    skipped samples with a warning each; the readable clips load."""
    data = tmp_path / "data"
    for sub in ("0_real", "1_fake"):
        (data / sub).mkdir(parents=True)
        for clip in (raw_dir / sub).iterdir():
            (data / sub / clip.name).symlink_to(clip)
    (data / "1_fake" / "broken.avi").write_bytes(b"not a video")
    write_video(data / "0_real" / "silent.avi",
                synthetic.synthetic_frames(n=22, seed=9), 15.0)
    ds = _dataset(data)
    names = [p.name for p, _ in ds.samples]
    items = {name: ds.get_item(i) for i, name in enumerate(names)}
    assert items["broken.avi"] is None and items["silent.avi"] is None
    assert all(v is not None for k, v in items.items()
               if k not in ("broken.avi", "silent.avi"))
    assert sorted(ds._failed) == sorted(
        names.index(n) for n in ("broken.avi", "silent.avi"))
    messages = [r.getMessage() for r in warnings]
    assert len(messages) == 2
    assert any("Empty audio signal" in m for m in messages)


def test_preprocessed_failures_still_skip(tmp_path, warnings):
    """Preprocessed mode runs no kernel: a sample whose tensors cannot be
    read is skipped with a warning, as the JAX package's corpora expect."""
    pre = synthetic.write_corpus(tmp_path / "pre", n_clips=3, n_frames=12,
                                 crop_size=8, device="cpu")
    ds = tdata.LipSyncDataset(preprocessed_dir=pre, video_frames=4,
                              audio_frames=16)
    (Path(pre) / ds._manifest[1]["visual_relpath"]).unlink()
    items = [ds.get_item(i, train_mode_override=False) for i in range(3)]
    assert items[1] is None and items[0] is not None and items[2] is not None
    assert list(ds._failed) == [1]
    assert len(warnings) == 1
    assert np.isfinite(items[0][1]).all()
