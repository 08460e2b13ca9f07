"""The port's device-resident dataset cache against the JAX package's, on
the CPU: the same clips, windows, masks and labels from the same host
draws, and ``run_training`` / ``run_finetune`` with ``--device-cache``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from lipsync_tpu.training.data import LipSyncDataset as JaxDataset
from lipsync_tpu.training.device_cache import DeviceDatasetCache as JaxCache
from lipsync_tpu_torch.training import checkpoints as ckpt
from lipsync_tpu_torch.training.data import LipSyncDataset
from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache

torch.set_num_threads(1)

VF, AF = 16, 64
TINY = ["--video-frames", "4", "--audio-frames", "16", "--crop-size", "8"]


@pytest.fixture()
def pre_dir(tmp_path):
    """Six full_sequence clips, one shorter than the window and one with a
    short mel track (both tail-pad paths)."""
    rng = np.random.RandomState(0)
    out = tmp_path / "pre"
    out.mkdir()
    records = []
    shapes = [(40, 280), (40, 280), (12, 80), (40, 280), (25, 160),
              (40, 107)]
    for i, (t, ta) in enumerate(shapes):
        key = f"sample_{i:06d}"
        np.save(out / f"{key}_visual.npy",
                rng.randint(0, 255, (t, 8, 8, 3)).astype(np.uint8))
        np.save(out / f"{key}_audio.npy",
                (rng.rand(80, ta).astype(np.float32) * 80) - 80)
        records.append({
            "key": key, "source_path": f"/src/{key}.mp4", "label": i % 2,
            "visual_relpath": f"{key}_visual.npy",
            "audio_relpath": f"{key}_audio.npy",
            "precompute_mode": "full_sequence",
            "target_fps": 15.0, "mel_hz": 100.0,
        })
    (out / "manifest.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records))
    return out


def _caches(pre_dir):
    kw = dict(preprocessed_dir=pre_dir, video_frames=VF, audio_frames=AF,
              uint8_visual=True)
    return (DeviceDatasetCache(LipSyncDataset(**kw), device="cpu"),
            JaxCache(JaxDataset(**kw)))


@pytest.mark.parametrize("train", [False, True])
def test_batches_match_jax(pre_dir, train):
    port, ref = _caches(pre_dir)
    got = list(port.batches(range(6), 4, rng=np.random.RandomState(3),
                            train_mode=train))
    want = list(ref.batches(range(6), 4, rng=np.random.RandomState(3),
                            train_mode=train))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == torch.from_numpy(np.array(w[k])).dtype, k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=0, err_msg=k)
    if train:
        assert got[-1]["sample_mask"].tolist() == [1, 1, 0, 0]
    else:
        assert got[-1]["visual"].shape[0] == 2


def test_eval_batches_match_host_sampler(pre_dir):
    port, _ = _caches(pre_dir)
    ds = LipSyncDataset(preprocessed_dir=pre_dir, video_frames=VF,
                        audio_frames=AF, uint8_visual=True)
    batches = list(port.batches(range(len(ds)), 4, train_mode=False))
    got_v = torch.cat([b["visual"] for b in batches]).numpy()
    got_a = torch.cat([b["audio"][..., 0] for b in batches]).numpy()
    for i in range(len(ds)):
        visual, audio, label = ds._load_preprocessed(
            i, train_mode_override=False)
        np.testing.assert_array_equal(got_v[i], visual)
        np.testing.assert_allclose(got_a[i], audio, rtol=0, atol=1e-6)


def test_train_start_sampling_spans_clip(pre_dir):
    port, _ = _caches(pre_dir)
    rng = np.random.RandomState(1)
    host_visual = np.load(pre_dir / "sample_000000_visual.npy")
    seen = set()
    for _ in range(12):
        b = next(iter(port.batches([0], 1, rng=rng, train_mode=True)))
        win = b["visual"][0].numpy()
        for s in range(40 - VF + 1):
            if np.array_equal(win, host_visual[s: s + VF]):
                seen.add(s)
                break
    assert len(seen) > 1


def test_cache_refusals(pre_dir, monkeypatch):
    ds = LipSyncDataset(preprocessed_dir=pre_dir, video_frames=VF,
                        audio_frames=AF)
    with pytest.raises(TypeError, match="mesh"):  # a ProcessShard or None
        DeviceDatasetCache(ds, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="too large"):
        DeviceDatasetCache(ds, max_bytes=1000, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceDatasetCache(ds)


def test_train_and_finetune_cli_with_device_cache(pre_dir, tmp_path):
    from lipsync_tpu_torch.training.finetune import (
        build_argparser as ft_parser,
    )
    from lipsync_tpu_torch.training.finetune import run_finetune
    from lipsync_tpu_torch.training.train import build_argparser, run_training

    history = run_training(build_argparser().parse_args([
        "--preprocessed-dir", str(pre_dir),
        "--output-dir", str(tmp_path / "w"), "--epochs", "1",
        "--batch-size", "8", *TINY, "--phase2-start-epoch", "0",
        "--phase3-start-epoch", "0", "--device-cache",
        "--val-split", "0.34"]), device="cpu")
    assert history["epoch"] == 0 and np.isfinite(history["val_loss"])
    assert ckpt.is_checkpoint_dir(tmp_path / "w" / "latest")

    history = run_finetune(ft_parser().parse_args([
        "--preprocessed-dir", str(pre_dir),
        "--checkpoint", str(tmp_path / "w" / "latest"),
        "--output-dir", str(tmp_path / "ft"), "--epochs", "1",
        "--frozen-epochs", "0", "--batch-size", "8", *TINY,
        "--device-cache", "--val-split", "0.34"]), device="cpu")
    assert np.isfinite(history["val_loss"])
    assert ckpt.is_checkpoint_dir(tmp_path / "ft" / "best_model_f1")


def test_ragged_cache_batches_run_the_train_step(tmp_path):
    """Ten clips at batch 8: one full batch and one padded with a mask of
    two rows; the step runs on both and its metrics stay finite."""
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
    from lipsync_tpu_torch.training import steps
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer

    rng = np.random.RandomState(1)
    out = tmp_path / "pre32"
    out.mkdir()
    records = []
    for i in range(10):
        key = f"sample_{i:06d}"
        np.save(out / f"{key}_visual.npy",
                rng.randint(0, 255, (12, 32, 32, 3)).astype(np.uint8))
        np.save(out / f"{key}_audio.npy",
                (rng.rand(80, 80).astype(np.float32) * 80) - 80)
        records.append({
            "key": key, "label": i % 2, "visual_relpath": f"{key}_visual.npy",
            "audio_relpath": f"{key}_audio.npy",
            "precompute_mode": "full_sequence", "target_fps": 15.0,
            "mel_hz": 100.0,
        })
    (out / "manifest.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records))
    cache = DeviceDatasetCache(
        LipSyncDataset(preprocessed_dir=out, video_frames=4, audio_frames=16,
                       uint8_visual=True), device="cpu")
    batches = list(cache.batches(range(10), 8, rng=np.random.RandomState(0),
                                 train_mode=True))
    assert len(batches) == 2 and batches[1]["sample_mask"].sum() == 2
    torch.manual_seed(0)
    model = LipSyncModel(ModelConfig(video_frames=4, crop_size=32,
                                     audio_frames=16))
    state = steps.create_train_state(
        model, PhaseOptimizer(model.named_parameters(), 3, 1e-3, 1e-3), 0)
    step = steps.make_train_step(steps.LossConfig())
    for b in batches:
        metrics = step(state, b)
        assert all(torch.isfinite(v) for v in metrics.values())
