"""The port's training data pipeline, optimizers, checkpoints and the
``run_training`` / ``run_finetune`` entry points, against the JAX package.

Items, batches and loader order are compared with the JAX package's on the
same corpus: npy, zarr (zarrlite) and lmdb (kvlite) stores written by the
JAX package's tooling, and raw videos muxed by ``tests/fixtures``. The
phase optimizers are fed one gradient sequence on both sides and held
within 1e-6 of optax. The entry points run on the CPU at a tiny geometry
(no JAX train step is compiled here): they must write the JAX package's
checkpoint set and metadata, and what they write must serve through the
port's ``load_engine`` and load into the JAX model through its own
``load_torch_checkpoint`` with the same logits.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu.training import data as jdata
from lipsync_tpu.training import optimizers as jopt
from lipsync_tpu.utils import kvlite as jkvlite
from lipsync_tpu.utils import zarrlite as jzarrlite
from lipsync_tpu_torch.training import checkpoints as ckpt
from lipsync_tpu_torch.training import data as tdata
from lipsync_tpu_torch.training import optimizers as topt
from tests.fixtures import speechish_pcm, synthetic_frames, write_av_video

torch.set_num_threads(1)

# The JAX package's checkpoint metadata keys (train.py, finetune.py).
TRAIN_META = {"epoch", "phase", "train_loss", "train_accuracy", "val_loss",
              "val_accuracy", "best_val_loss", "best_val_accuracy",
              "video_frames", "audio_frames", "crop_size"}
FINETUNE_META = {"epoch", "phase", "train_loss", "val_loss", "val_accuracy",
                 "best_f1", "f1_threshold", "video_frames", "audio_frames"}
TINY = ["--video-frames", "4", "--audio-frames", "16", "--crop-size", "8"]


# ── corpora ──────────────────────────────────────────────────────────────


def _write_corpus(out: Path, fmt: str, n: int = 6, mode="full_sequence",
                  seed: int = 0) -> Path:
    """A preprocessed corpus in ``fmt`` (npy / zarr / lmdb), written with
    the JAX package's stores."""
    rng = np.random.RandomState(seed)
    out.mkdir(parents=True)
    records, tensors = [], {}
    for i in range(n):
        key = f"sample_{i:06d}"
        t = 40 if mode == "full_sequence" else 16
        visual = rng.randint(0, 255, (t, 8, 8, 3)).astype(np.uint8)
        audio = (rng.rand(80, 280 if mode == "full_sequence" else 64)
                 .astype(np.float32) * 80) - 80
        if mode == "fixed_clip":
            visual = visual.astype(np.float32) / 255.0
        tensors[key] = (visual, audio)
        rec = {"key": key, "source_path": f"/src/{key}.mp4", "label": i % 2,
               "precompute_mode": mode, "target_fps": 15.0, "mel_hz": 100.0,
               "storage_format": fmt}
        if fmt == "npy":
            np.save(out / f"{key}_visual.npy", visual)
            np.save(out / f"{key}_audio.npy", audio)
            rec.update(visual_relpath=f"{key}_visual.npy",
                       audio_relpath=f"{key}_audio.npy")
        records.append(rec)
    if fmt == "zarr":
        root = jzarrlite.open_group(out / "samples.zarr", mode="w")
        for key, (v, a) in tensors.items():
            grp = root.require_group(key)
            grp.create_array("visual", v, chunks=(7,) + v.shape[1:])
            grp.create_array("audio", a)
    elif fmt == "lmdb":
        env = jkvlite.open(out / "samples.lmdb")
        with env.begin(write=True) as txn:
            for key, (v, a) in tensors.items():
                buf = io.BytesIO()
                np.savez_compressed(buf, visual=v, audio=a)
                txn.put(key.encode(), buf.getvalue())
        env.close()
    (out / "manifest.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records))
    return out


@pytest.fixture()
def preprocessed_dir(tmp_path):
    return _write_corpus(tmp_path / "pre", "npy")


# ── discovery + windowing ────────────────────────────────────────────────


def test_discover_matches_jax(tmp_path):
    (tmp_path / "a" / "0_real").mkdir(parents=True)
    (tmp_path / "a" / "1_fake").mkdir()
    (tmp_path / "a" / "0_real" / "a.mp4").write_bytes(b"x")
    (tmp_path / "a" / "1_fake" / "b.MOV").write_bytes(b"x")
    for d in ("wav2lip_out", "natural_clips", "misc"):
        (tmp_path / "b" / d).mkdir(parents=True)
        (tmp_path / "b" / d / f"{d}.avi").write_bytes(b"x")
    for root in ("a", "b"):
        got = tdata.discover_video_samples(tmp_path / root)
        assert got == jdata.discover_video_samples(tmp_path / root)
    assert {p.name.lower(): lab for p, lab in
            tdata.discover_video_samples(tmp_path / "a")} == {
        "a.mp4": 1, "b.mov": 0}


@pytest.mark.parametrize("t_total,a_total,train", [
    (90, 600, False), (90, 600, True), (20, 140, True), (33, 107, False),
])
def test_sample_aligned_clip_matches_jax(t_total, a_total, train):
    rng = np.random.RandomState(t_total)
    visual = rng.randint(0, 255, (t_total, 8, 8, 3)).astype(np.uint8)
    audio = np.tile(np.arange(a_total, dtype=np.float32), (80, 1))
    for keep_uint8 in (False, True):
        got = tdata.sample_aligned_contiguous_clip(
            visual, audio, train_mode=train, keep_uint8=keep_uint8,
            rng=np.random.RandomState(5))
        want = jdata.sample_aligned_contiguous_clip(
            visual, audio, train_mode=train, keep_uint8=keep_uint8,
            rng=np.random.RandomState(5))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_sample_aligned_clip_short_raises():
    visual = np.zeros((10, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="too short"):
        tdata.sample_aligned_contiguous_clip(
            visual, np.zeros((80, 100), np.float32), video_frames=32)


def test_safe_collate_matches_jax():
    s = (np.ones((4, 8, 8, 3), np.float32), np.zeros((80, 16), np.float32),
         np.float32(1))
    u = (np.ones((4, 8, 8, 3), np.uint8), np.zeros((80, 16), np.float32),
         np.float32(0))
    for samples in ([s, None, s], [u, u]):
        got, want = tdata.safe_collate(samples), jdata.safe_collate(samples)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert tdata.safe_collate([None, None]) is None


# ── preprocessed dataset + loader ────────────────────────────────────────


@pytest.mark.parametrize("fmt,mode", [
    ("npy", "full_sequence"), ("zarr", "full_sequence"),
    ("lmdb", "full_sequence"), ("npy", "fixed_clip"), ("lmdb", "fixed_clip"),
])
def test_preprocessed_items_match_jax(tmp_path, fmt, mode):
    out = _write_corpus(tmp_path / fmt, fmt, mode=mode)
    kw = dict(preprocessed_dir=out, video_frames=16, audio_frames=64)
    for uint8 in (False, True):
        port = tdata.LipSyncDataset(uint8_visual=uint8, **kw)
        ref = jdata.LipSyncDataset(uint8_visual=uint8, **kw)
        assert port.storage_format == ref.storage_format == fmt
        assert port.samples == ref.samples
        for i in range(len(ref)):
            for train in (False, True):
                np.random.seed(i)
                got = port.get_item(i, train_mode_override=train)
                np.random.seed(i)
                want = ref.get_item(i, train_mode_override=train)
                for g, w in zip(got, want):
                    assert np.asarray(g).dtype == np.asarray(w).dtype
                    np.testing.assert_array_equal(g, w)


def test_wheel_written_lmdb_is_refused(tmp_path):
    out = _write_corpus(tmp_path / "l", "lmdb")
    (out / "samples.lmdb").write_bytes(b"\0" * 64)
    ds = tdata.LipSyncDataset(preprocessed_dir=out)
    with pytest.raises(RuntimeError, match="kvlite"):
        ds._load_tensors(ds._manifest[0])


@pytest.mark.parametrize("augment", [False, True])
def test_batch_loader_matches_jax(preprocessed_dir, augment):
    """Same seed: the same order, windows and (host) augmentations."""
    kw = dict(preprocessed_dir=preprocessed_dir, video_frames=16,
              audio_frames=64)

    def batches(mod):
        loader = mod.BatchLoader(
            mod.LipSyncDataset(**kw), batch_size=4, shuffle=True, seed=3,
            augment=mod.Augmentations() if augment else None,
            train_mode_override=False)
        return list(loader)

    got = batches(tdata)  # cv2 visible on both sides: both rotate with it
    want = batches(jdata)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)


def test_loader_skips_failed_samples(preprocessed_dir):
    ds = tdata.LipSyncDataset(preprocessed_dir=preprocessed_dir,
                              video_frames=16, audio_frames=64)
    (preprocessed_dir / "sample_000002_visual.npy").write_bytes(b"garbage")
    loader = tdata.BatchLoader(ds, batch_size=2, shuffle=False)
    assert sum(b["label"].shape[0] for b in loader) == 5


def test_loader_augment_crash_raises_not_hangs(preprocessed_dir):
    class _Boom:
        def __call__(self, visual, audio, rng=None):
            raise RuntimeError("augment boom")

    ds = tdata.LipSyncDataset(preprocessed_dir=preprocessed_dir,
                              video_frames=16, audio_frames=64)
    loader = tdata.BatchLoader(ds, batch_size=2, shuffle=False,
                               augment=_Boom())
    with pytest.raises(RuntimeError, match="augment boom"):
        list(loader)


def test_loader_early_break_does_not_leak_producer(preprocessed_dir):
    ds = tdata.LipSyncDataset(preprocessed_dir=preprocessed_dir,
                              video_frames=16, audio_frames=64)
    before = threading.active_count()
    for _ in range(3):
        for _batch in tdata.BatchLoader(ds, batch_size=1, shuffle=False,
                                        prefetch=1):
            break
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("face_detection", [False, True])
def test_raw_video_items_match_jax(tmp_path, face_detection):
    """Raw mode: native ingest, (detection and tracking), crops and the
    log-mel; the port's on the CPU (its K1 twin), the JAX package's XLA
    mel. Tolerances: crops 1e-5 (as the engine tests), mel 1e-3 dB."""
    for sub, seed in (("0_real", 1), ("1_fake", 2)):
        (tmp_path / sub).mkdir()
        write_av_video(tmp_path / sub / f"clip{seed}.avi",
                       synthetic_frames(n=20, seed=seed),
                       pcm=speechish_pcm(seconds=20 / 15.0, seed=seed))
    kw = dict(data_dir=tmp_path, video_frames=8, audio_frames=32,
              require_face_detection=face_detection)
    port = tdata.LipSyncDataset(device="cpu", **kw)
    ref = jdata.LipSyncDataset(**kw)
    assert port.samples == ref.samples
    for i in range(len(ref)):
        got, want = port.get_item(i), ref.get_item(i)
        assert got is not None and want is not None
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
        assert got[2] == want[2]


def test_raw_mode_asks_for_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.LipSyncDataset(data_dir=tmp_path)


# ── phase optimizers ─────────────────────────────────────────────────────


def _named_params(seed=0):
    rng = np.random.RandomState(seed)
    return {f"{m}.w": rng.randn(3, 4).astype(np.float32)
            for m in ("visual_encoder", "audio_encoder", "classifier")}


def _grads(step, scale_frozen=1.0, scale_head=1.0, seed=0):
    rng = np.random.RandomState(100 * seed + step)
    g = {}
    for name in _named_params():
        s = scale_head if name.startswith("classifier") else scale_frozen
        g[name] = (rng.randn(3, 4) * s).astype(np.float32)
    return g


def _run_both(phase, kind, clip, grads_of, steps=5, lr=(1e-3, 3e-4)):
    init = _named_params()
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = topt.PhaseOptimizer(params.items(), phase, *lr, kind=kind,
                                    weight_decay=1e-2, grad_clip=clip)
    tree = {k.split(".")[0]: {"w": jnp.asarray(v)} for k, v in init.items()}
    tx = jopt.make_phase_optimizer(phase, *lr, kind=kind, weight_decay=1e-2,
                                   grad_clip=clip)
    state = tx.init(tree)
    for s in range(steps):
        g = grads_of(s)
        opt.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        jg = {k.split(".")[0]: {"w": jnp.asarray(v)} for k, v in g.items()}
        updates, state = tx.update(jg, state, tree)
        tree = optax.apply_updates(tree, updates)
    return init, params, tree


@pytest.mark.parametrize("phase", [1, 2, 3])
@pytest.mark.parametrize("kind,clip", [("adam", None), ("adam", 1.0),
                                       ("adamw", None), ("adamw", 1.0)])
def test_phase_optimizer_matches_optax(phase, kind, clip):
    init, params, tree = _run_both(phase, kind, clip,
                                   lambda s: _grads(s, 3.0, 3.0))
    trained = topt.trainable_labels(phase)
    for name, p in params.items():
        want = np.asarray(tree[name.split(".")[0]]["w"])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6)
        if topt.label_of(name) not in trained:
            assert np.array_equal(p.detach().numpy(), init[name]), name
        else:
            assert not np.array_equal(p.detach().numpy(), init[name]), name


def test_global_norm_counts_frozen_gradients():
    """Phase 1 with a clip: tiny head gradients (near Adam's eps) and large
    frozen ones. optax clips by the norm of all of them, so the head's
    update shrinks; the port must agree, and differ from a clip over the
    head alone."""
    grads = lambda s: _grads(s, scale_frozen=10.0, scale_head=1e-8)
    _, params, tree = _run_both(1, "adam", 1.0, grads)
    _, unclipped, _ = _run_both(1, "adam", None, grads)
    got = params["classifier.w"].detach().numpy()
    np.testing.assert_allclose(got, np.asarray(tree["classifier"]["w"]),
                               rtol=0, atol=1e-6)
    assert np.abs(got - unclipped["classifier.w"].detach().numpy()).max() \
        > 1e-5


def test_plateau_scheduler_matches_jax():
    """Halves after more than ``patience`` (5) bad epochs, clips at 1e-7."""
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in _named_params().items()}
    opt = topt.PhaseOptimizer(params.items(), 3, 1.5e-7, 1e-4)
    tx = jopt.make_phase_optimizer(3, 1.5e-7, 1e-4)
    state = tx.init({k.split(".")[0]: {"w": jnp.asarray(v)}
                     for k, v in _named_params().items()})
    port, ref = topt.ReduceLROnPlateau(), jopt.ReduceLROnPlateau()
    seen = []
    for metric in [1.0] + [2.0] * 6 + [3.0] * 6:
        port.step(metric, opt)
        state = ref.step(metric, state)
        seen.append(topt.current_learning_rate(opt))
        assert seen[-1] == pytest.approx(jopt.current_learning_rate(state),
                                         rel=1e-6)
    assert seen[5] == pytest.approx(1.5e-7) and seen[6] == pytest.approx(1e-7)
    # Two halvings of the encoders' 1e-4 (epochs 7 and 13).
    assert [g["lr"] for g in opt.param_groups] == pytest.approx(
        [1e-7, 2.5e-5, 2.5e-5])


def test_label_params_matches_jax():
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig

    model = LipSyncModel(ModelConfig(video_frames=4, crop_size=8,
                                     audio_frames=16))
    by_label = topt.label_params(model.named_parameters())
    tops = {n.split(".")[0] for n, _ in model.named_parameters()}
    jlabels = jopt.label_params({t: {"w": 0} for t in tops})
    for name, p in model.named_parameters():
        want = jlabels[name.split(".")[0]]["w"]
        assert any(p is q for q in by_label[want]), name


# ── checkpoints ──────────────────────────────────────────────────────────


def test_checkpoint_roundtrip_and_partial_load(tmp_path):
    sd = {"a.weight": torch.randn(3, 2), "b.bias": torch.randn(4),
          "c.running_var": torch.rand(5)}
    ckpt.save_checkpoint(tmp_path / "c", sd, {"epoch": 3})
    assert ckpt.is_checkpoint_dir(tmp_path / "c")
    back = ckpt.load_checkpoint(tmp_path / "c")
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    assert ckpt.load_metadata(tmp_path / "c") == {"epoch": 3}
    assert ckpt.load_metadata(tmp_path / "none") == {}
    fresh = {"a.weight": torch.zeros(3, 2), "b.bias": torch.zeros(7),
             "d.new": torch.zeros(1)}
    merged, skipped = ckpt.load_checkpoint_partially(fresh, back)
    assert skipped == ["b.bias"]
    assert torch.equal(merged["a.weight"], sd["a.weight"])
    assert torch.equal(merged["b.bias"], fresh["b.bias"])
    assert torch.equal(merged["d.new"], fresh["d.new"])


# ── the entry points, end to end on the CPU ──────────────────────────────


def _train_args(pre, out, *extra):
    from lipsync_tpu_torch.training.train import build_argparser

    return build_argparser().parse_args([
        "--preprocessed-dir", str(pre), "--output-dir", str(out),
        "--batch-size", "2", "--val-split", "0.34", *TINY, *extra])


def test_train_then_finetune_end_to_end(preprocessed_dir, tmp_path):
    """Three epochs with phase changes at 1 and 2 and host augmentation,
    then a finetune with an unfreeze at epoch 1. Phase 1 leaves the
    encoders' parameters bit-unchanged but moves their BatchNorm
    statistics; phase 2 moves audio and not visual."""
    from lipsync_tpu_torch.training.finetune import (
        build_argparser as ft_parser,
    )
    from lipsync_tpu_torch.training.finetune import run_finetune
    from lipsync_tpu_torch.training.train import run_training

    out = tmp_path / "w"
    saved = {}
    real_save = ckpt.save_checkpoint

    def spy(path, state_dict, metadata=None):
        if Path(path).name == "latest":
            saved[metadata["epoch"]] = {k: v.clone()
                                        for k, v in state_dict.items()}
        real_save(path, state_dict, metadata)

    with mock.patch.object(ckpt, "save_checkpoint", spy):
        history = run_training(_train_args(
            preprocessed_dir, out, "--epochs", "3",
            "--phase2-start-epoch", "1", "--phase3-start-epoch", "2"),
            device="cpu")
    assert history["epoch"] == 2 and np.isfinite(history["val_loss"])
    for name in ("latest", "best_model_loss", "best_model_accuracy"):
        assert ckpt.is_checkpoint_dir(out / name), name
        assert set(ckpt.load_metadata(out / name)) == TRAIN_META
    meta = ckpt.load_metadata(out / "latest")
    assert meta["video_frames"] == 4 and meta["phase"] == 3

    def changed(a, b, prefix, stats=False):
        keys = [k for k in a if k.startswith(prefix)
                and (("running_" in k) == stats)
                and "num_batches" not in k]
        return [k for k in keys if not torch.equal(a[k], b[k])], keys

    torch.manual_seed(42)  # run_training's initial weights
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig

    init = LipSyncModel(ModelConfig(video_frames=4, crop_size=8,
                                    audio_frames=16)).state_dict()
    for enc in ("visual_encoder.", "audio_encoder."):
        assert changed(init, saved[0], enc)[0] == [], enc
        assert changed(init, saved[0], enc, stats=True)[0], enc
    assert changed(init, saved[0], "classifier.")[0]
    assert changed(saved[0], saved[1], "audio_encoder.")[0]
    assert changed(saved[0], saved[1], "visual_encoder.")[0] == []
    assert changed(saved[1], saved[2], "visual_encoder.")[0]

    ft = tmp_path / "ft"
    ft_history = run_finetune(ft_parser().parse_args([
        "--preprocessed-dir", str(preprocessed_dir),
        "--checkpoint", str(out / "latest"), "--output-dir", str(ft),
        "--epochs", "2", "--frozen-epochs", "1", "--batch-size", "2",
        *TINY, "--no-augment"]), device="cpu")
    assert ft_history["epoch"] == 1
    for name in ("latest", "best_frozen_loss", "best_model_f1"):
        assert set(ckpt.load_metadata(ft / name)) == FINETUNE_META, name
    assert (ft / "confusion_epoch_000.txt").exists()
    assert 0.05 <= ckpt.load_metadata(ft / "latest")["f1_threshold"] <= 0.95
    # A .pth base checkpoint (the reference's format) loads the same way.
    torch.save({"model_state_dict": ckpt.load_checkpoint(out / "latest")},
               tmp_path / "base.pth")
    run_finetune(ft_parser().parse_args([
        "--preprocessed-dir", str(preprocessed_dir),
        "--checkpoint", str(tmp_path / "base.pth"),
        "--output-dir", str(tmp_path / "ft2"), "--epochs", "1",
        "--batch-size", "2", *TINY, "--no-augment",
        "--max-steps-per-epoch", "1"]), device="cpu")
    assert ckpt.is_checkpoint_dir(tmp_path / "ft2" / "best_model_f1")


def test_training_resume(preprocessed_dir, tmp_path):
    from lipsync_tpu_torch.training.train import run_training

    out = tmp_path / "w"
    run_training(_train_args(preprocessed_dir, out, "--epochs", "1",
                             "--no-augment", "--phase2-start-epoch", "1"),
                 device="cpu")
    meta1 = ckpt.load_metadata(out / "latest")
    assert meta1["epoch"] == 0 and meta1["phase"] == 1
    history = run_training(_train_args(
        preprocessed_dir, out, "--epochs", "2", "--no-augment",
        "--phase2-start-epoch", "1", "--resume", str(out / "latest")),
        device="cpu")
    assert history["epoch"] == 1
    meta2 = ckpt.load_metadata(out / "latest")
    assert meta2["epoch"] == 1 and meta2["phase"] == 2
    assert meta2["best_val_accuracy"] >= meta1["best_val_accuracy"]


def test_device_augment_training(preprocessed_dir, tmp_path):
    from lipsync_tpu_torch.training.train import run_training

    history = run_training(_train_args(
        preprocessed_dir, tmp_path / "w", "--epochs", "1",
        "--phase3-start-epoch", "0", "--device-augment"), device="cpu")
    assert np.isfinite(history["val_loss"])


def test_trained_checkpoint_serves_in_both_packages(preprocessed_dir,
                                                    tmp_path):
    """What the port's trainer writes serves through the port's
    ``load_engine`` and ``Predictor``, and loads into the JAX model through
    the JAX package's ``load_torch_checkpoint`` with the same logits."""
    from lipsync_tpu.models import LipSyncModel as JaxModel
    from lipsync_tpu.models import ModelConfig as JaxConfig
    from lipsync_tpu.models import load_torch_checkpoint
    from lipsync_tpu_torch.inference import Predictor, load_engine
    from lipsync_tpu_torch.inference.engine import _to_uint8
    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.training.train import run_training

    out = tmp_path / "w"
    run_training(_train_args(preprocessed_dir, out, "--epochs", "1",
                             "--no-augment", "--phase2-start-epoch", "0",
                             "--phase3-start-epoch", "0"), device="cpu")
    geo = dict(video_frames=4, crop_size=8, audio_frames=16)
    engine = load_engine(out / "best_model_loss", ModelConfig(**geo),
                         device="cpu")
    rng = np.random.RandomState(0)
    visual = rng.rand(3, 4, 8, 8, 3).astype(np.float32)
    audio = (rng.rand(3, 80, 16).astype(np.float32) * 80) - 80
    got = engine.score_logits(visual, audio)

    variables = load_torch_checkpoint(str(out / "best_model_loss" /
                                          ckpt.WEIGHTS_FILE))
    pixels = _to_uint8(visual).astype(np.float32) / np.float32(255)
    with jax.default_matmul_precision("highest"):
        want = JaxModel(JaxConfig(**geo)).apply(
            variables, jnp.asarray(pixels),
            jnp.asarray(audio[..., None]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    pred = Predictor(model_path=out / "best_model_loss",
                     model_config=ModelConfig(**geo), device="cpu")
    assert pred.engine.config.crop_size == 8


def test_orbax_directory_raises(tmp_path):
    from lipsync_tpu_torch.inference import load_engine
    from lipsync_tpu_torch.training.finetune import load_base_checkpoint

    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        load_engine(tmp_path / "orbax", device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        load_base_checkpoint(tmp_path / "orbax")


def test_synthetic_corpus_reads_as_a_training_corpus(tmp_path):
    """``utils/synthetic.py::write_corpus`` (the corpus that the card tests
    of ``tests/test_torch_training_card.py`` train on) is a full_sequence
    corpus that both packages read alike."""
    from lipsync_tpu_torch.utils import synthetic

    out = synthetic.write_corpus(tmp_path / "c", n_clips=4, n_frames=20,
                                 crop_size=16, device="cpu")
    port = tdata.LipSyncDataset(preprocessed_dir=out, video_frames=8,
                                audio_frames=32, uint8_visual=True)
    ref = jdata.LipSyncDataset(preprocessed_dir=out, video_frames=8,
                               audio_frames=32, uint8_visual=True)
    assert [lab for _, lab in port.samples] == [1, 0, 1, 0]
    for i in range(4):
        got = port.get_item(i, train_mode_override=False)
        want = ref.get_item(i, train_mode_override=False)
        assert got[0].shape == (8, 16, 16, 3) and got[0].dtype == np.uint8
        assert got[1].shape == (80, 32)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
