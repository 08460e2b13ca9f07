"""The port's data-parallel trainer end to end at 2 and 4 gloo ranks:
``DeviceDatasetCache`` with a mesh, ``run_training`` (device cache and host
loader) and ``run_finetune``, each against the port in one process on the
same corpus and seed, and the cache's sharded batches against the JAX
package's cache on a mesh of the same size.

The ranks run in processes spawned by ``parallel.mesh.run_group`` (a
``file://`` store under ``tmp_path``, a timeout on the group's start and on
the join) and import nothing of JAX; this module imports JAX only in the
test that reads the JAX cache. The JAX trainers draw their initial weights
and dropout from JAX keys, so their runs are compared with the port's by
what they write (checkpoint names and metadata keys,
``test_torch_training_pipeline.py``), not number by number; the JAX mesh's
numbers are held at the step (``test_torch_parallel_jax_step.py``).

Tolerances against the port in one process: cache batches equal; train
and validation losses and accuracies 1e-4 relative; weights within 2 lr
per step taken (an Adam step moves a weight by about lr times the sign of
its gradient, which rounding decides where the gradient is near zero) and
BatchNorm statistics within 1e-3 of max(1, their largest).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import checkpoints as ckpt
from lipsync_tpu_torch.training.data import LipSyncDataset
from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache

torch.set_num_threads(1)

TINY = ["--video-frames", "4", "--audio-frames", "16", "--crop-size", "8"]
JOIN_TIMEOUT_S = 240.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")
TRAIN_META = {"epoch", "phase", "train_loss", "train_accuracy", "val_loss",
              "val_accuracy", "best_val_loss", "best_val_accuracy",
              "video_frames", "audio_frames", "crop_size"}
FINETUNE_META = {"epoch", "phase", "train_loss", "val_loss", "val_accuracy",
                 "best_f1", "f1_threshold", "video_frames", "audio_frames"}


def _corpus(out: Path, n: int = 10) -> Path:
    """``n`` full_sequence clips of 40 8x8 frames, npy."""
    rng = np.random.RandomState(0)
    out.mkdir(parents=True)
    records = []
    for i in range(n):
        key = f"sample_{i:06d}"
        np.save(out / f"{key}_visual.npy",
                rng.randint(0, 255, (40, 8, 8, 3)).astype(np.uint8))
        np.save(out / f"{key}_audio.npy",
                (rng.rand(80, 280).astype(np.float32) * 80) - 80)
        records.append({
            "key": key, "source_path": f"/src/{key}.mp4", "label": i % 2,
            "visual_relpath": f"{key}_visual.npy",
            "audio_relpath": f"{key}_audio.npy",
            "precompute_mode": "full_sequence", "target_fps": 15.0,
            "mel_hz": 100.0})
    (out / "manifest.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records))
    return out


def _runs(pre: Path, out: Path):
    """(name, entry point, arguments) of the three end-to-end runs: 10
    clips, 2 for validation, one epoch of 2 batches of 4 (one or two rows
    per rank): the device cache in phase 3, the host loader with host
    augmentation in phase 1, and a finetune that unfreezes at once."""
    from lipsync_tpu_torch.training import finetune, train

    common = ["--preprocessed-dir", str(pre), "--batch-size", "4",
              "--val-split", "0.2", *TINY]
    return [
        ("train_cache", train.run_training, train.build_argparser()
         .parse_args(common + ["--output-dir", str(out / "train_cache"),
                               "--epochs", "1", "--phase2-start-epoch", "0",
                               "--phase3-start-epoch", "0",
                               "--device-cache"])),
        ("train_host", train.run_training, train.build_argparser()
         .parse_args(common + ["--output-dir", str(out / "train_host"),
                               "--epochs", "1"])),
        ("finetune", finetune.run_finetune, finetune.build_argparser()
         .parse_args(common + ["--output-dir", str(out / "finetune"),
                               "--checkpoint", str(pre.parent / "base"),
                               "--epochs", "1", "--frozen-epochs", "0",
                               "--device-cache"])),
    ]


def _cache_batches(pre: Path, shard=None):
    ds = LipSyncDataset(preprocessed_dir=pre, video_frames=4,
                        audio_frames=16, uint8_visual=True)
    cache = DeviceDatasetCache(ds, mesh=shard, device="cpu")
    train = cache.batches(range(10), 8, rng=np.random.RandomState(0),
                          train_mode=True)
    evals = cache.batches(range(10), 8, train_mode=False)
    return [[{k: v.numpy() for k, v in b.items()} for b in it]
            for it in (train, evals)]


def _rank_trainer(rank, device, tmp, pre):
    from lipsync_tpu_torch.training import train

    torch.set_num_threads(1)
    out = {"cache": _cache_batches(Path(pre), mesh_lib.process_shard())}
    # --device-cache with a group refuses a batch that does not split.
    try:
        train.EpochData(train.build_argparser().parse_args(
            ["--preprocessed-dir", pre, "--batch-size", "3", "--device-cache",
             *TINY]), None, torch.device("cpu"), mesh_lib.process_shard())
        out["refused_batch_3"] = False
    except SystemExit:
        out["refused_batch_3"] = True
    for name, entry, args in _runs(Path(pre), Path(tmp) / "out"):
        out[name] = entry(args, device="cpu")
    out["modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in FORBIDDEN or m == "lipsync_tpu"
        or m.startswith("lipsync_tpu."))
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _seeded(entry, args):
    """A one-process run with the host numpy RNG seeded as the trainer
    seeds it in a group (the loader draws its windows from it)."""
    np.random.seed(args.seed)
    return entry(args, device="cpu")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    from lipsync_tpu_torch.training import train

    tmp = tmp_path_factory.mktemp("dp_trainer")
    pre = _corpus(tmp / "pre")
    base = train.build_argparser().parse_args([
        "--preprocessed-dir", str(pre), "--output-dir", str(tmp / "b"),
        "--epochs", "1", "--batch-size", "4", *TINY])
    _seeded(train.run_training, base)
    (tmp / "b" / "latest").rename(tmp / "base")
    runs = {name: _seeded(entry, args)
            for name, entry, args in _runs(pre, tmp / "single")}
    return tmp, pre, runs


@pytest.fixture(scope="module", params=[2, 4])
def world(request, single):
    tmp_single, pre, _ = single
    tmp = tmp_single / f"world{request.param}"
    tmp.mkdir()
    t0 = time.perf_counter()
    mesh_lib.run_group(_rank_trainer, request.param, "cpu",
                       f"file://{tmp}/store", args=(str(tmp), str(pre)),
                       join_timeout_s=JOIN_TIMEOUT_S)
    print(f"world {request.param}: {time.perf_counter() - t0:.1f} s")
    yield request.param, tmp, [torch.load(tmp / f"rank{r}.pt",
                                          weights_only=False)
                               for r in range(request.param)]
    shutil.rmtree(tmp)  # the checkpoints are large


def test_cache_batches_are_the_ranks_rows(world, single):
    """Train batches come out as each rank's block of the one-process
    cache's batches (the ragged one padded and masked first); eval batches
    stay whole; the trainer refuses a cache batch that does not split over
    the ranks, as the JAX package's does over its mesh."""
    n, _, ranks = world
    train, evals = _cache_batches(single[1])
    for r, res in enumerate(ranks):
        assert not res["modules"], res["modules"]
        assert res["refused_batch_3"], r
        got_train, got_eval = res["cache"]
        assert len(got_train) == len(train) == 2
        for g, w in zip(got_train, train):
            rows = mesh_lib.shard_rows(w, r, n)
            assert set(g) == set(rows)
            for k in rows:
                np.testing.assert_array_equal(g[k], rows[k])
        for g, w in zip(got_eval, evals):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_cache_batches_match_the_jax_mesh_cache(world, single):
    """The JAX package's cache on a mesh of the same size gathers the same
    global batches; each rank holds its block of them."""
    import jax

    from lipsync_tpu.parallel import mesh as jmesh
    from lipsync_tpu.training.data import LipSyncDataset as JDataset
    from lipsync_tpu.training.device_cache import (
        DeviceDatasetCache as JCache,
    )

    n, _, ranks = world
    ds = JDataset(preprocessed_dir=single[1], video_frames=4,
                  audio_frames=16, uint8_visual=True)
    cache = JCache(ds, mesh=jmesh.make_mesh(n))
    want = list(cache.batches(range(10), 8, rng=np.random.RandomState(0),
                              train_mode=True))
    for b in want:
        assert len(b["visual"].sharding.device_set) == n
    for r, res in enumerate(ranks):
        for g, w in zip(res["cache"][0], want):
            rows = mesh_lib.shard_rows(
                {k: np.asarray(jax.device_get(v)) for k, v in w.items()},
                r, n)
            for k in rows:
                np.testing.assert_allclose(g[k], rows[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["train_cache", "train_host", "finetune"])
def test_end_to_end_matches_one_process(world, single, name):
    n, tmp, ranks = world
    want = single[2][name]
    for res in ranks:  # every rank returns rank 0's validation numbers
        got = res[name]
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got, want)
    meta_keys = FINETUNE_META if name == "finetune" else TRAIN_META
    mine, ref = tmp / "out" / name, single[0] / "single" / name
    assert sorted(p.name for p in mine.iterdir()) == sorted(
        p.name for p in ref.iterdir())
    assert set(ckpt.load_metadata(mine / "latest")) == meta_keys
    got, want_sd = (ckpt.load_checkpoint(d / "latest") for d in (mine, ref))
    steps = 2  # 8 training clips in batches of 4, one epoch
    lr = 1e-4
    for k, v in want_sd.items():
        d = float((got[k].double() - v.double()).abs().max())
        if "running" in k:
            assert d <= 1e-3 * max(1.0, float(v.abs().max())), (k, d)
        elif v.is_floating_point():
            assert d <= 2 * lr * steps, (k, d)
        else:
            assert d == 0, k


def test_trainers_turn_tf32_off(single, tmp_path):
    from lipsync_tpu_torch.training import finetune, train

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    pre = single[1]
    common = ["--preprocessed-dir", str(pre), "--batch-size", "4",
              "--epochs", "1", "--max-steps-per-epoch", "1", *TINY]
    try:
        for entry, args in (
                (train.run_training, train.build_argparser().parse_args(
                    common + ["--output-dir", str(tmp_path / "t")])),
                (finetune.run_finetune, finetune.build_argparser()
                 .parse_args(common + ["--output-dir", str(tmp_path / "f"),
                                       "--checkpoint",
                                       str(single[0] / "base")]))):
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            entry(args, device="cpu")
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _raises(rank, device):
    if rank == 1:
        raise ValueError("rank 1 failed")
    time.sleep(120)  # still running when its peer fails: it is stopped


def _hangs(rank, device):
    time.sleep(120)


def test_group_failures_end_the_group(tmp_path):
    """A rank that raises fails the run with its error, and a group that
    does not finish in time is killed: neither hangs the caller."""
    from torch.multiprocessing import ProcessRaisedException

    t0 = time.perf_counter()
    with pytest.raises(ProcessRaisedException, match="rank 1 failed"):
        mesh_lib.run_group(_raises, 2, "cpu", f"file://{tmp_path}/a",
                           join_timeout_s=60)
    with pytest.raises(TimeoutError):
        mesh_lib.run_group(_hangs, 2, "cpu", f"file://{tmp_path}/b",
                           join_timeout_s=5)
    assert time.perf_counter() - t0 < 60
