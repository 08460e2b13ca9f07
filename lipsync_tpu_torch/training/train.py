"""From-scratch training: ``run_training(args, device=None)``.

Counterpart of ``training/train.py`` in the JAX package (the reference's
training loop): BCE + 0.1 x cross-modal contrastive + 0.2 x sync
contrastive, three-phase encoder freezing (head only -> + audio encoder
at ``--phase2-start-epoch`` -> the whole model at ``--phase3-start-epoch``
with the encoder learning rate), Adam + ``ReduceLROnPlateau(0.5, 5)``,
``latest`` / ``best_model_loss`` / ``best_model_accuracy`` checkpoint
directories with input-geometry metadata, accuracy early stopping, and a
phase-aware optimizer rebuild on ``--resume``.

A phase change rebuilds the optimizer with fresh state and keeps the
parameters and BatchNorm statistics. The step runs on ``device`` (None:
cuda:0, which raises without CUDA; the CPU only when asked), with TF32 off.

Data parallelism, as the JAX package's mesh over every device it sees
(``parallel/mesh.py``): inside a ``torch.distributed`` group (the one that
``python -m torch.distributed.run`` sets up, which the trainer joins, or
one the caller opened) every rank builds the same global batch, pads it to
a multiple of the group's size under a ``sample_mask`` and trains on its
contiguous block; the step reduces over the group, so every rank holds the
same weights. With ``device=None`` on a host with several cards and no
group, the trainer starts one process per card itself. Rank 0 writes the
checkpoints; every rank takes rank 0's validation numbers.

    python -m lipsync_tpu_torch.training.train --preprocessed-dir DIR
    python -m torch.distributed.run --nproc_per_node=N \
        -m lipsync_tpu_torch.training.train --preprocessed-dir DIR
"""

from __future__ import annotations

import argparse
import json
import socket
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.ops.augment import AugmentConfig
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import checkpoints as ckpt_lib
from lipsync_tpu_torch.training.data import (
    Augmentations,
    BatchLoader,
    LipSyncDataset,
)
from lipsync_tpu_torch.training.losses import bce_with_logits
from lipsync_tpu_torch.training.optimizers import (
    PhaseOptimizer,
    ReduceLROnPlateau,
    current_learning_rate,
)
from lipsync_tpu_torch.training.steps import (
    LossConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from lipsync_tpu_torch.utils.device import (
    DeviceLike,
    disable_tf32,
    get_device,
)
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def phase_for_epoch(epoch: int, phase2_start: int, phase3_start: int) -> int:
    if epoch < phase2_start:
        return 1
    if epoch < phase3_start:
        return 2
    return 3


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A host (numpy) or device batch as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v))
            .to(device) for k, v in batch.items()}


def run_entry(entry: Callable, body: Callable, args, detector_backend,
              device: DeviceLike) -> Dict:
    """What ``run_training`` and ``run_finetune`` share around their
    ``body(args, detector_backend, device)``: TF32 off; under
    ``torch.distributed.run`` its group joined (``cuda:LOCAL_RANK``, or the
    CPU when the caller asks for it) and left when done; and, where the
    JAX package would train on a mesh and nothing has set one up (no
    device asked for, several cards, no group), ``entry`` on every card."""
    if (device is None and torch.cuda.is_available()
            and torch.cuda.device_count() > 1
            and not mesh_lib.initialized()
            and not mesh_lib.launched_by_torchrun()):
        return on_every_card(entry, args, detector_backend)
    dev = get_device(device)
    disable_tf32()
    joined = mesh_lib.launched_by_torchrun() and not mesh_lib.initialized()
    if joined:
        dev = mesh_lib.join_from_environment(dev.type)
    try:
        return body(args, detector_backend, dev)
    finally:
        if joined:
            mesh_lib.leave_group()


def _card_rank(rank: int, device: torch.device, entry: Callable, args,
               out: str) -> None:
    history = entry(args, device=device)
    if rank == 0:
        Path(out, "history.json").write_text(json.dumps(history))


def on_every_card(entry: Callable, args, detector_backend) -> Dict:
    """``entry(args, device=cuda:r)`` in one process per card, in one NCCL
    group; returns rank 0's history."""
    if detector_backend is not None:
        raise ValueError("a detector backend does not cross to the "
                         "trainer's spawned ranks; pass none, or start the "
                         "ranks with torch.distributed.run")
    with socket.socket() as sock:  # a free port for the group's store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.run_group(_card_rank, torch.cuda.device_count(), "cuda",
                           f"tcp://localhost:{port}",
                           args=(entry, args, tmp), join_timeout_s=None)
        return json.loads(Path(tmp, "history.json").read_text())


def seed_ranks(seed: int, shard: Optional[mesh_lib.ProcessShard]) -> None:
    """Seed the initial weights and dropout, the same on every rank
    (dropout draws the global batch's masks, ``layers.batch_shard``). In a
    group the host's numpy RNG is seeded too: the loader draws its windows
    from it, and every rank must build the same global batch."""
    torch.manual_seed(seed)
    if shard is not None:
        np.random.seed(seed)


def rank_rows(batch: Dict, shard: Optional[mesh_lib.ProcessShard]) -> Dict:
    """A host batch's rows for this rank: the global batch padded to a
    multiple of the group under a ``sample_mask``, then this rank's
    block (the whole batch outside a group)."""
    if shard is None or isinstance(next(iter(batch.values())),
                                   torch.Tensor):
        return batch  # outside a group, or already this rank's (the cache)
    padded = mesh_lib.pad_batch_to_multiple(batch, shard.world)
    return mesh_lib.shard_rows(padded, shard.rank, shard.world)


def agreed(value):
    """Rank 0's ``value`` on every rank (``value`` outside a group), so
    that every rank takes the same decisions from it."""
    if not mesh_lib.initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def make_eval_fn(model: LipSyncModel):
    """``eval_fn(visual, audio) -> logits`` in eval mode (K2 runs in the
    artifact branch); uint8 pixels are normalised first."""
    step = make_eval_step(model)

    def eval_fn(visual: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        if visual.dtype == torch.uint8:
            visual = visual.float() / 255.0
        return step(visual, audio)

    return eval_fn


def validate(eval_fn, loader: Iterable[Dict],
             device: torch.device) -> Dict[str, float]:
    """Loss, accuracy and per-class accuracy over ``loader``'s batches."""
    losses, correct, total = [], 0, 0
    class_correct = {0: 0, 1: 0}
    class_total = {0: 0, 1: 0}
    for batch in loader:
        b = to_device(batch, device)
        logits = eval_fn(b["visual"], b["audio"]).float().cpu()
        labels_t = b["label"].float().cpu()
        losses.append(float(bce_with_logits(logits, labels_t)))
        logits, labels = logits.numpy(), labels_t.numpy()
        preds = (1 / (1 + np.exp(-logits)) > 0.5).astype(np.float32)
        correct += int((preds == labels).sum())
        total += len(labels)
        for cls in (0, 1):
            mask = labels == cls
            class_correct[cls] += int((preds[mask] == cls).sum())
            class_total[cls] += int(mask.sum())
    return {
        "loss": float(np.mean(losses)) if losses else 0.0,
        "accuracy": correct / total if total else 0.0,
        "real_accuracy": (
            class_correct[1] / class_total[1] if class_total[1] else 0.0
        ),
        "fake_accuracy": (
            class_correct[0] / class_total[0] if class_total[0] else 0.0
        ),
    }


class EpochData:
    """``args``' corpus split into train and validation indices, and their
    batches: from two host ``BatchLoader``s, or with ``--device-cache``
    gathered from the corpus in device memory (which implies
    ``--device-augment``). ``augment_cfg`` is the train step's device
    augmentation: None where the host loader augments or nothing does.
    ``run_training`` and ``run_finetune`` share it."""

    def __init__(self, args, detector_backend, device: torch.device,
                 shard: Optional[mesh_lib.ProcessShard] = None):
        self.batch_size, self.seed = args.batch_size, args.seed
        use_cache = bool(getattr(args, "device_cache", False))
        device_augment = (
            bool(getattr(args, "device_augment", False)) or use_cache
        )
        dataset = LipSyncDataset(
            data_dir=args.data_dir,
            preprocessed_dir=args.preprocessed_dir,
            video_frames=args.video_frames,
            audio_frames=args.audio_frames,
            detector_backend=detector_backend,
            require_face_detection=not args.no_face_detection,
            # With device-side augmentation the host ships raw uint8 windows.
            uint8_visual=device_augment,
            device=device,
        )
        n = len(dataset)
        perm = np.random.RandomState(args.seed).permutation(n)
        n_val = max(1, int(n * args.val_split)) if n > 1 else 0
        self.val_idx = perm[:n_val].tolist()
        self.train_idx = perm[n_val:].tolist()
        logger.info("Dataset: %d samples (%d train / %d val)",
                    n, len(self.train_idx), len(self.val_idx))
        self.augment_cfg = (AugmentConfig()
                            if device_augment and not args.no_augment
                            else None)
        self.cache = None
        if use_cache:
            if not dataset.use_preprocessed:
                raise SystemExit("--device-cache requires --preprocessed-dir")
            if shard is not None and args.batch_size % shard.world:
                raise SystemExit(
                    f"--device-cache with {shard.world} ranks needs "
                    f"--batch-size divisible by {shard.world}")
            from lipsync_tpu_torch.training.device_cache import (
                DeviceDatasetCache,
            )

            self.cache = DeviceDatasetCache(dataset, mesh=shard,
                                            device=device)
            return
        host_augment = not args.no_augment and not device_augment
        self.train_loader = BatchLoader(
            dataset, batch_size=args.batch_size, shuffle=True,
            seed=args.seed, indices=self.train_idx,
            augment=Augmentations() if host_augment else None,
            train_mode_override=True,
        )
        self.val_loader = BatchLoader(
            dataset, batch_size=args.batch_size, shuffle=False,
            indices=self.val_idx, train_mode_override=False,
        )

    def train_batches(self, epoch: int) -> Iterable[Dict]:
        if self.cache is None:
            return self.train_loader
        # Per-epoch host RNG: only (batch,) index/start arrays cross to the
        # device; the windows gather there.
        return self.cache.batches(
            self.train_idx, self.batch_size,
            rng=np.random.RandomState(self.seed * 100003 + epoch),
            train_mode=True,
        )

    def val_batches(self) -> Iterable[Dict]:
        """A fresh eval-mode iterator (the cache's are one-shot)."""
        if self.cache is None:
            return self.val_loader
        return self.cache.batches(self.val_idx, self.batch_size,
                                  train_mode=False)


def train_epoch(train_step, state: TrainState, batches: Iterable[Dict],
                device: torch.device,
                max_steps: Optional[int] = None) -> List[Dict[str, float]]:
    """One epoch of ``train_step`` over ``batches`` (at most ``max_steps``):
    each step's metrics as floats (the global batch's, in a group)."""
    out = []
    for batch in batches:
        batch = rank_rows(batch, state.shard)
        metrics = train_step(state, to_device(batch, device))
        out.append({k: float(v) for k, v in metrics.items()})
        if max_steps is not None and len(out) >= max_steps:
            break
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the lip-sync model")
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--preprocessed-dir", type=Path, default=None)
    p.add_argument("--output-dir", type=Path, default=Path("weights"))
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-encoder", type=float, default=1e-5)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--video-frames", type=int, default=32)
    p.add_argument("--audio-frames", type=int, default=128)
    p.add_argument("--crop-size", type=int, default=96)
    p.add_argument("--phase2-start-epoch", type=int, default=5)
    p.add_argument("--phase3-start-epoch", type=int, default=15)
    p.add_argument("--contrastive-weight", type=float, default=0.1)
    p.add_argument("--sync-weight", type=float, default=0.2)
    p.add_argument("--early-stopping-patience", type=int, default=None)
    p.add_argument("--resume", type=Path, default=None)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--device-augment", action="store_true",
                   help="Augment on the device inside the train step "
                        "(ops/augment.py) instead of on the host loader "
                        "thread")
    p.add_argument("--no-face-detection", action="store_true")
    p.add_argument("--device-cache", action="store_true",
                   help="Upload the whole preprocessed full_sequence "
                        "corpus to device memory once and gather training "
                        "windows on the device (training/device_cache.py): "
                        "the host ships only per-batch index arrays. "
                        "Implies --device-augment; the corpus must fit "
                        "(10 GB cap)")
    p.add_argument("--no-artifact-branch", action="store_true",
                   help="Train without the artifact detector "
                        "(ModelConfig.detect_artifacts=False)")
    p.add_argument("--max-steps-per-epoch", type=int, default=None,
                   help="Debug cap on steps per epoch")
    p.add_argument("--device", default=None,
                   help="torch device (default: every card, one process "
                        "each; cuda:0 on a one-card host; 'cpu' to run on "
                        "the CPU)")
    return p


def run_training(args, detector_backend=None,
                 device: DeviceLike = None) -> Dict[str, float]:
    return run_entry(run_training, _train, args, detector_backend, device)


def _train(args, detector_backend, dev: torch.device) -> Dict[str, float]:
    shard = mesh_lib.process_shard()
    seed_ranks(args.seed, shard)
    cfg = ModelConfig(
        video_frames=args.video_frames,
        crop_size=args.crop_size,
        audio_frames=args.audio_frames,
        detect_artifacts=not getattr(args, "no_artifact_branch", False),
    )
    model = LipSyncModel(cfg).to(dev)
    logger.info("Training on %s (rank %d of %d)", dev, mesh_lib.rank(),
                mesh_lib.world_size())

    data = EpochData(args, detector_backend, dev, shard)
    loss_cfg = LossConfig(
        contrastive_weight=args.contrastive_weight,
        sync_weight=args.sync_weight,
    )
    train_step = make_train_step(loss_cfg, augment_cfg=data.augment_cfg)

    def build(phase: int) -> TrainState:
        optimizer = PhaseOptimizer(
            model.named_parameters(), phase, args.lr, args.lr_encoder,
            kind="adam",
        )
        return create_train_state(model, optimizer, args.seed, shard)

    start_epoch = 0
    best = {"loss": float("inf"), "accuracy": -1.0}
    if args.resume is not None:
        meta = ckpt_lib.load_metadata(args.resume)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best["loss"] = float(meta.get("best_val_loss", float("inf")))
        best["accuracy"] = float(meta.get("best_val_accuracy", -1.0))
        model.load_state_dict(ckpt_lib.load_checkpoint(args.resume))
        phase = phase_for_epoch(
            start_epoch, args.phase2_start_epoch, args.phase3_start_epoch
        )
        logger.info("Resumed from %s at epoch %d (phase %d)",
                    args.resume, start_epoch, phase)
    else:
        phase = phase_for_epoch(
            0, args.phase2_start_epoch, args.phase3_start_epoch
        )
    state = build(phase)

    eval_fn = make_eval_fn(model)  # every rank validates the whole split
    scheduler = ReduceLROnPlateau(factor=0.5, patience=5)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    epochs_without_improvement = 0
    history = {}

    for epoch in range(start_epoch, args.epochs):
        new_phase = phase_for_epoch(
            epoch, args.phase2_start_epoch, args.phase3_start_epoch
        )
        if new_phase != phase:
            logger.info("Phase transition %d -> %d (epoch %d): rebuilding "
                        "optimizer", phase, new_phase, epoch)
            phase = new_phase
            state = build(phase)
            scheduler = ReduceLROnPlateau(factor=0.5, patience=5)

        t0 = time.time()
        steps = train_epoch(train_step, state, data.train_batches(epoch), dev,
                            args.max_steps_per_epoch)
        train_loss = (float(np.mean([m["loss"] for m in steps]))
                      if steps else 0.0)
        train_acc = (float(np.mean([m["accuracy"] for m in steps]))
                     if steps else 0.0)

        if data.val_idx:
            val = agreed(validate(eval_fn, data.val_batches(), dev))
        else:
            val = {"loss": train_loss, "accuracy": train_acc,
                   "real_accuracy": 0.0, "fake_accuracy": 0.0}
        lr_now = current_learning_rate(state.optimizer)
        logger.info(
            "Epoch %d (phase %d): train_loss=%.4f train_acc=%.2f%% "
            "val_loss=%.4f val_acc=%.2f%% (real=%.2f%% fake=%.2f%%) "
            "lr=%.2e %.1fs",
            epoch, phase, train_loss, train_acc * 100, val["loss"],
            val["accuracy"] * 100, val["real_accuracy"] * 100,
            val["fake_accuracy"] * 100, lr_now or 0.0, time.time() - t0,
        )
        scheduler.step(val["loss"], state.optimizer)

        metadata = {
            "epoch": epoch,
            "phase": phase,
            "train_loss": train_loss,
            "train_accuracy": train_acc,
            "val_loss": val["loss"],
            "val_accuracy": val["accuracy"],
            "best_val_loss": min(best["loss"], val["loss"]),
            "best_val_accuracy": max(best["accuracy"], val["accuracy"]),
            "video_frames": cfg.video_frames,
            "audio_frames": cfg.audio_frames,
            "crop_size": cfg.crop_size,
        }
        weights = model.state_dict()
        ckpt_lib.save_checkpoint(out / "latest", weights, metadata)
        if val["loss"] < best["loss"]:
            best["loss"] = val["loss"]
            ckpt_lib.save_checkpoint(out / "best_model_loss", weights,
                                     metadata)
        if val["accuracy"] > best["accuracy"]:
            best["accuracy"] = val["accuracy"]
            epochs_without_improvement = 0
            ckpt_lib.save_checkpoint(out / "best_model_accuracy", weights,
                                     metadata)
        else:
            epochs_without_improvement += 1
        history = {"train_loss": train_loss, "val_loss": val["loss"],
                   "val_accuracy": val["accuracy"], "epoch": epoch}

        if (
            args.early_stopping_patience is not None
            and epochs_without_improvement >= args.early_stopping_patience
        ):
            logger.info("Early stopping at epoch %d (no accuracy "
                        "improvement for %d epochs)", epoch,
                        epochs_without_improvement)
            break

    return history


def main() -> None:
    args = build_argparser().parse_args()
    run_training(args, device=args.device)


if __name__ == "__main__":
    main()
