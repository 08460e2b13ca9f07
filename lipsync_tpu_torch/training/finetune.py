"""Transfer learning: ``run_finetune(args, device=None)``.

Counterpart of ``training/finetune.py`` in the JAX package (the
reference's finetuning loop): a partial load of the base checkpoint that
keeps fresh weights where shapes differ, two phases (encoders frozen for
``--frozen-epochs``, then the whole model), AdamW parameter groups (head
1e-4, encoders 5e-5, weight decay 1e-4), a global-norm gradient clip of
1.0, a confusion matrix per epoch, a P(FAKE) threshold sweep 0.05-0.95
for F1, and ``best_frozen_loss`` / ``best_model_loss`` /
``best_model_accuracy`` / ``best_model_f1`` checkpoint directories with
the tuned threshold in their metadata.

The base checkpoint is a reference or port ``.pth`` state dict, or a port
checkpoint directory. The step runs on ``device`` (None: cuda:0, which
raises without CUDA), with TF32 off, and in a process group data-parallel
as ``run_training`` is (``train.py``): rank 0 writes the checkpoints and
the confusion matrices, and every rank takes rank 0's validation numbers.

    python -m lipsync_tpu_torch.training.finetune --checkpoint CKPT \\
        --preprocessed-dir DIR
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Iterable

import numpy as np
import torch

from lipsync_tpu_torch.models.bridge import unwrap_state_dict
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.training import checkpoints as ckpt_lib
from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
from lipsync_tpu_torch.training.steps import (
    LossConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training.train import (
    EpochData,
    agreed,
    make_eval_fn,
    run_entry,
    seed_ranks,
    to_device,
    train_epoch,
    validate,
)
from lipsync_tpu_torch.utils.device import DeviceLike
from lipsync_tpu_torch.utils.logger import get_logger
from lipsync_tpu_torch.utils.metrics import find_best_threshold

logger = get_logger(__name__)


def collect_val_probs(eval_fn, loader: Iterable[Dict],
                      device: torch.device) -> Dict[str, np.ndarray]:
    probs, labels = [], []
    for batch in loader:
        b = to_device(batch, device)
        logits = eval_fn(b["visual"], b["audio"]).float().cpu().numpy()
        probs.append(1 / (1 + np.exp(-logits)))
        labels.append(b["label"].float().cpu().numpy())
    if not probs:
        return {"prob_real": np.zeros(0), "label": np.zeros(0)}
    return {
        "prob_real": np.concatenate(probs),
        "label": np.concatenate(labels),
    }


def write_confusion_matrix(path: Path, probs: np.ndarray, labels: np.ndarray,
                           threshold: float, epoch: int) -> None:
    """Per-epoch confusion matrix text file."""
    pred_fake = (1 - probs) >= threshold
    true_fake = labels < 0.5
    tp = int(np.sum(pred_fake & true_fake))
    fp = int(np.sum(pred_fake & ~true_fake))
    fn = int(np.sum(~pred_fake & true_fake))
    tn = int(np.sum(~pred_fake & ~true_fake))
    path.write_text(
        f"Epoch {epoch} confusion matrix (threshold={threshold:.2f})\n"
        f"                 pred_fake  pred_real\n"
        f"true_fake        {tp:9d}  {fn:9d}\n"
        f"true_real        {fp:9d}  {tn:9d}\n"
    )


def load_base_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (raw or wrapped) or a port checkpoint
    directory, on the CPU. The JAX package's orbax directories need JAX
    and raise."""
    path = Path(path)
    if path.is_dir():
        if not ckpt_lib.is_checkpoint_dir(path):
            raise NotImplementedError(
                f"{path} is not a port checkpoint directory (orbax "
                "checkpoints need JAX)")
        return ckpt_lib.load_checkpoint(path)
    return dict(unwrap_state_dict(
        torch.load(path, map_location="cpu", weights_only=True)))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Finetune the lip-sync model")
    p.add_argument("--data-dir", type=Path, default=None)
    p.add_argument("--preprocessed-dir", type=Path, default=None)
    p.add_argument("--checkpoint", type=Path, required=True,
                   help="Base checkpoint (.pth or port checkpoint dir)")
    p.add_argument("--output-dir", type=Path, default=Path("weights_finetune"))
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--frozen-epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr-head", type=float, default=1e-4)
    p.add_argument("--lr-encoder", type=float, default=5e-5)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--video-frames", type=int, default=32)
    p.add_argument("--audio-frames", type=int, default=128)
    p.add_argument("--crop-size", type=int, default=96)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--device-augment", action="store_true",
                   help="Augment on the device inside the train step "
                        "(ops/augment.py) instead of the host loader thread")
    p.add_argument("--no-face-detection", action="store_true")
    p.add_argument("--device-cache", action="store_true",
                   help="Upload the whole preprocessed full_sequence "
                        "corpus to device memory once and gather finetune "
                        "windows on the device (training/device_cache.py). "
                        "Implies --device-augment; needs --preprocessed-dir "
                        "and a corpus that fits (10 GB cap)")
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    return p


def run_finetune(args, detector_backend=None,
                 device: DeviceLike = None) -> Dict[str, float]:
    return run_entry(run_finetune, _finetune, args, detector_backend, device)


def _finetune(args, detector_backend, dev: torch.device) -> Dict[str, float]:
    shard = mesh_lib.process_shard()
    seed_ranks(args.seed, shard)
    cfg = ModelConfig(
        video_frames=args.video_frames,
        crop_size=args.crop_size,
        audio_frames=args.audio_frames,
    )
    model = LipSyncModel(cfg).to(dev)
    logger.info("Finetuning on %s (rank %d of %d)", dev, mesh_lib.rank(),
                mesh_lib.world_size())

    data = EpochData(args, detector_backend, dev, shard)
    train_step = make_train_step(LossConfig(), augment_cfg=data.augment_cfg)

    def build(phase: int) -> TrainState:
        optimizer = PhaseOptimizer(
            model.named_parameters(), phase, args.lr_head, args.lr_encoder,
            kind="adamw", weight_decay=args.weight_decay,
            grad_clip=args.grad_clip,
        )
        return create_train_state(model, optimizer, args.seed, shard)

    # Partial checkpoint load (shape mismatches keep the fresh init).
    merged, skipped = ckpt_lib.load_checkpoint_partially(
        model.state_dict(), load_base_checkpoint(args.checkpoint))
    if skipped:
        logger.info("Partial load skipped %d mismatched tensors: %s",
                    len(skipped), skipped[:5])
    model.load_state_dict(merged)
    state = build(1)

    eval_fn = make_eval_fn(model)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    best = {"loss": float("inf"), "accuracy": -1.0, "f1": -1.0}
    phase = 1
    history = {}

    for epoch in range(args.epochs):
        if epoch == args.frozen_epochs and phase == 1:
            logger.info("Unfreezing encoders at epoch %d", epoch)
            phase = 3
            state = build(3)

        t0 = time.time()
        steps = train_epoch(train_step, state, data.train_batches(epoch), dev,
                            args.max_steps_per_epoch)
        train_loss = (float(np.mean([m["loss"] for m in steps]))
                      if steps else 0.0)

        if data.val_idx:
            val = validate(eval_fn, data.val_batches(), dev)
        else:
            val = {"loss": train_loss, "accuracy": 0.0,
                   "real_accuracy": 0.0, "fake_accuracy": 0.0}
        probs = collect_val_probs(eval_fn, data.val_batches(), dev)
        if probs["label"].size:
            fake_probs = 1.0 - probs["prob_real"]
            true_fake = probs["label"] < 0.5
            best_t, best_t_metrics = find_best_threshold(
                fake_probs, true_fake,
                thresholds=np.arange(0.05, 0.951, 0.05),
            )
            f1 = best_t_metrics["f1"]
            if mesh_lib.rank() == 0:
                write_confusion_matrix(
                    out / f"confusion_epoch_{epoch:03d}.txt",
                    probs["prob_real"], probs["label"], 0.5, epoch,
                )
        else:
            best_t, f1 = 0.5, 0.0
        val, best_t, f1 = agreed((val, float(best_t), float(f1)))

        logger.info(
            "Epoch %d (phase %d): train_loss=%.4f val_loss=%.4f "
            "val_acc=%.2f%% best_f1=%.4f@t=%.2f %.1fs",
            epoch, phase, train_loss, val["loss"], val["accuracy"] * 100,
            f1, best_t, time.time() - t0,
        )

        metadata = {
            "epoch": epoch, "phase": phase, "train_loss": train_loss,
            "val_loss": val["loss"], "val_accuracy": val["accuracy"],
            "best_f1": f1, "f1_threshold": best_t,
            "video_frames": cfg.video_frames,
            "audio_frames": cfg.audio_frames,
        }
        weights = model.state_dict()
        ckpt_lib.save_checkpoint(out / "latest", weights, metadata)
        if phase == 1 and val["loss"] < best["loss"]:
            ckpt_lib.save_checkpoint(out / "best_frozen_loss", weights,
                                     metadata)
        if val["loss"] < best["loss"]:
            best["loss"] = val["loss"]
            ckpt_lib.save_checkpoint(out / "best_model_loss", weights,
                                     metadata)
        if val["accuracy"] > best["accuracy"]:
            best["accuracy"] = val["accuracy"]
            ckpt_lib.save_checkpoint(out / "best_model_accuracy", weights,
                                     metadata)
        if f1 > best["f1"]:
            best["f1"] = f1
            ckpt_lib.save_checkpoint(out / "best_model_f1", weights,
                                     metadata)
        history = {"epoch": epoch, "val_loss": val["loss"],
                   "val_accuracy": val["accuracy"], "best_f1": f1}

    return history


def main() -> None:
    run_finetune(build_argparser().parse_args())


if __name__ == "__main__":
    main()
