"""Train and eval steps.

Counterpart of ``training/steps.py`` in the JAX package. The objective is
the reference training loop's: BCE-with-logits + ``contrastive_weight`` x
cross-modal contrastive + ``sync_weight`` x sync contrastive, whose
negatives come from a second forward on audio rolled in time by a shift
drawn per step from +-{5, 10, 15} mel frames.

One step runs both forwards, the three losses, the backward of every layer,
the optimizer and the BatchNorm statistics. As in the JAX step:

* the second (sync-negative) forward updates no BatchNorm statistics (JAX
  discards that forward's ``batch_stats``): it runs under
  :func:`~lipsync_tpu_torch.models.layers.frozen_batch_stats`;
* both forwards draw the same dropout masks (JAX hands both one dropout
  key): the device RNG's state is taken before the first and restored
  before the second;
* a uint8 ``visual`` becomes float / 255 inside the step, and an optional
  ``(B,)`` ``sample_mask`` removes padded rows from every loss and from the
  accuracy.

The state is the model (parameters and buffers), the optimizer and the
step count, plus two generators: one on the host for the shift, one on the
model's device for the augmentation draws. Dropout draws from the device's
default RNG, which the trainer seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from lipsync_tpu_torch.models.layers import frozen_batch_stats
from lipsync_tpu_torch.ops.augment import AugmentConfig, augment_batch
from lipsync_tpu_torch.training.losses import (
    bce_with_logits,
    cross_modal_contrastive_loss,
    sync_contrastive_loss,
)
from lipsync_tpu_torch.training.optimizers import PhaseOptimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: PhaseOptimizer
    generator: torch.Generator
    aug_generator: torch.Generator
    step: int = 0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (the reference's contrastive 0.1, sync 0.2)."""

    contrastive_weight: float = 0.1
    sync_weight: float = 0.2
    contrastive_temperature: float = 0.07
    contrastive_fake_margin: float = 0.10
    sync_shift_frames: Tuple[int, ...] = (5, 10, 15)


def create_train_state(model: torch.nn.Module, optimizer: PhaseOptimizer,
                       seed: int) -> TrainState:
    """A state over ``model`` (on its device): both generators seeded from
    ``seed``."""
    dev = next(model.parameters()).device
    return TrainState(
        model=model, optimizer=optimizer,
        generator=torch.Generator().manual_seed(seed),
        aug_generator=torch.Generator(device=dev).manual_seed(seed),
    )


def sync_shifts(loss_cfg: LossConfig) -> Tuple[int, ...]:
    shifts = tuple(s for s in loss_cfg.sync_shift_frames if s != 0)
    return shifts + tuple(-s for s in shifts)


def _rng_state(dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda":
        return torch.cuda.get_rng_state(dev)
    return torch.get_rng_state()


def _set_rng_state(dev: torch.device, state: torch.Tensor) -> None:
    if dev.type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def make_train_step(
    loss_cfg: LossConfig = LossConfig(),
    augment_cfg: Optional[AugmentConfig] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(state, batch, shift=None) -> metrics``. ``batch`` holds
    device tensors ``visual`` (B, T, H, W, 3) float in [0, 1] or uint8,
    ``audio`` (B, F, Ta, 1), ``label`` (B,) with 1 = REAL, and optionally
    ``sample_mask`` (B,). With ``augment_cfg`` the batch augments on the
    device first. ``shift`` (mel frames) is drawn from ``state.generator``
    when None. The metrics are detached device scalars: ``loss``, ``bce``,
    ``contrastive``, ``sync``, ``accuracy``."""
    shifts = sync_shifts(loss_cfg)
    use_sync = loss_cfg.sync_weight > 0 and len(shifts) > 0

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   shift: Optional[int] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        visual, audio = batch["visual"], batch["audio"]
        if visual.dtype == torch.uint8:
            visual = visual.float() / 255.0
        if augment_cfg is not None and augment_cfg.enabled:
            with torch.no_grad():
                visual, audio = augment_batch(state.aug_generator, visual,
                                              audio, augment_cfg)
        if shift is None and use_sync:
            pick = torch.randint(len(shifts), (), generator=state.generator)
            shift = shifts[int(pick)]
        labels = batch["label"].float()
        sample_mask = batch.get("sample_mask")

        dropout_rng = _rng_state(visual.device)
        logits, aux = model(visual, audio, return_aux=True)
        bce = bce_with_logits(logits, labels, sample_mask=sample_mask)
        cm = cross_modal_contrastive_loss(
            aux["visual_tokens"], aux["audio_tokens"], labels,
            temperature=loss_cfg.contrastive_temperature,
            fake_margin=loss_cfg.contrastive_fake_margin,
            sample_mask=sample_mask,
        )
        loss = bce + loss_cfg.contrastive_weight * cm

        sync = torch.zeros((), device=logits.device)
        if use_sync:
            _set_rng_state(visual.device, dropout_rng)
            with frozen_batch_stats(model):
                _, aux_neg = model(visual, torch.roll(audio, shift, dims=2),
                                   return_aux=True)
            real_mask = labels >= 0.5
            if sample_mask is not None:
                real_mask = real_mask & (sample_mask > 0)
            sync = sync_contrastive_loss(
                aux["visual_tokens"], aux["audio_tokens"],
                [aux_neg["audio_tokens"]], real_mask=real_mask,
                temperature=loss_cfg.contrastive_temperature,
            )
            loss = loss + loss_cfg.sync_weight * sync

        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1

        with torch.no_grad():
            correct = ((torch.sigmoid(logits) > 0.5).float()
                       == labels).float()
            if sample_mask is None:
                acc = correct.mean()
            else:
                m = sample_mask.float()
                acc = (correct * m).sum() / m.sum().clamp(min=1.0)
        return {"loss": loss.detach(), "bce": bce.detach(),
                "contrastive": cm.detach(), "sync": sync.detach(),
                "accuracy": acc}

    return train_step


def make_eval_step(model: torch.nn.Module):
    """Forward-only step returning logits (eval-mode BatchNorm, no
    dropout)."""

    def eval_step(visual: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(visual, audio)

    return eval_step
