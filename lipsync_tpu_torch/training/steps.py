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

Data parallelism (``state.shard``, a rank of a ``torch.distributed`` group):
each rank runs its contiguous block of the global batch, and the step
computes the JAX package's one program over the mesh. BatchNorm normalises
with the global batch (``models/layers.py``); augmentation and dropout draw
for the global batch and keep this rank's rows (every rank holds the same
generators); logits, labels, mask and tokens are gathered with their
gradients, so every rank computes the same global losses, counts and
metrics; each rank backpropagates ``loss / world`` and the gradients are
summed over the group before the optimizer (and its global-norm clip)
sees them (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from lipsync_tpu_torch.models.layers import (
    batch_shard,
    frozen_batch_stats,
    set_process_group,
)
from lipsync_tpu_torch.ops.augment import (
    AugmentConfig,
    apply_augment,
    draw_augment,
)
from lipsync_tpu_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_grads,
)
from lipsync_tpu_torch.parallel.mesh import ProcessShard
from lipsync_tpu_torch.training.losses import (
    bce_with_logits,
    cross_modal_contrastive_loss,
    sync_contrastive_loss,
)
from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
from lipsync_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: PhaseOptimizer
    generator: torch.Generator
    aug_generator: torch.Generator
    step: int = 0
    shard: Optional[ProcessShard] = None


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (the reference's contrastive 0.1, sync 0.2)."""

    contrastive_weight: float = 0.1
    sync_weight: float = 0.2
    contrastive_temperature: float = 0.07
    contrastive_fake_margin: float = 0.10
    sync_shift_frames: Tuple[int, ...] = (5, 10, 15)


def create_train_state(model: torch.nn.Module, optimizer: PhaseOptimizer,
                       seed: int,
                       shard: Optional[ProcessShard] = None) -> TrainState:
    """A state over ``model`` (on its device): both generators seeded from
    ``seed``. With ``shard`` (this process's rank of the default group) the
    model's BatchNorms normalise over the group's global batch."""
    dev = next(model.parameters()).device
    if shard is not None:
        set_process_group(model, dist.group.WORLD)
    return TrainState(
        model=model, optimizer=optimizer,
        generator=torch.Generator().manual_seed(seed),
        aug_generator=torch.Generator(device=dev).manual_seed(seed),
        shard=shard,
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


def _augment_rows(generator: torch.Generator, visual: torch.Tensor,
                  audio: torch.Tensor, cfg: AugmentConfig,
                  shard: ProcessShard):
    """``ops.augment.augment_batch`` of the global batch, on this rank's
    rows: the draws are made for all ``world`` blocks and sliced."""
    b = visual.shape[0]
    draws = draw_augment(generator, (b * shard.world,) + visual.shape[1:],
                         (b * shard.world,) + audio.shape[1:], cfg)
    rows = slice(shard.rank * b, (shard.rank + 1) * b)
    return apply_augment(visual, audio, {k: v[rows] for k, v in draws.items()},
                         cfg)


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
        with profiling.span("train.step"):
            return _step(state, batch, shift)

    def _step(state, batch, shift):
        model, shard = state.model, state.shard
        dev = batch["visual"].device
        model.train()
        with profiling.span("train.augment", device=dev):
            visual, audio = batch["visual"], batch["audio"]
            if visual.dtype == torch.uint8:
                visual = visual.float() / 255.0
            if augment_cfg is not None and augment_cfg.enabled:
                with torch.no_grad():
                    visual, audio = _augment_rows(
                        state.aug_generator, visual, audio, augment_cfg,
                        shard or ProcessShard(0, 1))
        with profiling.span("train.forward", device=dev):
            if shift is None and use_sync:
                pick = torch.randint(len(shifts), (),
                                     generator=state.generator)
                shift = shifts[int(pick)]
            # Every loss, count and metric below is over the global batch.
            gather = all_gather_rows if shard is not None else (lambda t: t)
            labels = gather(batch["label"].float())
            sample_mask = batch.get("sample_mask")
            if sample_mask is not None:
                sample_mask = gather(sample_mask.float())

            dropout_rng = _rng_state(visual.device)
            with batch_shard(shard):
                logits, aux = model(visual, audio, return_aux=True)
            logits = gather(logits)
            v_tok = gather(aux["visual_tokens"])
            a_tok = gather(aux["audio_tokens"])
            bce = bce_with_logits(logits, labels, sample_mask=sample_mask)
            cm = cross_modal_contrastive_loss(
                v_tok, a_tok, labels,
                temperature=loss_cfg.contrastive_temperature,
                fake_margin=loss_cfg.contrastive_fake_margin,
                sample_mask=sample_mask,
            )
            loss = bce + loss_cfg.contrastive_weight * cm

            sync = torch.zeros((), device=logits.device)
            if use_sync:
                _set_rng_state(visual.device, dropout_rng)
                with frozen_batch_stats(model), batch_shard(shard):
                    _, aux_neg = model(visual,
                                       torch.roll(audio, shift, dims=2),
                                       return_aux=True)
                real_mask = labels >= 0.5
                if sample_mask is not None:
                    real_mask = real_mask & (sample_mask > 0)
                sync = sync_contrastive_loss(
                    v_tok, a_tok, [gather(aux_neg["audio_tokens"])],
                    real_mask=real_mask,
                    temperature=loss_cfg.contrastive_temperature,
                )
                loss = loss + loss_cfg.sync_weight * sync

            with torch.no_grad():
                correct = ((torch.sigmoid(logits) > 0.5).float()
                           == labels).float()
                if sample_mask is None:
                    acc = correct.mean()
                else:
                    m = sample_mask.float()
                    acc = (correct * m).sum() / m.sum().clamp(min=1.0)

        # Zeroing sets every ``.grad`` to None on the host (no device
        # work) and has to precede the backward, so it opens that span.
        with profiling.span("train.backward", device=dev):
            state.optimizer.zero_grad()
            if shard is None:
                loss.backward()
            else:
                (loss / shard.world).backward()
                all_reduce_grads(model.parameters())
        with profiling.span("train.update", device=dev):
            state.optimizer.step()
        state.step += 1
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
