"""Phased-freezing optimizers + host-side learning-rate scheduling.

Counterpart of ``training/optimizers.py`` in the JAX package. The
reference trains in freeze phases (phase 1 head only, phase 2 + the audio
encoder, phase 3 the whole model with a lower encoder learning rate). There
each phase is an ``optax.multi_transform`` over parameter labels, with
``set_to_zero`` for the frozen groups and an optional global-norm clip in
front of it. Here a phase is one ``torch.optim.Adam``/``AdamW`` whose
parameter groups are the trainable labels; frozen parameters are in no
group, so they get no update and no optimizer state. The clip stays in
front: its norm counts the gradients of every parameter, frozen ones too,
as the JAX chain's does. ``ReduceLROnPlateau`` scales the groups'
learning rates.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

LABELS = ("head", "audio", "visual")


def label_of(name: str) -> str:
    """``visual_encoder.*`` -> visual, ``audio_encoder.*`` -> audio, the rest
    -> head (by ``state_dict`` / ``named_parameters`` prefix)."""
    if name.startswith("visual_encoder."):
        return "visual"
    if name.startswith("audio_encoder."):
        return "audio"
    return "head"


def label_params(
    named_params: Iterable[Tuple[str, torch.Tensor]]
) -> Dict[str, List[torch.Tensor]]:
    """Parameters by label, in ``named_parameters`` order."""
    out: Dict[str, List[torch.Tensor]] = {k: [] for k in LABELS}
    for name, p in named_params:
        out[label_of(name)].append(p)
    return out


def trainable_labels(phase: int) -> Tuple[str, ...]:
    """Phase 1: head; phase 2: + audio; phase 3: everything."""
    return LABELS[: 1 + (phase >= 2) + (phase >= 3)]


class PhaseOptimizer:
    """One freeze phase (1: head only; 2: + audio; 3: the whole model): an
    optional clip by the global norm of every gradient, then Adam/AdamW on
    the phase's trainable groups, the head at ``lr_head`` and the encoders
    at ``lr_encoder``."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.Tensor]],
        phase: int,
        lr_head: float,
        lr_encoder: float,
        kind: str = "adam",
        weight_decay: float = 0.0,
        grad_clip: Optional[float] = None,
    ):
        if kind not in ("adam", "adamw"):
            raise ValueError(f"kind must be adam or adamw, got {kind!r}")
        by_label = label_params(named_params)
        self.params = [p for label in LABELS for p in by_label[label]]
        self.grad_clip = grad_clip
        groups = [
            {"params": by_label[label], "label": label,
             "lr": lr_head if label == "head" else lr_encoder}
            for label in trainable_labels(phase) if by_label[label]
        ]
        if kind == "adamw":
            self.optimizer = torch.optim.AdamW(groups,
                                               weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.Adam(groups)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm(self.params, self.grad_clip)
        self.optimizer.step()


def clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the norm of all of them reaches ``max_norm``
    (no epsilon, no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def current_learning_rate(optimizer: PhaseOptimizer) -> Optional[float]:
    """The first group's learning rate (the head's), for logging."""
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(mode=min, factor=0.5, patience=5)`` as the
    JAX package runs it: after more than ``patience`` epochs without a new
    best, every group's learning rate is scaled by ``factor`` down to
    ``min_lr``."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-7):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float, optimizer: PhaseOptimizer) -> None:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
            return
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            for g in optimizer.param_groups:
                g["lr"] = max(g["lr"] * self.factor, self.min_lr)
