"""FLOPs of the work, counted once over the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions,
matrix products and attention of the reference's forward (or whole train
step) on meta tensors: the count follows from the shapes alone, so it is
the same work whatever a later change puts in a kernel's place, and no
memory or time is spent on it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from benchmark.reference import model as ref
from benchmark.reference import train as ref_train


def _meta_params(cfg: Mapping, grad: bool = False):
    return {k: torch.empty(s, device="meta", requires_grad=grad
                           and len(s) > 0 and not k.endswith(
                               ("running_mean", "running_var")))
            for k, s in ref.param_shapes(cfg).items()}


def _inputs(cfg: Mapping, batch: int):
    g = ref.geometry(cfg)
    v = torch.empty(batch, g["frames"], g["crop"], g["crop"], 3,
                    device="meta")
    a = torch.empty(batch, g["mels"], g["audio_frames"], 1, device="meta")
    return v, a


def forward_flops(cfg: Mapping, batch: int = 1) -> float:
    """FLOPs of one eval-mode forward of ``batch`` windows."""
    from torch.utils.flop_counter import FlopCounterMode

    params = _meta_params(cfg)
    v, a = _inputs(cfg, batch)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(params, cfg, v, a, ref.Run(ref.fp32_precision()))
    return float(counter.get_total_flops())


def train_step_flops(cfg: Mapping, batch: int) -> float:
    """FLOPs of one train step on ``batch`` clips: both forwards (the
    second on rolled audio), the losses and the backward of every
    parameter. Augmentation and the optimizer hold no product."""
    from torch.utils.flop_counter import FlopCounterMode

    params = _meta_params(cfg, grad=True)
    v, a = _inputs(cfg, batch)
    labels = torch.empty(batch, device="meta")
    mask = torch.empty(batch, device="meta")
    run = ref.Run(ref.fp32_precision(), training=True)
    counter = FlopCounterMode(display=False)
    with counter:
        logits, aux = ref.forward(params, cfg, v, a, run, return_aux=True)
        _, neg = ref.forward(params, cfg, v, torch.roll(a, 5, 2), run,
                             return_aux=True)
        v_tok, a_tok = aux["visual_tokens"], aux["audio_tokens"]
        loss = ref_train.bce(logits, labels, mask) \
            + 0.1 * ref_train.cross_modal_loss(v_tok, a_tok, labels, mask) \
            + 0.2 * ref_train.sync_loss(v_tok, a_tok, neg["audio_tokens"],
                                        mask)
        leaves = [p for p in params.values() if p.requires_grad]
        torch.autograd.grad(loss, leaves)
    return float(counter.get_total_flops())
