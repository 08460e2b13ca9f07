"""FLOPs of AV-HuBERT LARGE's work, counted once over its plain reference
(``benchmark/reference/avhubert.py``) on meta tensors, as ``flops.py``
counts the flagship's: the convolutions, matrix products and attention
that the shapes imply, whatever a later change puts in a kernel's place.
"""

from __future__ import annotations

from typing import Mapping

import torch

from benchmark.reference import avhubert as ref
from benchmark.reference.model import Run, fp32_precision


def _meta_params(cfg: Mapping):
    return {k: torch.empty(s, device="meta")
            for k, s in ref.param_shapes(cfg).items()}


def _count(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return float(counter.get_total_flops())


def forward_flops(cfg: Mapping, batch: int = 1) -> float:
    """FLOPs of one eval-mode forward of ``batch`` windows."""
    g = ref.geometry(cfg)
    params = _meta_params(cfg)
    v = torch.empty(batch, g["frames"], g["crop"], g["crop"], device="meta")
    a = torch.empty(batch, g["mels"], g["audio_frames"], device="meta")
    return _count(lambda: ref.forward(params, cfg, v, a,
                                      Run(fp32_precision())))


def encoder_flops_per_token(cfg: Mapping) -> float:
    """FLOPs of the encoder (positional convolution, layers, final
    LayerNorm) on one window's ``video_frames`` tokens, per token."""
    g = ref.geometry(cfg)
    params = _meta_params(cfg)
    x = torch.empty(1, g["frames"], g["D"], device="meta")
    return _count(lambda: ref.encoder(Run(fp32_precision()), params, cfg,
                                      x)) / g["frames"]
