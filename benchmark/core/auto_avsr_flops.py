"""FLOPs of Auto-AVSR's work, counted once over its plain reference
(``benchmark/reference/auto_avsr.py``) on meta tensors, as ``flops.py``
counts the flagship's: the convolutions, matrix products and attention
that the shapes imply, whatever a later change puts in a kernel's place.
And K5's least time a conv output position in its Swish instantiation
(the operations and bytes of ``k5_swish_stem_roofline``).
"""

from __future__ import annotations

from typing import Mapping

import torch

from benchmark.core import peaks
from benchmark.reference import auto_avsr as ref
from benchmark.reference.model import Run, fp32_precision

STEM_TAPS = 5 * 7 * 7
STEM_CHANNELS = 64


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
    a = torch.empty(batch, 1, g["samples"], device="meta")
    return _count(lambda: ref.forward(params, cfg, v, a,
                                      Run(fp32_precision())))


def encoder_flops_per_token(cfg: Mapping) -> float:
    """FLOPs of one conformer encoder (the positional projection, the
    blocks, ``after_norm``) on one window's ``video_frames`` tokens, per
    token. Both encoders have the same widths."""
    g = ref.geometry(cfg)
    params = _meta_params(cfg)
    x = torch.empty(1, g["frames"], g["D"], device="meta")
    return _count(lambda: ref.encoder(Run(fp32_precision()), params, cfg,
                                      x, "encoder")) / g["frames"]


def stem_position_ops() -> float:
    """Operations of one conv output position of the 3D stem: 245 taps x
    64 channels, two a multiply-add (BatchNorm, Swish and the pool are
    left out)."""
    return 2.0 * STEM_TAPS * STEM_CHANNELS


def stem_position_bytes() -> float:
    """Bytes of one conv output position, each read or written once: its
    four bf16 pixels (stride 2 in both axes) and a quarter of the 64 pooled
    bf16 channels."""
    return 2.0 * 4 + 2.0 * STEM_CHANNELS / 4


def stem_least_seconds(positions: float) -> float:
    """K5's least time for ``positions`` conv output positions: the larger
    of their operations at the bf16 tensor-core peak and their bytes at the
    memory bandwidth (``core/peaks.py``)."""
    return positions * peaks.least_seconds(stem_position_bytes(),
                                           stem_position_ops(), "bf16")
