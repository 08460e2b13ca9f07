"""Device selection: CUDA by default, the CPU only when the caller asks.

Counterpart of ``utils/device.py`` in the JAX package. There JAX resolves
the platform itself; here every entry point takes a ``device`` argument and
resolves it through :func:`get_device`, which never falls back to the CPU
silently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from lipsync_tpu_torch.utils.logger import get_logger

DeviceLike = Union[str, torch.device, None]
logger = get_logger(__name__)


def get_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises when CUDA is absent); anything else is
    taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available for device {device}")
    return device


def device_summary(device: DeviceLike = None) -> str:
    """``"<count>x <type> (<name>)"`` of the devices of ``device``'s type,
    e.g. ``"1x cuda (NVIDIA H100 80GB HBM3)"`` (``cuda:0`` unless the caller
    asks for another)."""
    dev = get_device(device)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        return (f"{torch.cuda.device_count()}x cuda "
                f"({torch.cuda.get_device_name(index)})")
    return f"1x {dev.type} ({dev.type})"


def disable_tf32() -> None:
    """Run fp32 convolutions and matmuls on CUDA in fp32, not TF32.

    PyTorch lets cuDNN use TF32 by default, which rounds every fp32 input
    of a convolution to 10 mantissa bits. The port's fp32 numerics (its
    bounds against the JAX package and between bf16 and fp32) are those of
    fp32, so the engine and the trainers turn both switches off. They are
    process-wide: set once, at construction or entry, never around one
    forward (another thread's convolution may be running)."""
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        logger.info("TF32 off: cuDNN convolutions and matmuls run in fp32")


class CardPeaks(NamedTuple):
    """A card's published peaks (dense rates, no sparsity, at the card's
    full power limit): memory bytes/s, fp32 SIMT FLOP/s, and TF32, bf16
    and int8 tensor-core FLOP/s (OP/s for int8)."""

    bytes_per_s: float
    fp32: float
    tf32: float
    bf16: float
    int8: float


# NVIDIA's data sheets, by the name ``torch.cuda.get_device_name`` gives;
# the first key that the name contains wins, so "H100" (the SXM part)
# comes after the PCIe and NVL parts.
CARD_PEAKS = {
    "H100 PCIe": CardPeaks(2.0e12, 51e12, 378e12, 756e12, 1513e12),
    "H100 NVL": CardPeaks(3.9e12, 60e12, 417.5e12, 835e12, 1670e12),
    "H200": CardPeaks(4.8e12, 67e12, 494.5e12, 989e12, 1979e12),
    "H100": CardPeaks(3.35e12, 67e12, 495e12, 989e12, 1979e12),
}


def card_peaks(name: str) -> Tuple[str, CardPeaks]:
    """``(key, peaks)`` of the card called ``name``; raises for a card the
    table does not hold (a utilization needs a published peak)."""
    for key, val in CARD_PEAKS.items():
        if key in name:
            return key, val
    raise ValueError(f"no published peaks for {name!r}; add them to "
                     "utils/device.py::CARD_PEAKS")


def device_peaks(device: DeviceLike) -> Optional[CardPeaks]:
    """The peaks of the card behind ``device``; None on the CPU, which has
    no published peak here (its utilizations read null)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return card_peaks(torch.cuda.get_device_name(dev))[1]
