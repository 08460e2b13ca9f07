"""Device selection: CUDA by default, the CPU only when the caller asks.

Counterpart of ``utils/device.py`` in the JAX package. There JAX resolves
the platform itself; here every entry point takes a ``device`` argument and
resolves it through :func:`get_device`, which never falls back to the CPU
silently.
"""

from __future__ import annotations

from typing import Union

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
