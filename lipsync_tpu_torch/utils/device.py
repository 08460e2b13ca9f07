"""Device selection: CUDA by default, the CPU only when the caller asks.

Counterpart of ``utils/device.py`` in the JAX package. There JAX resolves
the platform itself; here every entry point takes a ``device`` argument and
resolves it through :func:`get_device`, which never falls back to the CPU
silently.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


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

