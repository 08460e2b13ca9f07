"""Layout conversion between the reference's torch NCDHW conventions and
the channels-last conventions of the JAX package and the port.

The port's own copy of ``utils/layout.py`` in the JAX package, with numpy
semantics (``np.transpose``: numpy arrays in, views out).

Reference layouts: visual ``(B, 3, T, H, W)``; audio ``(B, 1, F, T)``.
Channels-last layouts: visual ``(B, T, H, W, 3)``; audio ``(B, F, T, 1)``.
"""

from __future__ import annotations

import numpy as np


def visual_from_torch(x):
    """(B, 3, T, H, W) -> (B, T, H, W, 3); also accepts unbatched (3, T, H, W)."""
    if x.ndim == 4:
        return np.transpose(x, (1, 2, 3, 0))
    return np.transpose(x, (0, 2, 3, 4, 1))


def visual_to_torch(x):
    """(B, T, H, W, 3) -> (B, 3, T, H, W); also accepts unbatched (T, H, W, 3)."""
    if x.ndim == 4:
        return np.transpose(x, (3, 0, 1, 2))
    return np.transpose(x, (0, 4, 1, 2, 3))


def audio_from_torch(x):
    """(B, 1, F, T) -> (B, F, T, 1); also accepts unbatched (1, F, T)."""
    if x.ndim == 3:
        return np.transpose(x, (1, 2, 0))
    return np.transpose(x, (0, 2, 3, 1))


def audio_to_torch(x):
    """(B, F, T, 1) -> (B, 1, F, T); also accepts unbatched (F, T, 1)."""
    if x.ndim == 3:
        return np.transpose(x, (2, 0, 1))
    return np.transpose(x, (0, 3, 1, 2))
