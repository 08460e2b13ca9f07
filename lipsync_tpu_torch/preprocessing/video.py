"""Video preprocessing: batched device crops of a tracked face.

Counterpart of ``preprocessing/video.py::{_bucket, crop_track_on_device}``
in the JAX package. The host keeps the boxes; the pixel work (crop,
bilinear resize, /255) runs as one batched call on the device
(``ops/image.py``). Crop counts are bucketed to powers of two, with the
padding slots repeating the last frame, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lipsync_tpu_torch.ops.image import crop_resize_normalize
from lipsync_tpu_torch.utils.device import DeviceLike, get_device


def _bucket(n: int, base: int = 32) -> int:
    """Round up to a power-of-two multiple of ``base``."""
    size = base
    while size < n:
        size *= 2
    return size


def crop_track_on_device(
    frames: np.ndarray,
    boxes: Sequence[Sequence[int]],
    start_frame: int,
    crop_size: int = 96,
    device: DeviceLike = None,
) -> np.ndarray:
    """Crop ``boxes[i]`` from ``frames[start_frame + i]`` in one device call.

    Returns ``(len(boxes), crop, crop, 3)`` float32 in [0, 1].
    """
    n = len(boxes)
    if n == 0:
        return np.zeros((0, crop_size, crop_size, 3), np.float32)
    dev = get_device(device)
    padded_n = _bucket(n)
    idx = np.minimum(start_frame + np.arange(padded_n), len(frames) - 1)
    idx = np.minimum(idx, start_frame + n - 1)
    sel = frames[idx]  # (padded_n, H, W, 3) uint8
    box_arr = np.zeros((padded_n, 4), np.int32)
    box_arr[:n] = np.asarray(boxes, np.int32)
    box_arr[n:] = box_arr[n - 1]
    crops = crop_resize_normalize(
        torch.from_numpy(sel).to(dev), torch.from_numpy(box_arr).to(dev),
        crop_size,
    )
    return crops[:n].cpu().numpy()
