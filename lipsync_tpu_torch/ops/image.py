"""On-device image ops for the mouth-crop path.

Counterpart of ``ops/image.py::crop_resize_normalize`` in the JAX package:
one batched gather-based bilinear resample of per-frame boxes, so frames
stream to the device as raw uint8 and ragged box sizes share one program.
"""

from __future__ import annotations

import torch


def crop_resize_normalize(
    frames: torch.Tensor, boxes: torch.Tensor, out_size: int = 96
) -> torch.Tensor:
    """Crop per-frame boxes from uint8 frames and resize to the model crop.

    Args:
        frames: ``(T, H, W, 3)`` uint8.
        boxes: ``(T, 4)`` integer ``[x1, y1, x2, y2]`` (x2/y2 exclusive).
    Returns:
        ``(T, out_size, out_size, 3)`` float32 in [0, 1] on ``frames.device``.

    Half-pixel sample centres (cv2.INTER_LINEAR); samples are clamped to the
    box first (cv2 resizes the crop, so it edge-replicates at the crop
    boundary) and then to the frame.
    """
    t, h, w, _ = frames.shape
    b = boxes.to(device=frames.device, dtype=torch.float32)
    x1, y1, x2, y2 = b.unbind(1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)

    u = (torch.arange(out_size, dtype=torch.float32, device=frames.device)
         + 0.5) / out_size
    sx = x1[:, None] + u[None, :] * bw[:, None] - 0.5  # (T, S)
    sy = y1[:, None] + u[None, :] * bh[:, None] - 0.5
    sx = torch.clamp(sx, x1[:, None], x2[:, None] - 1.0)
    sy = torch.clamp(sy, y1[:, None], y2[:, None] - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    x1i = torch.clamp(x0 + 1, max=w - 1)
    y1i = torch.clamp(y0 + 1, max=h - 1)
    wx = (sx - x0.float())[:, None, :, None]
    wy = (sy - y0.float())[:, :, None, None]

    ti = torch.arange(t, device=frames.device)[:, None, None]

    def gather(yi, xi):  # (T, S, S, 3), gathered as uint8 then widened
        return frames[ti, yi[:, :, None], xi[:, None, :]].float()

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1i) * wx
    bot = gather(y1i, x0) * (1 - wx) + gather(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    return out / 255.0
