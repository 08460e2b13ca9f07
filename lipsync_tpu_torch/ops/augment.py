"""Batched training augmentations on the device.

Counterpart of ``ops/augment.py`` in the JAX package: the host
``Augmentations``' shape-preserving transforms (``training/data.py``) as
batched tensor ops on the batch's device: temporal speed warp on both
modalities, horizontal flip, rotation with a reflected border, brightness
and contrast jitter, Gaussian noise. Same op order, gating probabilities
(each jitter with p = 0.5, per sample), truncating nearest-frame index map,
cv2 ``warpAffine(BORDER_REFLECT)`` rotation conventions and value ranges
(visual [0, 1], audio dB [-80, 0]).

Each sample's parameters are *drawn* by :func:`draw_augment` from a
``torch.Generator`` and *applied* by :func:`apply_augment`, so that a test
can feed the JAX package's draws into the port's apply. The port's random
streams are its own: they cannot match ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The host ``Augmentations``' knobs."""

    speed_range: Tuple[float, float] = (0.9, 1.1)
    rotation_deg: float = 15.0
    brightness_range: Tuple[float, float] = (0.8, 1.2)
    contrast_range: Tuple[float, float] = (0.8, 1.2)
    visual_noise_std: float = 0.02
    audio_noise_std: float = 0.01
    enabled: bool = True


def _reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-with-edge-duplication border (cv2 BORDER_REFLECT, scipy
    'reflect'): ...dcba|abcd|dcba..., period 2n."""
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx < n, idx, 2 * n - 1 - idx)


def _speed_indices(t: int, speed: torch.Tensor) -> torch.Tensor:
    """``(B, t)`` truncating nearest-index map of the host speed warp for
    ``(B,)`` speeds."""
    base = torch.linspace(0.0, float(t - 1), t, device=speed.device)
    return (base[None] * speed[:, None]).clamp(0.0, float(t - 1)).long()


def _rotate_frames(frames: torch.Tensor,
                   angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate ``(B, T, H, W, C)`` clips, each by its ``(B,)`` angle, about
    the (w/2, h/2) centre: bilinear sampling through the inverse mapping
    with a reflected border (cv2.warpAffine parity)."""
    b, t, h, w, c = frames.shape
    theta = angle_deg.float() * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=frames.device),
        torch.arange(w, dtype=torch.float32, device=frames.device),
        indexing="ij")
    dx, dy = xx - w / 2.0, yy - h / 2.0
    sx = cos * dx - sin * dy + w / 2.0  # (B, H, W)
    sy = sin * dx + cos * dy + h / 2.0
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[:, None, :, :, None]
    wy = (sy - y0)[:, None, :, :, None]
    flat = frames.reshape(b, t, h * w, c)

    def gather(yi, xi):
        lin = (_reflect_index(yi.long(), h) * w
               + _reflect_index(xi.long(), w)).reshape(b, 1, h * w, 1)
        return torch.gather(flat, 2, lin.expand(b, t, h * w, c)).reshape(
            b, t, h, w, c)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def draw_augment(
    generator: torch.Generator,
    visual_shape: Tuple[int, ...],
    audio_shape: Tuple[int, ...],
    cfg: AugmentConfig = AugmentConfig(),
) -> Dict[str, torch.Tensor]:
    """Per-sample draws for a ``visual_shape`` (B, T, H, W, C) clip batch
    and its ``audio_shape`` (B, F, Ta[, 1]) mel, on the generator's device:
    uniform factors in their ranges, p = 0.5 gates, and unit-normal noise."""
    b = visual_shape[0]
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=dev)

    def gate():
        return torch.rand(b, generator=generator, device=dev) > 0.5

    return {
        "speed": uniform(*cfg.speed_range),
        "flip": gate(),
        "angle": uniform(-cfg.rotation_deg, cfg.rotation_deg),
        "brightness": uniform(*cfg.brightness_range),
        "do_brightness": gate(),
        "contrast": uniform(*cfg.contrast_range),
        "do_contrast": gate(),
        "do_visual_noise": gate(),
        "visual_noise": torch.randn(tuple(visual_shape), generator=generator,
                                    device=dev),
        "do_audio_noise": gate(),
        "audio_noise": torch.randn(tuple(audio_shape[:3]),
                                   generator=generator, device=dev),
    }


def apply_augment(
    visual: torch.Tensor,
    audio: torch.Tensor,
    draws: Dict[str, torch.Tensor],
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply :func:`draw_augment`'s draws: visual ``(B, T, H, W, C)`` in
    [0, 1], audio ``(B, F, Ta[, 1])`` dB."""
    squeeze = audio.dim() == 4
    if squeeze:
        audio = audio[..., 0]
    b, t = visual.shape[:2]
    f, t_a = audio.shape[1:]

    def per_sample(x, ndim):
        return x.reshape((b,) + (1,) * (ndim - 1))

    # 1. temporal speed warp (one factor per sample, both modalities)
    speed = draws["speed"]
    rows = torch.arange(b, device=visual.device)[:, None]
    visual = visual[rows, _speed_indices(t, speed)]
    idx_a = _speed_indices(t_a, speed)[:, None, :].expand(b, f, t_a)
    audio = torch.gather(audio, 2, idx_a)

    # 2. horizontal flip
    visual = torch.where(per_sample(draws["flip"], 5), visual.flip(3), visual)

    # 3. rotation (always; angle ~ U(-deg, +deg))
    visual = _rotate_frames(visual, draws["angle"])

    # 4. brightness
    bright = per_sample(draws["brightness"], 5)
    visual = torch.where(per_sample(draws["do_brightness"], 5),
                         (visual * bright).clamp(0.0, 1.0), visual)

    # 5. contrast about the clip mean
    contrast = per_sample(draws["contrast"], 5)
    mean = visual.mean(dim=(1, 2, 3, 4), keepdim=True)
    visual = torch.where(per_sample(draws["do_contrast"], 5),
                         ((visual - mean) * contrast + mean).clamp(0.0, 1.0),
                         visual)

    # 6. Gaussian noise, visual then audio
    noise_v = draws["visual_noise"] * cfg.visual_noise_std
    visual = torch.where(per_sample(draws["do_visual_noise"], 5),
                         (visual + noise_v).clamp(0.0, 1.0), visual)
    noise_a = draws["audio_noise"] * cfg.audio_noise_std
    audio = torch.where(per_sample(draws["do_audio_noise"], 3),
                        (audio + noise_a).clamp(-80.0, 0.0), audio)
    if squeeze:
        audio = audio[..., None]
    return visual, audio


def augment_batch(
    generator: torch.Generator,
    visual: torch.Tensor,
    audio: torch.Tensor,
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched augmentation with independent per-sample draws. ``visual``
    (B, T, H, W, C) float in [0, 1] (uint8 is normalised first), ``audio``
    (B, F, Ta) or (B, F, Ta, 1) log-mel dB. ``generator`` lives on the
    tensors' device."""
    if visual.dtype == torch.uint8:
        visual = visual.float() / 255.0
    if not cfg.enabled:
        return visual, audio
    draws = draw_augment(generator, tuple(visual.shape), tuple(audio.shape),
                         cfg)
    return apply_augment(visual, audio, draws, cfg)
