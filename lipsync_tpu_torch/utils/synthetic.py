"""Synthetic requests for measuring the port: 360x640 uint8 frames with a
moving, resizing mouth box over shifted noise, and a 220 Hz tone with a
3 Hz envelope over white noise at 16 kHz, all from a numpy ``Generator``.

:func:`track_windows` runs a request through the device half of the path
(crops, log-mel, alignment) and stacks its sliding windows as the model
takes them, for measurements that feed the model directly.
:func:`write_corpus` writes requests as a preprocessed training corpus.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.inference.policy import align_audio_chunk
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
from lipsync_tpu_torch.utils.device import DeviceLike, get_device

SR = 16000
FPS = 15.0

Request = Tuple[np.ndarray, List[List[int]], np.ndarray]


def pcm(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` samples of a modulated tone over noise, float32."""
    t = np.arange(n) / SR
    voice = 0.2 * np.sin(2 * np.pi * 220 * t) * (
        0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (voice + 0.1 * rng.standard_normal(n)).astype(np.float32)


def request(rng: np.random.Generator, n_frames: int,
            seconds: float) -> Request:
    """``(frames (n, 360, 640, 3) uint8, mouth boxes [x1, y1, x2, y2],
    PCM of ``seconds``)``."""
    base = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    frames = np.empty((n_frames, 360, 640, 3), np.uint8)
    boxes = []
    for i in range(n_frames):
        x1 = int(270 + 40 * np.sin(i / 9.0))
        y1 = int(210 + 20 * np.cos(i / 13.0))
        bw = int(110 + 12 * np.sin(i / 7.0))
        bh = int(70 + 10 * np.cos(i / 5.0))
        frames[i] = np.roll(base, i, axis=1)
        frames[i, y1 : y1 + bh, x1 : x1 + bw] = (
            40 + (i * 7) % 180, 60, 200 - (i * 5) % 150)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
    return frames, boxes, pcm(rng, int(round(seconds * SR)))


def requests(seed: int) -> Dict[str, Request]:
    """The three requests ``chip_smoke.py`` serves, at 15 fps: R1 32 frames
    + 2.2 s, R2 150 frames (10 s), R3 600 frames (40 s)."""
    rng = np.random.default_rng(seed)
    return {"R1": request(rng, 32, 2.2),
            "R2": request(rng, 150, 150 / FPS),
            "R3": request(rng, 600, 600 / FPS)}


def write_corpus(
    out_dir: Path,
    n_clips: int = 32,
    n_frames: int = 48,
    crop_size: int = 96,
    seed: int = 0,
    device: DeviceLike = None,
) -> Path:
    """A preprocessed training corpus of ``n_clips`` requests of
    ``n_frames`` frames, as ``training/data.py`` reads it: per clip the
    mouth crops ``(n_frames, crop, crop, 3)`` uint8 and the log-mel
    ``(80, T_a)`` dB as npy files, and one ``full_sequence`` record per
    clip in ``manifest.jsonl``. Even clips are labelled real (1); odd clips
    are fake (0), their audio rolled by half the clip against the video.
    Crops and the log-mel run on ``device``."""
    dev = get_device(device)
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(n_clips):
        frames, boxes, y = request(rng, n_frames, n_frames / FPS)
        label = int(i % 2 == 0)
        if not label:
            y = np.roll(y, len(y) // 2)
        crops = crop_track_on_device(frames, boxes, 0, crop_size, device=dev)
        visual = np.clip(crops * 255.0 + 0.5, 0, 255).astype(np.uint8)
        key = f"clip_{i:04d}"
        np.save(out_dir / f"{key}_visual.npy", visual)
        np.save(out_dir / f"{key}_audio.npy",
                preprocess_audio_pcm(y, device=dev))
        records.append({
            "key": key, "label": label, "source_path": f"synthetic/{key}",
            "visual_relpath": f"{key}_visual.npy",
            "audio_relpath": f"{key}_audio.npy",
            "precompute_mode": "full_sequence",
            "target_fps": FPS, "mel_hz": 100.0,
        })
    (out_dir / "manifest.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records) + "\n")
    return out_dir


def track_windows(
    req: Request,
    video_frames: int = 32,
    crop_size: int = 96,
    audio_frames: int = 128,
    stride: int = 8,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The request's windows of stride ``stride``: ``(W, T, crop, crop, 3)``
    fp32 pixels in [0, 1] and ``(W, 80, T_a, 1)`` log-mel dB, on the
    device."""
    dev = get_device(device)
    frames, boxes, y = req
    crops = crop_track_on_device(frames, boxes, 0, crop_size, device=dev)
    mel = preprocess_audio_pcm(y, device=dev)
    n = len(crops)
    starts = range(0, n - video_frames + 1, stride)
    visual = np.stack([crops[s : s + video_frames] for s in starts])
    audio = np.stack([align_audio_chunk(mel, s, n, audio_frames,
                                        video_frames) for s in starts])
    return (torch.from_numpy(visual).to(dev),
            torch.from_numpy(audio[..., None]).to(dev))
