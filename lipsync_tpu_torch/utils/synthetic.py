"""Synthetic requests for measuring the port: 360x640 uint8 frames with a
moving, resizing mouth box over shifted noise, and a 220 Hz tone with a
3 Hz envelope over white noise at 16 kHz, all from a numpy ``Generator``.

:func:`track_windows` runs a request through the device half of the path
(crops, log-mel, alignment) and stacks its sliding windows as the model
takes them, for measurements that feed the model directly.
:func:`write_corpus` writes requests as a preprocessed training corpus, in
any of the three store formats that ``training/data.py`` reads.
:func:`synthetic_frames` (a light face oval with an oscillating mouth) and
:func:`speechish_pcm` (a voiced harmonic stack under a 2.5 Hz envelope)
are the talking-face inputs of the shared-encoding measurement, the same
generators as the JAX package's test fixtures.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.inference.policy import align_audio_chunk
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
from lipsync_tpu_torch.utils import kvlite, zarrlite
from lipsync_tpu_torch.utils.device import DeviceLike, get_device

SR = 16000
FPS = 15.0

Request = Tuple[np.ndarray, List[List[int]], np.ndarray]


def synthetic_frames(
    n: int = 45, h: int = 120, w: int = 160, face: bool = True, seed: int = 0
) -> np.ndarray:
    """(N, H, W, 3) uint8 RGB frames with a light "face" oval + dark
    oscillating "mouth" region so detector heuristics have something real."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 40, size=(n, h, w, 3), dtype=np.uint8)
    if not face:
        return frames
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h // 2, w // 2
    face_mask = (((yy - cy) / (h * 0.3)) ** 2
                 + ((xx - cx) / (w * 0.22)) ** 2) < 1
    for i in range(n):
        frames[i][face_mask] = (205, 170, 150)
        for ex in (cx - w // 10, cx + w // 10):
            eye = (((yy - (cy - h // 8)) ** 2 + (xx - ex) ** 2)
                   < (h * 0.03) ** 2)
            frames[i][eye] = (40, 30, 30)
        # Mouth opens/closes with a 0.4 s period at 15 fps.
        openness = 0.5 + 0.5 * np.sin(2 * np.pi * i / 6.0)
        mh = max(2, int(h * 0.04 * (0.3 + openness)))
        mouth = (
            (np.abs(yy - (cy + h // 6)) < mh)
            & (np.abs(xx - cx) < w * 0.08)
        )
        frames[i][mouth] = (90, 30, 30)
    return frames


def speechish_pcm(seconds: float = 3.0, sr: int = 16000, seed: int = 0):
    """Mono float32 PCM: five harmonics of a 140 Hz +- 30 Hz voice under a
    half-wave 2.5 Hz syllable envelope, over 1e-3 white noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    y = sum(
        (0.5 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
        for k in range(1, 6)
    )
    envelope = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, 1) ** 0.5
    return (y * envelope * 0.3 + rng.randn(n) * 1e-3).astype(np.float32)


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
    """The three requests ``tests/test_torch_engine_card.py`` serves, at 15
    fps: R1 32 frames + 2.2 s, R2 150 frames (10 s), R3 600 frames (40
    s)."""
    rng = np.random.default_rng(seed)
    return {"R1": request(rng, 32, 2.2),
            "R2": request(rng, 150, 150 / FPS),
            "R3": request(rng, 600, 600 / FPS)}


STORAGE_FORMATS = ("npy", "zarr", "lmdb")


def write_corpus(
    out_dir: Path,
    n_clips: int = 32,
    n_frames: int = 48,
    crop_size: int = 96,
    seed: int = 0,
    device: DeviceLike = None,
    storage_format: str = "npy",
) -> Path:
    """A preprocessed training corpus of ``n_clips`` requests of
    ``n_frames`` frames, as ``training/data.py`` reads it: per clip the
    mouth crops ``(n_frames, crop, crop, 3)`` uint8 and the log-mel
    ``(80, T_a)`` dB, and one ``full_sequence`` record per clip in
    ``manifest.jsonl``. Even clips are labelled real (1); odd clips are
    fake (0), their audio rolled by half the clip against the video. Crops
    and the log-mel run on ``device``.

    ``storage_format`` stores each clip as the JAX package's
    ``scripts/precompute_training_tensors.py`` does: ``"npy"``, two files
    named in the record; ``"zarr"``, a group per key holding ``visual`` and
    ``audio`` in ``samples.zarr``; ``"lmdb"``, one ``np.savez`` blob per
    key in the kvlite file ``samples.lmdb``. The zarr and lmdb records name
    their format."""
    if storage_format not in STORAGE_FORMATS:
        raise ValueError(f"Unknown storage format: {storage_format!r}")
    dev = get_device(device)
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if storage_format == "zarr":
        store = zarrlite.open_group(out_dir / "samples.zarr", mode="w")
    elif storage_format == "lmdb":
        (out_dir / "samples.lmdb").unlink(missing_ok=True)
        store = kvlite.open(out_dir / "samples.lmdb")
    records = []
    try:
        for i in range(n_clips):
            frames, boxes, y = request(rng, n_frames, n_frames / FPS)
            label = int(i % 2 == 0)
            if not label:
                y = np.roll(y, len(y) // 2)
            crops = crop_track_on_device(frames, boxes, 0, crop_size,
                                         device=dev)
            visual = np.clip(crops * 255.0 + 0.5, 0, 255).astype(np.uint8)
            audio = preprocess_audio_pcm(y, device=dev)
            key = f"clip_{i:04d}"
            rec = {"key": key, "label": label,
                   "source_path": f"synthetic/{key}"}
            if storage_format == "npy":
                np.save(out_dir / f"{key}_visual.npy", visual)
                np.save(out_dir / f"{key}_audio.npy", audio)
                rec.update(visual_relpath=f"{key}_visual.npy",
                           audio_relpath=f"{key}_audio.npy")
            elif storage_format == "zarr":
                grp = store.require_group(key)
                grp.create_array("visual", visual)
                grp.create_array("audio", audio)
                rec["storage_format"] = storage_format
            else:
                buf = io.BytesIO()
                np.savez(buf, visual=visual, audio=audio)
                with store.begin(write=True) as txn:
                    txn.put(key.encode("utf-8"), buf.getvalue())
                rec["storage_format"] = storage_format
            rec.update(precompute_mode="full_sequence", target_fps=FPS,
                       mel_hz=100.0)
            records.append(rec)
    finally:
        if storage_format == "lmdb":
            store.close()
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
