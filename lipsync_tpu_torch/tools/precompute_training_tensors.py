"""Offline preprocessing of raw videos into training tensors.

    python -m lipsync_tpu_torch.tools.precompute_training_tensors \
        --data-dir data/AVLips --output-dir precomputed --mode full_sequence

The port's counterpart of the JAX package's
``scripts/precompute_training_tensors.py``, with its flags, outputs and log
lines: two modes (``fixed_clip`` = model-ready windows, ``full_sequence`` =
the full uint8 crop sequence + the full mel, for random-window sampling at
train time), three stores (npy files, a zarr group through
``utils/zarrlite.py``, lmdb npz blobs through ``utils/kvlite.py``) +
``manifest.jsonl``, and resume by source path. ``training/data.py`` reads
what it writes.

Decode, detection and tracking run on the host; the mouth crops
(``preprocessing/video.py``) and the log-mel (K1, ``preprocessing/audio.py``)
run on ``--device``, the card by default. This differs on purpose from the
JAX script, which runs its device ops on JAX's CPU by default because each
tiny call pays a remote dispatch round trip on its TPU; here a call to the
card is a local launch. A file that a host stage cannot use (unreadable,
no audio, no face track) is counted as failed and skipped; any other
failure, the card's above all, ends the run (``tools/common.py``).
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
from lipsync_tpu_torch.preprocessing.face_detection import center_crop_box
from lipsync_tpu_torch.preprocessing.video import (
    crop_track_on_device,
    detect_and_crop_tracks,
    preprocess_video,
)
from lipsync_tpu_torch.tools.common import (
    HostStageError,
    add_device_argument,
    host_stage_failed,
)
from lipsync_tpu_torch.training.data import discover_video_samples
from lipsync_tpu_torch.utils import kvlite, zarrlite
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("precompute")


def _open_store(out_dir: Path, storage_format: str):
    """The tensor store for ``zarr`` (``samples.zarr``, one group per key
    holding ``visual`` and ``audio``) and ``lmdb`` (``samples.lmdb``, one
    npz blob per key); None for npy. Both open for appending, so a resumed
    run adds to them."""
    if storage_format == "npy":
        return None
    if storage_format == "zarr":
        return zarrlite.open_group(out_dir / "samples.zarr", mode="a")
    if storage_format == "lmdb":
        return kvlite.open(out_dir / "samples.lmdb")
    raise ValueError(f"Unknown storage format: {storage_format}")


def _store_sample(
    store,
    storage_format: str,
    out_dir: Path,
    key: str,
    visual: np.ndarray,
    audio: np.ndarray,
) -> dict:
    """Persist one sample; returns storage fields for the manifest record."""
    if storage_format == "npy":
        visual_rel = f"{key}_visual.npy"
        audio_rel = f"{key}_audio.npy"
        np.save(out_dir / visual_rel, visual)
        np.save(out_dir / audio_rel, audio)
        return {"visual_relpath": visual_rel, "audio_relpath": audio_rel}
    if storage_format == "zarr":
        grp = store.require_group(key)
        grp.create_array("visual", visual)
        grp.create_array("audio", audio)
        return {}
    buf = io.BytesIO()
    np.savez(buf, visual=visual, audio=audio)
    with store.begin(write=True) as txn:
        txn.put(key.encode("utf-8"), buf.getvalue())
    return {}


def _mel(path: Path, target_frames: Optional[int],
         device: DeviceLike) -> np.ndarray:
    """``preprocessing/audio.py::preprocess_audio``, with a file that holds
    no audio reported as a host-stage failure."""
    pcm = ingest.read_audio(path, sr=16000)
    if pcm.size == 0:
        raise HostStageError(f"Empty audio signal for {path}")
    return preprocess_audio_pcm(pcm, target_frames=target_frames,
                                device=device)


def precompute_one(
    path: Path,
    label: int,
    out_dir: Path,
    index: int,
    mode: str,
    video_frames: int,
    audio_frames: int,
    target_fps: float,
    backend=None,
    use_face_detection: bool = True,
    storage_format: str = "npy",
    store=None,
    device: DeviceLike = None,
) -> dict:
    """One source file -> its stored tensors and manifest record."""
    dev = get_device(device)
    key = f"sample_{index:06d}"
    if mode == "fixed_clip":
        visual = preprocess_video(
            path, max_frames=video_frames, backend=backend,
            use_face_detection=use_face_detection, device=dev,
        )  # (T, 96, 96, 3) float32
        audio = _mel(path, audio_frames, dev)  # (80, T)
    else:  # full_sequence
        frames = ingest.read_video(path, target_fps=target_fps)
        if use_face_detection:
            tracks = detect_and_crop_tracks(
                frames, backend=backend, max_tracks=1, device=dev
            )
            if not tracks:
                raise HostStageError("no face track")
            crops = tracks[0].crops
        else:
            h, w = frames.shape[1:3]
            box = center_crop_box(h, w, 96)
            crops = crop_track_on_device(frames, [box] * len(frames), 0, 96,
                                         device=dev)
        # Truncates, as the JAX script does (not the rounding of
        # utils/synthetic.py::write_corpus).
        visual = (crops * 255.0).astype(np.uint8)
        audio = _mel(path, None, dev)  # full (80, T)

    storage_fields = _store_sample(
        store, storage_format, out_dir, key, visual, audio
    )
    rec = {
        "key": key,
        "source_path": str(path),
        "label": int(label),
        "precompute_mode": mode,
        "storage_format": storage_format,
        "target_fps": target_fps,
        "mel_hz": 100.0,
        "visual_shape": list(visual.shape),
        "audio_shape": list(audio.shape),
    }
    rec.update(storage_fields)
    return rec


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--mode", choices=["fixed_clip", "full_sequence"],
                   default="full_sequence")
    p.add_argument("--video-frames", type=int, default=32)
    p.add_argument("--audio-frames", type=int, default=128)
    p.add_argument("--target-fps", type=float, default=15.0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--no-face-detection", action="store_true")
    p.add_argument("--storage-format", choices=["npy", "zarr", "lmdb"],
                   default="zarr",
                   help="Tensor store (reference default: zarr; written by "
                        "the port's own v2 codec, no wheel needed)")
    p.add_argument("--lmdb-map-size-gb", type=int, default=16,
                   help="accepted for the JAX script's command lines; the "
                        "port's lmdb store (utils/kvlite.py) has no map size")
    add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None, backend=None) -> dict:
    """Run the tool; returns its counts (``new``, ``failed``, ``total``).
    ``backend`` replaces the default face detector."""
    args = build_argparser().parse_args(argv)
    device = get_device(args.device)

    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    manifest_path = out / "manifest.jsonl"
    store = _open_store(out, args.storage_format)

    done_sources = set()
    records = []
    if manifest_path.exists():  # incremental resume by source path
        for line in manifest_path.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                records.append(rec)
                done_sources.add(rec["source_path"])
        logger.info("Resuming: %d samples already precomputed", len(records))

    samples = discover_video_samples(args.data_dir)
    if args.limit:
        samples = samples[: args.limit]
    logger.info("Discovered %d samples", len(samples))

    n_done, n_failed = 0, 0
    try:
        with manifest_path.open("a") as mf:
            for path, label in samples:
                if str(path) in done_sources:
                    continue
                try:
                    rec = precompute_one(
                        path, label, out, len(records), args.mode,
                        args.video_frames, args.audio_frames,
                        args.target_fps, backend=backend,
                        use_face_detection=not args.no_face_detection,
                        storage_format=args.storage_format, store=store,
                        device=device,
                    )
                except Exception as e:
                    if not host_stage_failed(e):
                        raise
                    logger.warning("Failed %s: %s", path, e)
                    n_failed += 1
                    continue
                records.append(rec)
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                n_done += 1
                if n_done % 25 == 0:
                    logger.info("Precomputed %d samples (%d failed)",
                                n_done, n_failed)
    finally:
        if args.storage_format == "lmdb":
            store.sync()
            store.close()
    logger.info("Done: %d new samples, %d failed, %d total",
                n_done, n_failed, len(records))
    return {"new": n_done, "failed": n_failed, "total": len(records)}


if __name__ == "__main__":
    main()
