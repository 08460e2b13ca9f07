"""Dataset hygiene: quarantine videos the training pipeline cannot use.

    python -m lipsync_tpu_torch.tools.filter_corrupt_videos --data-dir data/train

The port's counterpart of the JAX package's
``scripts/filter_corrupt_videos.py``: per video, test decode, audio
extraction and face detection the way the pipeline does them (the mouth
crops of the detected track run on ``--device``); move failures to
``corruptedclips/``, keeping the directory structure. A decode failure is a
reason to quarantine; a failure of the device work ends the run.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.video import detect_and_crop_tracks
from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.device import DeviceLike
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("filter_corrupt_videos")

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mpg", ".mpeg")


def test_video(path: Path, check_faces: bool, min_frames: int = 8,
               backend=None, device: DeviceLike = None) -> str:
    """Return '' if usable, else the failure reason."""
    info = ingest.probe(path)
    if info.nb_frames == 0 and info.duration_sec == 0:
        return "unreadable container"
    try:
        frames = ingest.read_video(path, target_fps=15.0, max_total_frames=64)
    except Exception as e:  # a decode failure: ingest is all that runs
        return f"decode failed: {e}"
    if len(frames) < min_frames:
        return f"too few frames ({len(frames)})"
    try:
        pcm = ingest.read_audio(path, sr=16000)
    except Exception as e:
        return f"audio decode failed: {e}"
    if len(pcm) == 0:
        return "no audio stream"
    if check_faces:
        tracks = detect_and_crop_tracks(frames[:32], backend=backend,
                                        max_tracks=1, device=device)
        if not tracks or tracks[0].hits == 0:
            return "no face detected"
    return ""


def main(argv: Optional[List[str]] = None, backend=None) -> int:
    """Run the tool; returns how many videos it quarantined (or would
    have, with ``--dry-run``). ``backend`` replaces the default face
    detector."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--quarantine-dir", type=Path, default=None)
    p.add_argument("--no-face-check", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    add_device_argument(p)
    args = p.parse_args(argv)

    quarantine = args.quarantine_dir or (args.data_dir.parent / "corruptedclips")
    videos = sorted(
        p for p in args.data_dir.rglob("*")
        if p.suffix.lower() in VIDEO_EXTENSIONS
    )
    logger.info("Checking %d videos", len(videos))
    moved = 0
    for path in videos:
        reason = test_video(path, check_faces=not args.no_face_check,
                            backend=backend, device=args.device)
        if not reason:
            continue
        rel = path.relative_to(args.data_dir)
        dest = quarantine / rel
        logger.info("CORRUPT %s: %s", rel, reason)
        if not args.dry_run:
            dest.parent.mkdir(parents=True, exist_ok=True)
            shutil.move(str(path), str(dest))
        moved += 1
    logger.info("Quarantined %d/%d videos -> %s", moved, len(videos),
                quarantine)
    return moved


if __name__ == "__main__":
    main()
