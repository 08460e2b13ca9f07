"""Explain why videos fail to load.

    python -m lipsync_tpu_torch.tools.diagnose_videos --data-dir data/bad_clips

The port's counterpart of the JAX package's script ``diagnose_videos``,
with its flags and printed lines: probe each file's container metadata and
attempt a decode of its first frames and of its audio through the port's
ingest (``preprocessing/ingest.py``), reporting a diagnosis per file. It
runs on the host only: reporting why a file cannot be read is its purpose,
so each decode failure is a line of its report.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.preprocessing import ingest

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mpg", ".mpeg", ".mkv", ".webm")


def diagnose(path: Path) -> dict:
    report = {"path": str(path)}
    info = ingest.probe(path)
    report["probe"] = {
        "width": info.width, "height": info.height, "fps": info.fps,
        "duration_sec": info.duration_sec, "nb_frames": info.nb_frames,
        "has_audio": info.has_audio, "sample_rate": info.sample_rate,
    }
    try:
        frames = ingest.read_video(path, 15.0, max_total_frames=16)
        report["decode"] = f"ok ({len(frames)} frames {frames.shape[1:]})"
    except Exception as e:
        report["decode"] = f"FAILED: {e}"
    try:
        pcm = ingest.read_audio(path, 16000)
        report["audio"] = (f"ok ({len(pcm)} samples)" if len(pcm)
                           else "no audio stream")
    except Exception as e:
        report["audio"] = f"FAILED: {e}"
    return report


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Explain why videos fail to load.")
    p.add_argument("--data-dir", type=Path, required=True)
    args = p.parse_args(argv)
    reports = []
    for path in sorted(args.data_dir.rglob("*")):
        if path.suffix.lower() in VIDEO_EXTENSIONS:
            r = diagnose(path)
            reports.append(r)
            print(f"{r['path']}")
            print(f"  probe : {r['probe']}")
            print(f"  decode: {r['decode']}")
            print(f"  audio : {r['audio']}")
    return reports


if __name__ == "__main__":
    main()
