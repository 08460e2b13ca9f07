"""Re-encode videos into a pipeline-friendly format.

    python -m lipsync_tpu_torch.tools.convert_videos --input-dir raw/ --output-dir cfr/

The port's counterpart of the JAX package's ``scripts/convert_videos.py``:
decode through the port's native ingest (any codec FFmpeg reads) and
re-encode with its native muxer (mpeg4 + pcm ``.avi``) at a constant frame
rate, keeping the audio. Host work only: it takes no ``--device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.mux import write_video
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("convert_videos")

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mpg", ".mpeg", ".mkv", ".webm")


def convert(path: Path, out_path: Path, fps: float, sr: int) -> None:
    frames = ingest.read_video(path, target_fps=fps)
    pcm = ingest.read_audio(path, sr=sr)
    write_video(
        out_path, frames, fps=fps,
        pcm=pcm if len(pcm) else None, sample_rate=sr,
    )


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--sample-rate", type=int, default=16000)
    args = p.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for path in sorted(args.input_dir.rglob("*")):
        if path.suffix.lower() not in VIDEO_EXTENSIONS:
            continue
        rel = path.relative_to(args.input_dir).with_suffix(".avi")
        out = args.output_dir / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        try:
            convert(path, out, args.fps, args.sample_rate)
            n += 1
        except Exception as e:
            logger.warning("Convert failed %s: %s", path, e)
    logger.info("Converted %d videos", n)
    return n


if __name__ == "__main__":
    main()
