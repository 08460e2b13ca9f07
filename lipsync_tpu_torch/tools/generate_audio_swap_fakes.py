"""Synthesize FAKE training clips by swapping audio between real videos.

    python -m lipsync_tpu_torch.tools.generate_audio_swap_fakes \
        --real-dir data/real --output-dir data/1_fake --limit 100

The port's counterpart of the JAX package's
``scripts/generate_audio_swap_fakes.py``: decode A's frames and B's PCM with
the port's native ingest and write an ``.avi`` (mpeg4 + pcm_s16le) with its
native muxer. The output is labelled FAKE by its directory. Host work only:
it takes no ``--device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.mux import write_video
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("generate_audio_swap_fakes")

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mpg", ".mpeg")


def audio_swap(video_a: Path, video_b: Path, out_path: Path,
               target_fps: float = 15.0, sr: int = 16000) -> None:
    """video from A + audio from B -> out (a lip-sync mismatch fake)."""
    frames = ingest.read_video(video_a, target_fps=target_fps)
    pcm = ingest.read_audio(video_b, sr=sr)
    if len(pcm) == 0:
        raise ValueError(f"No audio stream in {video_b}")
    # Trim/pad audio to the video duration.
    want = int(len(frames) / target_fps * sr)
    if len(pcm) >= want:
        pcm = pcm[:want]
    else:
        pcm = np.pad(pcm, (0, want - len(pcm)))
    write_video(out_path, frames, fps=target_fps, pcm=pcm, sample_rate=sr)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-fps", type=float, default=15.0)
    args = p.parse_args(argv)

    videos = sorted(
        p for p in args.real_dir.rglob("*")
        if p.suffix.lower() in VIDEO_EXTENSIONS
    )
    if len(videos) < 2:
        raise SystemExit("Need at least 2 source videos for audio swapping")
    args.output_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.RandomState(args.seed)
    n = args.limit or len(videos)
    made = 0
    for i in range(n):
        a = videos[i % len(videos)]
        # Pick a different clip's audio.
        while True:
            b = videos[rng.randint(len(videos))]
            if b != a:
                break
        out = args.output_dir / f"{a.stem}__audio_{b.stem}.avi"
        try:
            audio_swap(a, b, out, target_fps=args.target_fps)
            made += 1
        except Exception as e:
            logger.warning("Swap failed (%s + %s): %s", a.name, b.name, e)
    logger.info("Generated %d audio-swap fakes in %s", made, args.output_dir)
    return made


if __name__ == "__main__":
    main()
