"""Audio-energy vs mouth-motion diagnostic plots.

    python -m lipsync_tpu_torch.tools.debug_clips --video clip.mp4 \
        --out debug.png

The port's counterpart of the JAX package's script ``debug_clips``,
with its flags and printed lines: for one clip, the per-frame mouth-motion
energy against the audio energy envelope, plus the speaking-alignment
correlation and the mouth-motion check, the signals behind the predictor's
mouth-motion guard (``inference/policy.py``). The crops and the log-mel
(K1) run on ``--device``; a failure there ends the run. Only the plotting
is optional: where matplotlib does not import, the tool says "(plotting
skipped: ...)" after the numbers are printed.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.inference import policy
from lipsync_tpu_torch.preprocessing.audio import preprocess_audio
from lipsync_tpu_torch.preprocessing.video import preprocess_video
from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.device import get_device


def analyze(video: Path, backend=None, device="cuda:0") -> dict:
    visual = preprocess_video(video, backend=backend,
                              device=device)  # (32, 96, 96, 3)
    audio = preprocess_audio(video, target_frames=128,
                             device=device)  # (80, 128)
    frames = visual.mean(axis=-1)
    motion = np.abs(np.diff(frames, axis=0)).mean(axis=(1, 2))
    audio_energy = audio.mean(axis=0)
    return {
        "motion": motion,
        "audio_energy": audio_energy,
        "alignment_score": policy.speaking_alignment_score(visual, audio),
        "mouth_check": policy.mouth_motion_energy_check(visual, audio),
    }


def main(argv: Optional[List[str]] = None, backend=None):
    p = argparse.ArgumentParser(
        description="Audio-energy vs mouth-motion diagnostic plots.")
    p.add_argument("--video", type=Path, required=True)
    p.add_argument("--out", type=Path, default=Path("debug_clip.png"))
    add_device_argument(p)
    args = p.parse_args(argv)
    get_device(args.device)  # raises here where CUDA is absent

    r = analyze(args.video, backend=backend, device=args.device)
    print(f"alignment_score: {r['alignment_score']:.3f}")
    print(f"mouth_check:     {r['mouth_check']}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 5), sharex=False)
        ax1.plot(r["motion"])
        ax1.set_title("Mouth motion energy (per frame)")
        ax2.plot(r["audio_energy"])
        ax2.set_title("Audio energy (mel dB, per frame)")
        fig.suptitle(
            f"{args.video.name}: alignment={r['alignment_score']:.3f}, "
            f"check={r['mouth_check']['check_result']}"
        )
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        print(f"Plot saved to {args.out}")
    except Exception as e:
        print(f"(plotting skipped: {e})")
    return r


if __name__ == "__main__":
    main()
