"""Per-stage host-preprocessing profile for one clip.

    python -m lipsync_tpu_torch.tools.profile_host [--seconds 3.0] \
        [--stride 1] [--repeats 3] [--clip FILE] [--device cuda:0]

The port's counterpart of the JAX package's script ``profile_host``, with
its flags, stages and report keys. It attributes the cost of the long-video
path stage by stage — decode, per-frame detection, tracking, device crop,
mel (K1) — so optimization effort lands where the time actually is. A
synthetic clip is written with ``preprocessing/mux.py`` unless ``--clip``
names one.

The ``mel`` and ``crop_device`` stages run on ``--device`` (cuda:0 unless
asked; ``cpu`` runs the kernels' plain twins). Each reads its result back
to the host and the stage then waits for the device, so its time is the
device's work and not the launch alone. Each stage's time is the median
over the repeats after the first (which carries one-off kernel builds and
allocator growth), as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import add_device_argument


def main(argv: Optional[List[str]] = None, backend=None) -> dict:
    """Prints the JAX script's report and returns it. ``backend`` replaces
    the default face detector (``get_default_backend()``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fps", type=float, default=15.0)
    p.add_argument("--stride", type=int, default=1,
                   help="detection stride (frames between detector runs)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--clip", type=Path, default=None,
                   help="profile an existing A/V file instead of a "
                        "synthetic one")
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
    from lipsync_tpu_torch.preprocessing.face_detection import (
        get_default_backend,
    )
    from lipsync_tpu_torch.preprocessing.mux import write_video
    from lipsync_tpu_torch.preprocessing.tracker import StreamingTracker
    from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
    from lipsync_tpu_torch.utils.device import get_device
    from lipsync_tpu_torch.utils.synthetic import (
        speechish_pcm,
        synthetic_frames,
    )

    device = get_device(args.device)

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.clip is not None:
        clip = args.clip
    else:
        tmp = Path(tempfile.mkdtemp())
        n = int(args.seconds * args.fps)
        clip = write_video(
            tmp / "profile.avi", synthetic_frames(n, seed=0), args.fps,
            speechish_pcm(args.seconds, seed=0), 16000,
        )

    backend = backend if backend is not None else get_default_backend()
    stages = {}

    def span(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        wait()
        stages.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    for rep in range(args.repeats):
        frames = span("decode_video", ingest.read_video, clip,
                      target_fps=args.fps)
        pcm = span("decode_audio", ingest.read_audio, clip)
        span("mel", preprocess_audio_pcm, pcm, device=device)

        h, w = frames.shape[1:3]
        tracker = StreamingTracker(h, w, detection_stride=args.stride)
        t_det = t_trk = 0.0
        n_det = 0
        for i, frame in enumerate(frames):
            if i % args.stride == 0:
                t0 = time.perf_counter()
                dets = backend.detect(frame)
                t_det += time.perf_counter() - t0
                n_det += 1
                t0 = time.perf_counter()
                tracker.update(dets)
                t_trk += time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                tracker.coast()
                t_trk += time.perf_counter() - t0
        stages.setdefault("detect", []).append(t_det)
        stages.setdefault("track", []).append(t_trk)
        tracks = tracker.finalize()
        if tracks:
            tr = tracks[0]
            span("crop_device", lambda: crop_track_on_device(
                frames[tr.track_start_frame : tr.track_end_frame + 1],
                tr.boxes, 0, 96, device=device))

    n_frames = len(frames)
    # Drop the first repeat when possible: it carries the one-off kernel
    # builds and allocations that production reuses.
    med = {
        k: float(np.median(v[1:] if len(v) > 1 else v))
        for k, v in stages.items()
    }
    total = sum(med.values())
    report = {
        "clip_seconds": args.seconds if args.clip is None else None,
        "n_frames": int(n_frames),
        "detection_stride": args.stride,
        "frames_detected_per_rep": n_det,
        "stage_ms": {k: round(v * 1e3, 1) for k, v in med.items()},
        "stage_pct": {
            k: round(100 * v / total, 1) for k, v in med.items()
        },
        "detect_ms_per_frame": round(1e3 * med["detect"] / max(n_det, 1), 2),
        "host_total_ms": round(total * 1e3, 1),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
