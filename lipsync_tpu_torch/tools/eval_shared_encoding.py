"""Measure the shared-track-encoding deviation and speedup.

    python -m lipsync_tpu_torch.tools.eval_shared_encoding \
        [--n-tracks 8] [--out report.json]

The port's counterpart of the JAX package's
script ``eval_shared_encoding``, with its flags and its report.
``ScoringEngine(shared_visual_encoding=True)`` encodes a track's frames once
and gathers per-window visual features instead of re-encoding every
75%-overlapping window. The only numeric difference from the per-window
path is the temporal convolutions' padding: interior windows see real
neighbouring frames instead of zeros at their window edges. This tool
quantifies that on synthetic talking-face tracks (``utils/synthetic.py``)
through the full-size model and times both paths.

The weights are ``models/bridge.py::seeded_state_dict(--seed)``, served as
the engine serves them: the bf16 placement on a CUDA ``--device``, fp32 on
the CPU. The log-mel runs on ``--device`` (K1), the model too (K2); the
report's ``platform`` names the device type.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.tools.common import add_device_argument


def make_engines(cfg, seed: int, device):
    """(per-window engine, shared-encoding engine) on the same seeded
    weights, in the engine's default placement for ``device``."""
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models import seeded_state_dict

    state = seeded_state_dict(LipSyncModel(cfg), seed)
    return (ScoringEngine(state, cfg, device=device),
            ScoringEngine(state, cfg, shared_visual_encoding=True,
                          device=device))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Measure the shared-track-encoding deviation and "
                    "speedup.")
    p.add_argument("--n-tracks", type=int, default=8)
    p.add_argument("--n-frames", type=int, default=120)
    p.add_argument("--stride", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
    from lipsync_tpu_torch.utils.device import get_device
    from lipsync_tpu_torch.utils.synthetic import (
        speechish_pcm,
        synthetic_frames,
    )

    device = get_device(args.device)
    cfg = ModelConfig()
    windowed, shared = make_engines(cfg, args.seed, device)

    diffs, t_windowed, t_shared = [], [], []
    n_windows_total = 0
    for k in range(args.n_tracks):
        # Face-like moving content (not iid noise): synthetic frames at the
        # crop size + speech-band mel, the predictor tests' inputs.
        frames = synthetic_frames(args.n_frames, seed=args.seed + k,
                                  h=cfg.crop_size, w=cfg.crop_size)
        crops = np.ascontiguousarray(frames)
        pcm = speechish_pcm(args.n_frames / 15.0, seed=args.seed + k)
        mel = preprocess_audio_pcm(pcm, device=device)
        starts = list(range(0, args.n_frames - cfg.video_frames + 1,
                            args.stride))
        mel_hz, fps = 100.0, 15.0
        audio_w = np.stack([
            _mel_window(mel, s, fps, mel_hz, cfg.audio_frames)
            for s in starts
        ])
        n_windows_total += len(starts)

        t0 = time.perf_counter()
        p_w = windowed.score_track_probs(crops, starts, audio_w)
        t_windowed.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        p_s = shared.score_track_probs(crops, starts, audio_w)
        t_shared.append(time.perf_counter() - t0)
        diffs.append(np.abs(p_w - p_s))

    d = np.concatenate(diffs)
    # First-call timings include the first launches; drop them for the
    # speed comparison.
    tw = np.asarray(t_windowed[1:] or t_windowed)
    ts = np.asarray(t_shared[1:] or t_shared)
    report = {
        "platform": device.type,
        "n_tracks": args.n_tracks,
        "n_frames_per_track": args.n_frames,
        "n_windows": int(n_windows_total),
        "prob_abs_diff": {
            "max": round(float(d.max()), 4),
            "mean": round(float(d.mean()), 4),
            "p95": round(float(np.percentile(d, 95)), 4),
        },
        "windowed_s_per_track_p50": round(float(np.median(tw)), 3),
        "shared_s_per_track_p50": round(float(np.median(ts)), 3),
        "speedup": round(float(np.median(tw) / np.median(ts)), 2),
    }
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        args.out.write_text(text)
    return 0


def _mel_window(mel, start_frame, fps, mel_hz, audio_frames):
    """Aligned mel window for a video window start (predictor geometry)."""
    m0 = int(round(start_frame / fps * mel_hz))
    win = mel[:, m0 : m0 + int(32 / fps * mel_hz)]
    # Resample to audio_frames columns (the reference dataset's linear
    # interpolation).
    if win.shape[1] < 2:
        return np.zeros((mel.shape[0], audio_frames), np.float32)
    xs = np.linspace(0, win.shape[1] - 1, audio_frames)
    lo = np.floor(xs).astype(int)
    hi = np.minimum(lo + 1, win.shape[1] - 1)
    frac = xs - lo
    return (win[:, lo] * (1 - frac) + win[:, hi] * frac).astype(np.float32)


if __name__ == "__main__":
    raise SystemExit(main())
