"""Robustness grid: held-out metrics under input perturbations.

    python -m lipsync_tpu_torch.tools.eval_robustness_grid \
        --preprocessed-dir pre_test --model-path weights/best_model_accuracy \
        --output docs/eval/robustness_grid.json

The port's counterpart of the JAX package's
script ``eval_robustness_grid``, with its flags, its 17 cells and its
JSON. It sweeps perturbation severity over a preprocessed test split and
records ROC-AUC, accuracy and per-class verdict rates per grid cell:

* H.264 round trips of the uint8 crop window at CRF 18-38
  (``preprocessing/mux.py::h264_roundtrip``: libx264 through the native
  muxer, decoded by cv2). A codec cell on a machine without FFmpeg raises;
  it is never dropped;
* visual Gaussian noise (post-normalization sigma) and brightness scaling;
* log-mel additive noise (dB);
* audio-visual misalignment: the mel window's content shifts by N
  visual-frame equivalents with edge padding. A sync detector should flip
  REAL clips toward FAKE as the shift grows, so ``real_flagged_fake``
  doubles as a sensitivity curve.

Windows are sampled deterministically (eval mode) and every cell draws its
noise from its own ``RandomState(--seed)``, so every cell scores the SAME
windows and differences are attributable to the perturbation alone. The
model runs on ``--device`` (K2; with ``--quantized-int8`` K4 then K3).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.tools.validate_pipeline import roc_auc
from lipsync_tpu_torch.utils.device import get_device

Perturb = Callable[[np.ndarray, np.ndarray, np.random.RandomState],
                   Tuple[np.ndarray, np.ndarray]]


def _as_float_visual(v: np.ndarray) -> np.ndarray:
    if v.dtype == np.uint8:
        return v.astype(np.float32) / 255.0
    return v.astype(np.float32)


def identity(v, a, rng):
    return v, a


def visual_noise(sigma: float) -> Perturb:
    def fn(v, a, rng):
        v = np.clip(v + rng.randn(*v.shape).astype(np.float32) * sigma,
                    0.0, 1.0)
        return v, a
    return fn


def brightness(factor: float) -> Perturb:
    def fn(v, a, rng):
        return np.clip(v * factor, 0.0, 1.0), a
    return fn


def audio_noise(sigma_db: float) -> Perturb:
    def fn(v, a, rng):
        a = np.clip(a + rng.randn(*a.shape).astype(np.float32) * sigma_db,
                    -80.0, 0.0)
        return v, a
    return fn


def av_shift(n_frames: int, video_frames: int, audio_frames: int) -> Perturb:
    """Shift the mel window's content by ``n_frames`` visual-frame
    equivalents (edge-padded), breaking audio-visual alignment the same
    way a misaligned deepfake does."""
    cols = max(1, int(round(n_frames * audio_frames / video_frames)))

    def fn(v, a, rng):
        out = np.empty_like(a)
        out[:, :-cols] = a[:, cols:]
        out[:, -cols:] = a[:, -1:]
        return v, out
    return fn


def codec_crf(crf: int) -> Perturb:
    """H.264 round trip at constant rate factor ``crf``: real uploads are
    codec-compressed, so blocking and ringing on the mouth crops are part
    of the production input distribution."""
    from lipsync_tpu_torch.preprocessing.mux import h264_roundtrip

    def fn(v, a, rng):
        u8 = np.clip(v * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return h264_roundtrip(u8, crf).astype(np.float32) / 255.0, a
    return fn


def build_grid(video_frames: int, audio_frames: int
               ) -> List[Tuple[str, Perturb]]:
    return [
        ("clean", identity),
        ("codec_crf18", codec_crf(18)),
        ("codec_crf23", codec_crf(23)),
        ("codec_crf28", codec_crf(28)),
        ("codec_crf33", codec_crf(33)),
        ("codec_crf38", codec_crf(38)),
        ("vis_noise_0.02", visual_noise(0.02)),
        ("vis_noise_0.05", visual_noise(0.05)),
        ("vis_noise_0.10", visual_noise(0.10)),
        ("brightness_0.7", brightness(0.7)),
        ("brightness_1.3", brightness(1.3)),
        ("mel_noise_2db", audio_noise(2.0)),
        ("mel_noise_5db", audio_noise(5.0)),
        ("av_shift_1f", av_shift(1, video_frames, audio_frames)),
        ("av_shift_2f", av_shift(2, video_frames, audio_frames)),
        ("av_shift_4f", av_shift(4, video_frames, audio_frames)),
        ("av_shift_8f", av_shift(8, video_frames, audio_frames)),
    ]


def run_grid(args, engine=None) -> Dict:
    from lipsync_tpu_torch.inference.engine import load_engine
    from lipsync_tpu_torch.training.data import LipSyncDataset

    if engine is None:
        engine = load_engine(
            args.model_path, quantized_int8=args.quantized_int8,
            device=args.device,
        )
        if args.calibration_method != "none":
            from lipsync_tpu_torch.inference.calibration import Calibrator

            engine.calibrator = Calibrator.from_config(
                method=args.calibration_method,
                temperature=args.calibration_temperature,
                platt_a=args.calibration_platt_a,
                platt_b=args.calibration_platt_b,
            )
    ds = LipSyncDataset(
        preprocessed_dir=args.preprocessed_dir,
        video_frames=engine.config.video_frames,
        audio_frames=engine.config.audio_frames,
    )
    if args.limit and args.limit < len(ds):
        # Evenly-spaced subsample: preprocessed manifests are often blocked
        # by class, so a head-slice would be single-class.
        indices = np.unique(
            np.linspace(0, len(ds) - 1, args.limit).round().astype(int)
        )
    else:
        indices = np.arange(len(ds))

    # Load each window once; perturbations reuse the same host arrays.
    visuals, audios, labels = [], [], []
    for i in indices:
        sample = ds.get_item(i, train_mode_override=False)
        if sample is None:
            continue
        v, a, label = sample
        visuals.append(_as_float_visual(np.asarray(v)))
        audios.append(np.asarray(a, np.float32))
        labels.append(int(label))
    true_fake = 1 - np.asarray(labels)  # positive class = FAKE

    grid = build_grid(engine.config.video_frames, engine.config.audio_frames)
    if getattr(args, "cells", None):
        wanted = [c.strip() for c in args.cells.split(",")]
        grid = [
            (n, f) for n, f in grid
            if any(w in n for w in wanted)
        ]
    cells = {}
    for name, perturb in grid:
        rng = np.random.RandomState(args.seed)
        probs_fake: List[float] = []
        for lo in range(0, len(visuals), args.batch_size):
            vb, ab = [], []
            for v, a in zip(visuals[lo: lo + args.batch_size],
                            audios[lo: lo + args.batch_size]):
                pv, pa = perturb(v, a, rng)
                vb.append(pv)
                ab.append(pa)
            p_real = engine.score_probs(np.stack(vb), np.stack(ab))
            probs_fake.extend((1.0 - np.asarray(p_real)).tolist())
        probs_fake = np.asarray(probs_fake)
        pred_fake = probs_fake > (1.0 - args.threshold)
        real_mask = true_fake == 0
        fake_mask = ~real_mask
        cells[name] = {
            "roc_auc": round(roc_auc(probs_fake, true_fake), 4),
            "accuracy": round(
                float((pred_fake == true_fake.astype(bool)).mean()), 4
            ),
            "real_flagged_fake": round(
                float(pred_fake[real_mask].mean()) if real_mask.any() else 0.0,
                4,
            ),
            "fake_flagged_fake": round(
                float(pred_fake[fake_mask].mean()) if fake_mask.any() else 0.0,
                4,
            ),
            "mean_p_fake_real_clips": round(
                float(probs_fake[real_mask].mean()) if real_mask.any()
                else 0.0, 4,
            ),
        }
        print(f"{name:>16}: AUC {cells[name]['roc_auc']:.4f}  "
              f"acc {cells[name]['accuracy']:.4f}  "
              f"real->fake {cells[name]['real_flagged_fake']:.3f}",
              file=sys.stderr, flush=True)

    result = {
        "preprocessed_dir": str(args.preprocessed_dir),
        "clips_scored": int(len(visuals)),
        "threshold": args.threshold,
        "seed": args.seed,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "cells": cells,
    }
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(result, indent=2))
    return result


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Perturbation robustness grid")
    p.add_argument("--preprocessed-dir", type=Path, required=True)
    p.add_argument("--model-path", type=Path, default=None)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="P(FAKE) decision threshold")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--cells", default=None,
                   help="comma list of cell-name substrings to run "
                        "(e.g. 'clean,codec'); default all")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantized-int8", action="store_true",
                   help="Serve through the int8 convolution lowering "
                        "(models/layers.py::int8_conv, K4 then K3)")
    p.add_argument("--calibration-method", default="none",
                   choices=["none", "temperature", "platt"])
    p.add_argument("--calibration-temperature", type=float, default=1.0)
    p.add_argument("--calibration-platt-a", type=float, default=1.0)
    p.add_argument("--calibration-platt-b", type=float, default=0.0)
    add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None, engine=None) -> Dict:
    args = build_argparser().parse_args(argv)
    get_device(args.device)  # raises here where CUDA is absent
    return run_grid(args, engine=engine)


if __name__ == "__main__":
    main()
