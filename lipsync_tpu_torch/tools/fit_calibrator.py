"""Fit output calibrators on a labelled validation set.

    python -m lipsync_tpu_torch.tools.fit_calibrator --preprocessed-dir val \
        --model-path weights/best_model_accuracy --method all

The port's counterpart of the JAX package's ``scripts/fit_calibrator.py``,
with its flags and printed lines: collects raw logits over a precomputed
tensor directory in batches through ``ScoringEngine.score_logits`` (the
model's forward, K2 inside, on ``--device``), fits temperature scaling,
Platt scaling and isotonic regression (``inference/calibration.py``; the
isotonic map is the port's own and pickles without sklearn), and prints the
values to paste into ``Settings``.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.inference.calibration import (
    fit_isotonic,
    fit_platt,
    fit_temperature,
)
from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("fit_calibrator")


def collect_logits_preprocessed(args, engine=None):
    """(logits, labels) of every loadable sample of
    ``args.preprocessed_dir``, scored in batches of ``args.batch_size``."""
    from lipsync_tpu_torch.inference.engine import load_engine
    from lipsync_tpu_torch.training.data import LipSyncDataset

    if engine is None:
        engine = load_engine(args.model_path, device=args.device)
    ds = LipSyncDataset(
        preprocessed_dir=args.preprocessed_dir,
        video_frames=engine.config.video_frames,
        audio_frames=engine.config.audio_frames,
    )
    logits, labels = [], []
    batch_v, batch_a, batch_l = [], [], []

    def flush():
        nonlocal batch_v, batch_a, batch_l
        if batch_v:
            logits.extend(
                engine.score_logits(np.stack(batch_v), np.stack(batch_a))
            )
            labels.extend(batch_l)
            batch_v, batch_a, batch_l = [], [], []

    n = len(ds) if not args.limit else min(args.limit, len(ds))
    for i in range(n):
        s = ds.get_item(i, train_mode_override=False)
        if s is None:
            continue
        batch_v.append(s[0])
        batch_a.append(s[1])
        batch_l.append(float(s[2]))
        if len(batch_v) >= args.batch_size:
            flush()
    flush()
    return np.asarray(logits), np.asarray(labels)


def main(argv: Optional[List[str]] = None, engine=None) -> dict:
    """Run the tool; returns the fitted values by their ``Settings`` name.
    ``engine`` replaces the one ``--model-path`` would load."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preprocessed-dir", type=Path, default=None)
    p.add_argument("--model-path", type=Path, default=None)
    p.add_argument("--method", choices=["temperature", "platt", "isotonic",
                                        "all"], default="all")
    p.add_argument("--isotonic-out", type=Path,
                   default=Path("isotonic_calibrator.pkl"))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--save-logits", type=Path, default=None,
                   help="write collected (logits, labels) to this .npz")
    p.add_argument("--logits-in", type=Path, default=None,
                   help="fit from a saved .npz instead of scoring the "
                        "split (no model, no device work)")
    add_device_argument(p)
    args = p.parse_args(argv)

    if args.logits_in is not None:
        saved = np.load(args.logits_in)
        logits, labels = saved["logits"], saved["labels"]
    else:
        if args.preprocessed_dir is None:
            p.error("--preprocessed-dir required unless --logits-in given")
        logits, labels = collect_logits_preprocessed(args, engine=engine)
    if args.save_logits is not None:
        np.savez(args.save_logits, logits=logits, labels=labels)
    logger.info("Collected %d logits (%.1f%% real)",
                len(logits), labels.mean() * 100 if len(labels) else 0)

    out = {}
    if args.method in ("temperature", "all"):
        t = fit_temperature(logits, labels)
        out["calibration_temperature"] = t
        print("calibration_method: temperature")
        print(f"calibration_temperature: {t:.4f}")
    if args.method in ("platt", "all"):
        a, b = fit_platt(logits, labels)
        out["calibration_platt_a"] = a
        out["calibration_platt_b"] = b
        print(f"calibration_platt_a: {a:.4f}")
        print(f"calibration_platt_b: {b:.4f}")
    if args.method in ("isotonic", "all"):
        probs = 1 / (1 + np.exp(-logits))
        iso = fit_isotonic(probs, labels)
        with open(args.isotonic_out, "wb") as f:
            pickle.dump(iso, f)
        out["calibration_isotonic_path"] = str(args.isotonic_out)
        print(f"calibration_isotonic_path: {args.isotonic_out}")
    return out


if __name__ == "__main__":
    main()
