"""Shared-track-encoding verdict-flip measurement on a production replay.

    python -m lipsync_tpu_torch.tools.eval_shared_encoding_flips \
        --data-dir /tmp/synth_r3_1500/raw_test \
        --model-path /tmp/synth_r3_1500/weights/best_model_accuracy \
        [--limit 200] [--out docs/eval/shared_encoding_flips_torch.json]

The port's counterpart of the JAX package's
script ``eval_shared_encoding_flips``, with its flags and its report.
``shared_visual_encoding`` cuts long-video model work ~2.8x with a small
per-window probability deviation (``tools/eval_shared_encoding.py``), but
the default stays off unless turning it on provably never changes a
VERDICT. This tool replays the production ``Predictor.predict`` path over
a labelled clip tree (``0_real/`` / ``1_fake/``) twice, shared encoding off
then on, and reports the verdict flips and the distribution of the final
confidence's change. Crops, the log-mel (K1) and the model (K2) run on
``--device``.

The default ``--out`` is the port's own file beside the JAX package's
``docs/eval/shared_encoding_flips.json``, so that the two can be compared
and neither overwrites the other.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.logger import get_logger

REPO = Path(__file__).resolve().parents[2]
logger = get_logger("eval_shared_encoding_flips")

VIDEO_EXTS = {".avi", ".mp4", ".mov", ".mkv", ".mpg", ".webm"}


def discover(data_dir: Path, limit: Optional[int]):
    """Labelled clips from the 0_real/ / 1_fake/ convention (1=REAL)."""
    files = []
    for sub, label in (("0_real", 1), ("1_fake", 0)):
        d = data_dir / sub
        if d.is_dir():
            files += [(p, label) for p in sorted(d.iterdir())
                      if p.suffix.lower() in VIDEO_EXTS]
    if limit:
        # Keep classes balanced under --limit: interleave.
        real = [f for f in files if f[1] == 1]
        fake = [f for f in files if f[1] == 0]
        files = real[: limit // 2] + fake[: limit - limit // 2]
    return files


def run_pass(files, model_path: Path, shared: bool, device="cuda:0",
             **predictor_kwargs):
    """Every clip through a fresh ``Predictor`` with shared encoding
    ``shared``; ``predictor_kwargs`` reach the predictor (a detector
    backend, a model geometry)."""
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )

    cfg = PredictorConfig(shared_visual_encoding=shared)
    pred = Predictor(model_path=model_path, config=cfg, device=device,
                     **predictor_kwargs)
    out = {}
    t0 = time.perf_counter()
    for i, (path, label) in enumerate(files):
        r = pred.predict(path)
        out[str(path)] = {
            "label": label,
            "verdict": r["verdict"],
            "confidence": float(r["confidence"]),
        }
        if (i + 1) % 25 == 0:
            logger.info("shared=%s: %d/%d clips (%.2f s/clip)", shared,
                        i + 1, len(files),
                        (time.perf_counter() - t0) / (i + 1))
    pred.close()
    return out


def main(argv: Optional[List[str]] = None, **predictor_kwargs) -> int:
    p = argparse.ArgumentParser(
        description="Shared-track-encoding verdict-flip measurement on a "
                    "production replay.")
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--model-path", type=Path, required=True)
    p.add_argument("--limit", type=int, default=200)
    p.add_argument("--out", type=Path,
                   default=REPO / "docs" / "eval"
                   / "shared_encoding_flips_torch.json")
    add_device_argument(p)
    args = p.parse_args(argv)

    files = discover(args.data_dir, args.limit)
    if not files:
        raise SystemExit(f"no clips under {args.data_dir}")
    logger.info("replaying %d clips twice (off/on)", len(files))

    off = run_pass(files, args.model_path, False, args.device,
                   **predictor_kwargs)
    on = run_pass(files, args.model_path, True, args.device,
                  **predictor_kwargs)

    deltas, flips = [], []
    for k in off:
        d = abs(on[k]["confidence"] - off[k]["confidence"])
        deltas.append(d)
        if on[k]["verdict"] != off[k]["verdict"]:
            flips.append({
                "clip": k, "label": off[k]["label"],
                "verdict_off": off[k]["verdict"],
                "verdict_on": on[k]["verdict"],
                "conf_off": off[k]["confidence"],
                "conf_on": on[k]["confidence"],
            })
    deltas = np.asarray(deltas)
    report = {
        "n_clips": len(files),
        "model_path": str(args.model_path),
        "data_dir": str(args.data_dir),
        "verdict_flips": len(flips),
        "flip_details": flips,
        "confidence_abs_delta": {
            "mean": float(deltas.mean()),
            "p95": float(np.percentile(deltas, 95)),
            "max": float(deltas.max()),
        },
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report if len(flips) < 20 else
                     dict(report, flip_details=f"{len(flips)} flips"),
                     indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
