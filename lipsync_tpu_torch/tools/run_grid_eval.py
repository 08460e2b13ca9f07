"""GRID-corpus evaluation.

    python -m lipsync_tpu_torch.tools.run_grid_eval --videos-dir grid/s1 \
        --model-path W
    python -m lipsync_tpu_torch.tools.run_grid_eval \
        --labels-csv labels.csv --model-path W

The port's counterpart of the JAX package's ``scripts/run_grid_eval.py``:
evaluate directories of GRID ``.mpg`` clips (all REAL) or a labels CSV
(``path,label`` with 1 = REAL) through the single-window production scorer
(``Predictor.predict_from_path``: the log-mel K1 and the model's K2 on
``--device``); prints accuracy, P, R, F1 and the best-F1 threshold. A clip
that is missing or cannot be decoded is skipped; any other failure ends
the run (``tools/common.py``).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import (
    add_device_argument,
    host_stage_failed,
)
from lipsync_tpu_torch.utils.logger import get_logger
from lipsync_tpu_torch.utils.metrics import (
    compute_metrics_at_threshold,
    find_best_threshold,
)

logger = get_logger("run_grid_eval")

GRID_EXTENSIONS = (".mpg", ".mpeg", ".mp4", ".avi", ".mov")


def collect_samples(args):
    samples = []
    if args.labels_csv:
        with open(args.labels_csv) as f:
            for row in csv.DictReader(f):
                samples.append((Path(row["path"]), int(row["label"])))
    else:
        for p in sorted(Path(args.videos_dir).rglob("*")):
            if p.suffix.lower() in GRID_EXTENSIONS:
                samples.append((p, 1))  # GRID clips are all real
    if args.limit:
        samples = samples[: args.limit]
    return samples


def main(argv: Optional[List[str]] = None, predictor=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--videos-dir", type=Path, default=None)
    p.add_argument("--labels-csv", type=Path, default=None)
    p.add_argument("--model-path", type=Path, default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--limit", type=int, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)

    if predictor is None:
        from lipsync_tpu_torch.inference.predictor import Predictor

        predictor = Predictor(model_path=args.model_path, device=args.device)

    samples = collect_samples(args)
    logger.info("Evaluating %d clips", len(samples))
    fake_probs, true_fake = [], []
    for path, label in samples:
        if not Path(path).is_file():
            logger.warning("Failed %s: no such file", path)
            continue
        try:
            result = predictor.predict_from_path(path)
        except Exception as e:
            if not host_stage_failed(e):
                raise
            logger.warning("Failed %s: %s", path, e)
            continue
        fake_probs.append(result["manipulation_probability"])
        true_fake.append(label == 0)

    fake_probs = np.asarray(fake_probs)
    true_fake = np.asarray(true_fake)
    m = compute_metrics_at_threshold(fake_probs, true_fake, args.threshold)
    print(
        f"accuracy={m['accuracy']:.4f} precision={m['precision']:.4f} "
        f"recall={m['recall']:.4f} f1={m['f1']:.4f} "
        f"(tp={m['tp']} tn={m['tn']} fp={m['fp']} fn={m['fn']})"
    )
    if true_fake.any() and (~true_fake).any():
        best_t, best_m = find_best_threshold(fake_probs, true_fake)
        print(f"best_f1={best_m['f1']:.4f} at threshold={best_t:.2f}")
    return m


if __name__ == "__main__":
    main()
