"""Threshold sweep over an existing predictions.csv.

    python -m lipsync_tpu_torch.tools.checking_threshold \
        eval_out/predictions.csv

The port's counterpart of the JAX package's script ``checking_threshold``:
the confusion at candidate P(FAKE) thresholds 0.05-0.95 from saved
evaluation output (``tools/validate_pipeline.py``'s ``predictions.csv``;
error rows left out), through ``utils/metrics.py::
compute_metrics_at_threshold``. Host only.
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import numpy as np

from lipsync_tpu_torch.utils.metrics import compute_metrics_at_threshold


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    pred_csv = Path(argv[0]) if argv else Path("eval_out/predictions.csv")
    rows = [r for r in csv.DictReader(pred_csv.open())
            if r.get("verdict") != "error"]
    fake_probs = np.array([1.0 - float(r["confidence"]) for r in rows])
    true_fake = np.array([int(r["true_label"]) == 0 for r in rows])
    results = []
    for t in np.arange(0.05, 1.0, 0.05):
        m = compute_metrics_at_threshold(fake_probs, true_fake, float(t))
        results.append(m)
        print(
            f"t={t:.2f} acc={m['accuracy']:.4f} P={m['precision']:.4f} "
            f"R={m['recall']:.4f} F1={m['f1']:.4f} "
            f"(tp={m['tp']} fp={m['fp']} tn={m['tn']} fn={m['fn']})"
        )
    return results


if __name__ == "__main__":
    main()
