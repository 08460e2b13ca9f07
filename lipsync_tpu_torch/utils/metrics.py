"""Binary classification metrics (1 = FAKE = positive class).

The port's own copy of ``utils/metrics.py`` in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def compute_metrics(
    predicted_is_fake: Sequence[bool], true_is_fake: Sequence[bool]
) -> Dict[str, float]:
    pred = np.asarray(predicted_is_fake, bool)
    true = np.asarray(true_is_fake, bool)
    tp = int(np.sum(pred & true))
    tn = int(np.sum(~pred & ~true))
    fp = int(np.sum(pred & ~true))
    fn = int(np.sum(~pred & true))
    total = len(pred)
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    accuracy = (tp + tn) / total if total > 0 else 0.0
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": accuracy,
        "tp": tp,
        "tn": tn,
        "fp": fp,
        "fn": fn,
        "total": total,
    }


def compute_metrics_at_threshold(
    fake_probs: Sequence[float],
    true_is_fake: Sequence[bool],
    threshold: float = 0.5,
) -> Dict[str, float]:
    """Metrics with P(FAKE) thresholded at ``threshold``
    (metrics.py:79-100)."""
    probs = np.asarray(fake_probs, np.float64)
    pred = probs >= threshold
    out = compute_metrics(pred, true_is_fake)
    out["threshold"] = float(threshold)
    return out


def find_best_threshold(
    fake_probs: Sequence[float],
    true_is_fake: Sequence[bool],
    metric: str = "f1",
    thresholds: Sequence[float] = tuple(np.arange(0.05, 1.0, 0.05)),
) -> Tuple[float, Dict[str, float]]:
    """Sweep thresholds, return (best_threshold, metrics at it)
    (metrics.py:103-136)."""
    best_t, best_m, best_val = 0.5, None, -1.0
    for t in thresholds:
        m = compute_metrics_at_threshold(fake_probs, true_is_fake, float(t))
        if m[metric] > best_val:
            best_val, best_t, best_m = m[metric], float(t), m
    return best_t, best_m if best_m is not None else compute_metrics_at_threshold(
        fake_probs, true_is_fake, best_t
    )
