"""Output calibration: temperature / Platt / isotonic.

Copy of ``inference/calibration.py`` in the JAX package (numpy only; the
fitters import scipy/sklearn when called). Operates on arrays of logits so
the batched scoring engine calibrates a whole window batch at once.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


@dataclasses.dataclass
class Calibrator:
    method: str = "none"  # none | temperature | platt | isotonic
    temperature: float = 1.0
    platt_a: float = 1.0
    platt_b: float = 0.0
    isotonic_model: Optional[object] = None

    @classmethod
    def from_config(
        cls,
        method: str = "none",
        temperature: float = 1.0,
        platt_a: float = 1.0,
        platt_b: float = 0.0,
        isotonic_path: Optional[str] = None,
    ) -> "Calibrator":
        allowed = {"none", "temperature", "platt", "isotonic"}
        method = method if method in allowed else "none"
        iso = None
        if method == "isotonic" and isotonic_path:
            try:
                with open(isotonic_path, "rb") as f:
                    iso = pickle.load(f)
            except Exception:
                method = "none"
        return cls(
            method=method,
            temperature=float(max(1e-3, temperature)),
            platt_a=float(platt_a),
            platt_b=float(platt_b),
            isotonic_model=iso,
        )

    def __call__(self, logits: np.ndarray) -> np.ndarray:
        """logits (N,) -> calibrated P(REAL) (N,)."""
        logits = np.asarray(logits, np.float64)
        if self.method == "temperature":
            return _sigmoid(logits / self.temperature).astype(np.float32)
        if self.method == "platt":
            return _sigmoid(self.platt_a * logits + self.platt_b).astype(
                np.float32
            )
        if self.method == "isotonic" and self.isotonic_model is not None:
            raw = _sigmoid(logits)
            cal = self.isotonic_model.predict(raw.reshape(-1, 1))
            return np.clip(np.asarray(cal, np.float32).reshape(-1), 0.0, 1.0)
        return _sigmoid(logits).astype(np.float32)


# ── Fitting (fit_calibrator.py parity) ────────────────────────────────────


def fit_temperature(logits: np.ndarray, labels: np.ndarray) -> float:
    """NLL-minimizing temperature (fit_calibrator.py:87-101)."""
    from scipy.optimize import minimize_scalar

    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels, np.float64)

    def nll(t):
        p = np.clip(_sigmoid(logits / max(t, 1e-3)), 1e-7, 1 - 1e-7)
        return -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))

    res = minimize_scalar(nll, bounds=(0.05, 20.0), method="bounded")
    return float(res.x)


def fit_platt(
    logits: np.ndarray, labels: np.ndarray, smooth_targets: bool = True
) -> tuple:
    """Nelder-Mead Platt scaling (fit_calibrator.py:104-120).

    TPU-rebuild deviation: by default the hard 0/1 labels are replaced by
    Platt's (1999) smoothed targets t+ = (N+ + 1)/(N+ + 2),
    t- = 1/(N- + 2). The reference's unregularized NLL fit diverges
    (a -> inf) whenever the calibration split is perfectly separable —
    measured on the round-5 regen (a=103.3, b=-383.3, a step function that
    saturates every downstream confidence and breaks the uncertain-margin
    logic). The smoothed targets bound the MLE on separable data while
    matching the reference fit in the non-separable regime. Set
    ``smooth_targets=False`` for the literal reference behavior.
    """
    from scipy.optimize import minimize

    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels, np.float64)
    targets = labels
    if smooth_targets:
        n_pos = float(labels.sum())
        n_neg = float(len(labels) - n_pos)
        t_pos = (n_pos + 1.0) / (n_pos + 2.0)
        t_neg = 1.0 / (n_neg + 2.0)
        targets = np.where(labels > 0.5, t_pos, t_neg)

    def nll(ab):
        p = np.clip(_sigmoid(ab[0] * logits + ab[1]), 1e-7, 1 - 1e-7)
        return -np.mean(
            targets * np.log(p) + (1 - targets) * np.log(1 - p)
        )

    res = minimize(nll, x0=[1.0, 0.0], method="Nelder-Mead")
    return float(res.x[0]), float(res.x[1])


def fit_isotonic(probs: np.ndarray, labels: np.ndarray):
    """sklearn isotonic regression (fit_calibrator.py:123-141)."""
    from sklearn.isotonic import IsotonicRegression

    iso = IsotonicRegression(out_of_bounds="clip", y_min=0.0, y_max=1.0)
    iso.fit(np.asarray(probs, np.float64), np.asarray(labels, np.float64))
    return iso
