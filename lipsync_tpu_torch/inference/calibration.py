"""Output calibration: temperature / Platt / isotonic.

Copy of ``inference/calibration.py`` in the JAX package (numpy; the
temperature and Platt fitters import scipy when called). Operates on arrays
of logits so the batched scoring engine calibrates a whole window batch at
once. The isotonic fit is the port's own (:class:`IsotonicCalibrator`): the
JAX package fits and pickles sklearn's ``IsotonicRegression``, which the
card's machine does not have.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import numpy as np

from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


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
            except Exception as e:  # the JAX package's fall-back, said aloud
                logger.warning(
                    "Cannot load the isotonic calibrator %s (%s: %s); "
                    "serving uncalibrated P(REAL)", isotonic_path,
                    type(e).__name__, e)
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


class IsotonicCalibrator:
    """A fitted isotonic map from raw P(REAL) to calibrated P(REAL), with
    the semantics of sklearn's ``IsotonicRegression(out_of_bounds="clip",
    y_min=0, y_max=1)``: equal inputs pooled into their mean label, a
    pool-adjacent-violators fit, outputs clipped to [0, 1], queries clipped
    to the fitted range and interpolated linearly between thresholds. Plain
    numpy; it pickles and unpickles without sklearn."""

    def __init__(self, x_thresholds: np.ndarray, y_thresholds: np.ndarray):
        self.x_thresholds = np.asarray(x_thresholds, np.float64)
        self.y_thresholds = np.asarray(y_thresholds, np.float64)

    @classmethod
    def fit(cls, x: np.ndarray, y: np.ndarray) -> "IsotonicCalibrator":
        x = np.asarray(x, np.float64).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        if x.shape != y.shape or x.size == 0:
            raise ValueError(f"isotonic fit needs equal, non-empty x and y: "
                             f"{x.shape} vs {y.shape}")
        order = np.lexsort((y, x))
        ux, uy, uw = _pool_equal_x(x[order], y[order])
        fitted = np.clip(_pool_adjacent_violators(uy, uw), 0.0, 1.0)
        # Keep the ends and every point where the fitted value changes.
        keep = np.ones(len(fitted), bool)
        keep[1:-1] = ((fitted[1:-1] != fitted[:-2])
                      | (fitted[1:-1] != fitted[2:]))
        return cls(ux[keep], fitted[keep])

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.clip(np.asarray(x, np.float64).reshape(-1),
                    self.x_thresholds[0], self.x_thresholds[-1])
        if len(self.x_thresholds) == 1:
            return np.full(x.shape, self.y_thresholds[0])
        return np.interp(x, self.x_thresholds, self.y_thresholds)


def _pool_equal_x(x: np.ndarray, y: np.ndarray):
    """Sorted ``x`` -> (unique x, mean y, count), taking x within float64
    resolution (1e-15) of its group's first value as equal, as sklearn
    does."""
    eps = np.finfo(np.float64).resolution
    starts = [0]
    for j in range(1, len(x)):
        if x[j] - x[starts[-1]] >= eps:
            starts.append(j)
    bounds = starts + [len(x)]
    ux = x[starts]
    uw = np.diff(bounds).astype(np.float64)
    uy = np.array([y[a:b].sum() for a, b in zip(bounds, bounds[1:])]) / uw
    return ux, uy, uw


def _pool_adjacent_violators(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The weighted least-squares non-decreasing fit of ``y``: merge each
    block that falls below the one before it into that one, at their
    weighted mean, until no block does."""
    means, weights, sizes = [], [], []
    for value, weight in zip(y, w):
        means.append(float(value))
        weights.append(float(weight))
        sizes.append(1)
        while len(means) > 1 and means[-2] > means[-1]:
            m, wt, n = means.pop(), weights.pop(), sizes.pop()
            total = weights[-1] + wt
            means[-1] = (means[-1] * weights[-1] + m * wt) / total
            weights[-1] = total
            sizes[-1] += n
    return np.repeat(means, sizes)


def fit_isotonic(probs: np.ndarray, labels: np.ndarray) -> IsotonicCalibrator:
    """Isotonic calibration of raw P(REAL) against labels
    (fit_calibrator.py:123-141), by :class:`IsotonicCalibrator`."""
    return IsotonicCalibrator.fit(probs, labels)
