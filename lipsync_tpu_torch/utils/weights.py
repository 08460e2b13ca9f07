"""Shipped-checkpoint discovery.

Counterpart of ``utils/weights.py`` in the JAX package: the committed
flagship checkpoint lives at ``weights/flagship``, and ``MODEL_PATH`` (the
reference's environment override) wins over it. The repository holds no
flagship checkpoint, so :func:`default_checkpoint` returns None unless
``MODEL_PATH`` names a file, and ``Predictor(model_path=None)`` and
``load_engine(None)`` raise. :func:`default_calibration` reads the Platt
constants fitted beside the flagship (``weights/flagship.json``), which
``serving/config.py::get_settings`` applies.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
FLAGSHIP_DIR = REPO_ROOT / "weights" / "flagship"


def default_checkpoint() -> Optional[Path]:
    """The committed flagship checkpoint, or None when absent."""
    if env_path := os.environ.get("MODEL_PATH"):
        p = Path(env_path)
        if p.exists():
            return p
    if FLAGSHIP_DIR.exists():
        return FLAGSHIP_DIR
    return None


def default_calibration() -> Optional[dict]:
    """Platt constants fitted alongside the flagship (``flagship.json``
    sidecar), or None."""
    sidecar = FLAGSHIP_DIR.with_suffix(".json")
    if not sidecar.exists():
        return None
    try:
        meta = json.loads(sidecar.read_text())
    except Exception:
        return None
    if "calibration_platt_a" in meta:
        return {
            "calibration_method": "platt",
            "calibration_platt_a": float(meta["calibration_platt_a"]),
            "calibration_platt_b": float(meta["calibration_platt_b"]),
        }
    return None
