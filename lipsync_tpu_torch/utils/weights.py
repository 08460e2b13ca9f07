"""Shipped-checkpoint discovery.

Counterpart of ``utils/weights.py`` in the JAX package: the committed
flagship checkpoint lives at ``weights/flagship``, and ``MODEL_PATH`` (the
reference's environment override) wins over it. The repository holds no
flagship checkpoint, so :func:`default_checkpoint` returns None unless
``MODEL_PATH`` names a file, and ``Predictor(model_path=None)`` raises.
"""

from __future__ import annotations

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

