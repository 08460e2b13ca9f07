"""Upload persistence helpers.

Counterpart of ``utils/file_manager.py`` in the JAX package (the
reference's ``app/utils/file_manager.py``).
"""

from __future__ import annotations

import tempfile
from pathlib import Path


def save_bytes_to_temp(data: bytes, suffix: str = ".mp4") -> Path:
    """Persist uploaded bytes to a temp file and return its path."""
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    try:
        f.write(data)
    finally:
        f.close()
    return Path(f.name)
