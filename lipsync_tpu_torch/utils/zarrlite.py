"""Reader of zarr-v2 directory stores, without the zarr wheel.

The port's own copy of the reading half of ``utils/zarrlite.py`` in the
JAX package. Preprocessed training tensors may live in a zarr group,
``samples.zarr/<key>/{visual,audio}``; zarr v2's directory store is
``.zgroup``/``.zarray`` JSON metadata plus one file per chunk, so stdlib
``json`` + ``zlib`` + numpy read it:

* groups (``.zgroup``), nested sub-groups, ``in`` and ``[]``;
* C-order arrays with any chunk grid, edge chunks stored full-size and
  sliced on read, missing chunks read as the fill value;
* compressors ``null``, ``zlib`` and ``gzip``. Others (blosc, real zarr's
  default) raise an error that names the fix.

Only whole-array reads (``arr[:]``) are supported: the training data path
reads nothing else. Stores are written by the JAX package's tooling.
"""

from __future__ import annotations

import itertools
import json
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ZARR_FORMAT = 2


class ZarrLiteError(RuntimeError):
    pass


def _chunk_key(idx: Tuple[int, ...], separator: str = ".") -> str:
    if not idx:
        return "0"
    return separator.join(str(i) for i in idx)


def _decompress(blob: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return blob
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(blob)
    if cid == "gzip":
        import gzip

        return gzip.decompress(blob)
    raise ZarrLiteError(
        f"Unsupported zarr compressor {cid!r} (this minimal codec reads "
        "null/zlib/gzip; re-encode the store with compressor=Zlib())"
    )


class ZarrArray:
    """Read handle on one zarr-v2 array directory."""

    def __init__(self, path: Path):
        self.path = Path(path)
        meta_path = self.path / ".zarray"
        if not meta_path.is_file():
            raise ZarrLiteError(f"Not a zarr array (no .zarray): {self.path}")
        meta = json.loads(meta_path.read_text())
        if int(meta.get("zarr_format", 0)) != _ZARR_FORMAT:
            raise ZarrLiteError(
                f"Unsupported zarr_format {meta.get('zarr_format')} at "
                f"{self.path} (only v2)"
            )
        if meta.get("order", "C") != "C":
            raise ZarrLiteError("Only C-order arrays are supported")
        if meta.get("filters"):
            raise ZarrLiteError("zarr filters are not supported")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.fill_value = meta.get("fill_value", 0)
        self._separator = meta.get("dimension_separator", ".")

    def read(self) -> np.ndarray:
        """Assemble the full array from its chunk grid."""
        fill = 0 if self.fill_value is None else self.fill_value
        out = np.full(self.shape, fill, dtype=self.dtype)
        grid = [
            range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)
        ]
        for idx in itertools.product(*grid):
            key = _chunk_key(idx, self._separator)
            chunk_path = self.path / key
            if not chunk_path.is_file() and self._separator == ".":
                # Some writers use "/"-separated nested chunk dirs.
                chunk_path = self.path.joinpath(*key.split("."))
            if not chunk_path.is_file():
                continue  # missing chunk -> fill_value (spec-compliant)
            raw = _decompress(chunk_path.read_bytes(), self.compressor)
            chunk = np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[trim]
        return out

    def __getitem__(self, key) -> np.ndarray:
        full = self.read()
        if key is Ellipsis or key == slice(None):
            return full
        return full[key]


class ZarrGroup:
    """A zarr-v2 group directory: sub-groups and arrays by name."""

    def __init__(self, path: Path):
        self.path = Path(path)
        if not (self.path / ".zgroup").is_file():
            raise ZarrLiteError(f"Not a zarr group (no .zgroup): {self.path}")

    def __contains__(self, name: str) -> bool:
        child = self.path / name
        return (child / ".zgroup").is_file() or (child / ".zarray").is_file()

    def __getitem__(self, name: str):
        child = self.path / name
        if (child / ".zarray").is_file():
            return ZarrArray(child)
        if (child / ".zgroup").is_file():
            return ZarrGroup(child)
        raise KeyError(name)


def open_group(path) -> ZarrGroup:
    """Open a zarr-v2 group directory for reading."""
    return ZarrGroup(Path(path))
