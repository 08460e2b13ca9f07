"""zarr-v2 directory stores, read and written without the zarr wheel.

The port's own copy of ``utils/zarrlite.py`` in the JAX package.
Preprocessed training tensors may live in a zarr group,
``samples.zarr/<key>/{visual,audio}``; zarr v2's directory store is
``.zgroup``/``.zarray`` JSON metadata plus one file per chunk, so stdlib
``json`` + ``zlib`` + numpy read and write it:

* groups (``.zgroup``), nested sub-groups, ``require_group``, ``in`` and
  ``[]``;
* C-order arrays with any chunk grid, edge chunks stored full-size and
  sliced on read, missing chunks read as the fill value;
* compressors ``null``, ``zlib`` and ``gzip`` on read, ``null`` and
  ``zlib`` on write. Others (blosc, real zarr's default) raise an error
  that names the fix.

Only whole-array reads (``arr[:]``) are supported: the training data path
reads nothing else. The writer emits the same ``.zarray`` and chunk bytes
as the JAX package's, so either package reads the other's stores.
"""

from __future__ import annotations

import itertools
import json
import shutil
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ZARR_FORMAT = 2


class ZarrLiteError(RuntimeError):
    pass


def _dtype_to_descr(dtype: np.dtype) -> str:
    """zarr v2 dtype encoding (numpy descr string, e.g. '<f4', '|u1')."""
    return np.dtype(dtype).str


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


def _compress(raw: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.compress(raw, compressor.get("level", 1))
    raise ZarrLiteError(f"Unsupported write compressor {cid!r} (use zlib)")


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
    """A zarr-v2 group directory: sub-groups and arrays by name. Modes
    ``"a"`` and ``"w"`` create the directory and its ``.zgroup``; ``"r"``
    requires them and refuses writes."""

    def __init__(self, path: Path, mode: str = "r"):
        self.path = Path(path)
        self.mode = mode
        zgroup = self.path / ".zgroup"
        if mode in ("a", "w"):
            self.path.mkdir(parents=True, exist_ok=True)
            if not zgroup.exists():
                zgroup.write_text(json.dumps({"zarr_format": _ZARR_FORMAT}))
        elif not zgroup.is_file():
            raise ZarrLiteError(f"Not a zarr group (no .zgroup): {self.path}")

    # -- reading -----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        child = self.path / name
        return (child / ".zgroup").is_file() or (child / ".zarray").is_file()

    def __getitem__(self, name: str):
        child = self.path / name
        if (child / ".zarray").is_file():
            return ZarrArray(child)
        if (child / ".zgroup").is_file():
            return ZarrGroup(child, mode=self.mode)
        raise KeyError(name)

    def keys(self):
        """Names of the sub-groups and arrays, sorted."""
        if not self.path.is_dir():
            return
        for child in sorted(self.path.iterdir()):
            if (child / ".zgroup").is_file() or (child / ".zarray").is_file():
                yield child.name

    # -- writing -----------------------------------------------------------
    def require_group(self, name: str) -> "ZarrGroup":
        if self.mode == "r":
            raise ZarrLiteError("Group opened read-only")
        return ZarrGroup(self.path / name, mode=self.mode)

    def create_array(
        self,
        name: str,
        data: np.ndarray,
        chunks: Optional[Sequence[int]] = None,
        compressor: Optional[dict] = None,
        overwrite: bool = True,
    ) -> ZarrArray:
        """Write ``data`` as array ``name``: zlib level 1 unless
        ``compressor`` says otherwise (``"none"``: uncompressed), one chunk
        up to 32 MB unless ``chunks`` says otherwise, edge chunks padded to
        the full chunk shape."""
        if self.mode == "r":
            raise ZarrLiteError("Group opened read-only")
        data = np.ascontiguousarray(data)
        if compressor is None:
            compressor = {"id": "zlib", "level": 1}
        elif compressor == "none":
            compressor = None
        if chunks is None:
            chunks = _default_chunks(data.shape, data.dtype.itemsize)
        chunks = tuple(int(c) for c in chunks)
        arr_dir = self.path / name
        if arr_dir.exists() and overwrite:
            shutil.rmtree(arr_dir)
        arr_dir.mkdir(parents=True, exist_ok=True)
        meta = {
            "zarr_format": _ZARR_FORMAT,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": _dtype_to_descr(data.dtype),
            "compressor": compressor,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        (arr_dir / ".zarray").write_text(json.dumps(meta))
        grid = [
            range((s + c - 1) // c) for s, c in zip(data.shape, chunks)
        ]
        for idx in itertools.product(*grid):
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, data.shape)
            )
            block = data[sel]
            if block.shape != chunks:  # edge chunk: pad to full chunk shape
                padded = np.zeros(chunks, dtype=data.dtype)
                padded[tuple(slice(0, b) for b in block.shape)] = block
                block = padded
            blob = _compress(np.ascontiguousarray(block).tobytes(), compressor)
            (arr_dir / _chunk_key(idx)).write_bytes(blob)
        return ZarrArray(arr_dir)


def _default_chunks(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """Single chunk up to ~32 MB, else split along axis 0."""
    if not shape:
        return (1,)
    total = int(np.prod(shape)) * itemsize
    limit = 32 * 1024 * 1024
    if total <= limit or shape[0] <= 1:
        return tuple(shape)
    row = total // shape[0]
    rows = max(1, limit // max(row, 1))
    return (min(int(rows), shape[0]),) + tuple(shape[1:])


def open_group(path, mode: str = "r") -> ZarrGroup:
    """Open (``"r"``) or create (``"a"``/``"w"``) a zarr-v2 group directory;
    ``"w"`` first removes an existing one."""
    if mode == "w":
        p = Path(path)
        if p.exists():
            shutil.rmtree(p)
    return ZarrGroup(Path(path), mode=mode)
