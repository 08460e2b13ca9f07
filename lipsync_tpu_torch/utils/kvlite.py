"""Reader of kvlite stores: key -> blob tensor files on stdlib ``sqlite3``.

The port's own copy of the reading half of ``utils/kvlite.py`` in the JAX
package. The reference's third storage backend keeps one compressed-npz
blob per sample key in an LMDB file; without the ``lmdb`` wheel the JAX
package's tooling writes the same contract into a SQLite file with one
``kv (k BLOB PRIMARY KEY, v BLOB)`` table. The read API is shaped like
``lmdb``'s::

    env = kvlite.open(path, readonly=True)
    with env.begin() as txn:
        blob = txn.get(b"key")

SQLite files start with ``b"SQLite format 3\\0"``; :func:`is_sqlite_file`
tells them from wheel-written LMDB files, which the port cannot read.
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path
from typing import Optional

_SQLITE_HEADER = b"SQLite format 3\x00"


def is_sqlite_file(path: Path) -> bool:
    try:
        with Path(path).open("rb") as f:
            return f.read(16) == _SQLITE_HEADER
    except OSError:
        return False


class Error(RuntimeError):
    pass


class _Txn:
    """One read transaction, context-managed like ``lmdb.Transaction``; it
    holds the store's lock until it exits."""

    def __init__(self, conn: sqlite3.Connection, lock: threading.Lock):
        self._conn = conn
        self._lock = lock
        self._lock.acquire()

    def get(self, key: bytes, default: Optional[bytes] = None):
        row = self._conn.execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return default if row is None else row[0]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._lock.release()
        return False


class Env:
    """One read-only sqlite connection shared across threads; ``begin()``
    serialises transactions (the loader's are short per-sample gets). Do
    not nest transactions on one thread."""

    def __init__(self, path: Path):
        path = Path(path)
        if not path.is_file():
            raise Error(f"No such kvlite store: {path}")
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(
            f"file:{path}?mode=ro", uri=True, check_same_thread=False
        )

    def begin(self, write: bool = False) -> _Txn:
        if write:
            raise Error("the port reads kvlite stores only")
        return _Txn(self._conn, self._lock)

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def open(path, readonly: bool = True, **_compat) -> Env:  # noqa: A001
    """Open a kvlite store for reading. Extra ``lmdb.open`` keyword
    arguments are accepted and ignored."""
    if not readonly:
        raise Error("the port reads kvlite stores only")
    return Env(Path(path))
