"""kvlite: an embedded key -> blob tensor store on stdlib ``sqlite3``.

The port's own copy of ``utils/kvlite.py`` in the JAX package. The
reference's third storage backend keeps one compressed-npz blob per sample
key in an LMDB file; without the ``lmdb`` wheel the same contract (a
single-file, native-code key-value store) lives in a SQLite file with one
``kv (k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID`` table. The API
subset the repo uses is shaped like ``lmdb``'s::

    env = kvlite.open(path)                  # or lmdb.open(...)
    with env.begin(write=True) as txn:
        txn.put(b"key", blob)
    with env.begin() as txn:
        blob = txn.get(b"key")
    env.sync(); env.close()

Files self-identify: SQLite databases start with the 16-byte header
``b"SQLite format 3\\0"``, LMDB data files carry magic ``0xBEEFC0DE`` in
their first meta page. :func:`is_sqlite_file` and :func:`is_lmdb_file`
tell them apart; the port reads and writes the SQLite format only.
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path
from typing import Optional

_SQLITE_HEADER = b"SQLite format 3\x00"
_LMDB_MAGIC = (0xBEEFC0DE).to_bytes(4, "little")


def is_sqlite_file(path: Path) -> bool:
    try:
        with Path(path).open("rb") as f:
            return f.read(16) == _SQLITE_HEADER
    except OSError:
        return False


def is_lmdb_file(path: Path) -> bool:
    """True for real (wheel-written) LMDB data files. The meta page starts
    with a 16-byte page header; ``mm_magic`` sits at offset 16 (12 on
    ancient layouts; both checked)."""
    try:
        with Path(path).open("rb") as f:
            head = f.read(32)
    except OSError:
        return False
    return head[16:20] == _LMDB_MAGIC or head[12:16] == _LMDB_MAGIC


class Error(RuntimeError):
    pass


class _Txn:
    """One transaction, context-managed like ``lmdb.Transaction``: commit on
    clean exit, rollback on exception. It holds the store's lock until it
    exits."""

    def __init__(self, conn: sqlite3.Connection, write: bool,
                 lock: threading.Lock):
        self._conn = conn
        self._write = write
        self._lock = lock
        self._lock.acquire()

    def get(self, key: bytes, default: Optional[bytes] = None):
        row = self._conn.execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return default if row is None else row[0]

    def put(self, key: bytes, value: bytes) -> bool:
        if not self._write:
            raise Error("put() inside a read-only transaction")
        self._conn.execute(
            "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
            (key, sqlite3.Binary(value)),
        )
        return True

    def delete(self, key: bytes) -> bool:
        if not self._write:
            raise Error("delete() inside a read-only transaction")
        cur = self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
        return cur.rowcount > 0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._write:
                if exc_type is None:
                    self._conn.commit()
                else:
                    self._conn.rollback()
        finally:
            self._lock.release()
        return False


class Env:
    """One sqlite connection shared across threads, serialised by a
    per-transaction lock: ``begin()`` blocks until the previous transaction
    exits, so a reader never sees a writer's uncommitted rows and commits
    from two threads cannot interleave. Do not nest transactions on one
    thread: ``begin()`` inside an open transaction deadlocks."""

    def __init__(self, path: Path, readonly: bool = False):
        self._lock = threading.Lock()
        path = Path(path)
        self.path = path
        self.readonly = readonly
        if readonly:
            if not path.is_file():
                raise Error(f"No such kvlite store: {path}")
            self._conn = sqlite3.connect(
                f"file:{path}?mode=ro", uri=True, check_same_thread=False
            )
        else:
            self._conn = sqlite3.connect(str(path), check_same_thread=False)
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
            )
            self._conn.commit()

    def begin(self, write: bool = False) -> _Txn:
        if write and self.readonly:
            raise Error("write transaction on a read-only Env")
        return _Txn(self._conn, write, self._lock)

    def sync(self) -> None:
        if not self.readonly:
            with self._lock:
                self._conn.commit()

    def stat(self) -> dict:
        with self._lock:
            n = self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]
        return {"entries": int(n)}

    def close(self) -> None:
        try:
            self.sync()
        finally:
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def open(path, readonly: bool = False, **_compat) -> Env:  # noqa: A001
    """Open (creating it if writable) a kvlite store. Extra ``lmdb.open``
    keyword arguments (``map_size``, ``subdir``, ``lock``, ...) are accepted
    and ignored."""
    return Env(Path(path), readonly=readonly)
