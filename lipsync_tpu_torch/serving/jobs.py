"""Async job queue on stdlib sqlite3.

Counterpart of ``serving/jobs.py`` in the JAX package (the reference's
SQLAlchemy job layer without the ORM): the same table, the same atomic
claim by compare-and-update on (status, updated_at), the same reclaim of a
stale PROCESSING job after the processing timeout. WAL mode lets a
standalone worker process share the database.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Any, Dict, Optional
from uuid import uuid4

PENDING = "PENDING"
PROCESSING = "PROCESSING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    status TEXT NOT NULL DEFAULT 'PENDING',
    input_path TEXT NOT NULL,
    payload TEXT,
    result TEXT,
    error TEXT,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_jobs_status ON jobs (status);
CREATE INDEX IF NOT EXISTS idx_jobs_updated ON jobs (updated_at);
"""


def _utc_now() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclasses.dataclass
class Job:
    job_id: str
    status: str
    input_path: str
    payload: Optional[str]
    result: Optional[str]
    error: Optional[str]
    created_at: str
    updated_at: str


class JobStore:
    """Thread-safe sqlite job store (one connection per store, serialized
    by a lock; WAL mode so a standalone worker process can share the db)."""

    def __init__(self, db_path: str = "./jobs.db"):
        self.db_path = str(db_path)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(
            self.db_path, check_same_thread=False, timeout=30.0
        )
        self._conn.row_factory = sqlite3.Row
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # ── CRUD ──────────────────────────────────────────────────────────────

    def create_job(
        self, input_path: Path, payload: Optional[Dict[str, Any]] = None
    ) -> Job:
        now = _utc_now()
        job_id = str(uuid4())
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (job_id, status, input_path, payload, "
                "created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?)",
                (
                    job_id, PENDING, str(input_path),
                    json.dumps(payload) if payload else None, now, now,
                ),
            )
            self._conn.commit()
        return self.get_job(job_id)

    def get_job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
        return Job(**dict(row)) if row else None

    def get_next_claimable_job(
        self, processing_timeout_sec: int = 900
    ) -> Optional[Job]:
        """Atomically claim the oldest PENDING (or stale PROCESSING) job via
        compare-and-update on (status, updated_at)."""
        stale_cutoff = (
            datetime.now(timezone.utc) - timedelta(seconds=processing_timeout_sec)
        ).isoformat()
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE status = ? "
                "OR (status = ? AND updated_at < ?) "
                "ORDER BY created_at ASC LIMIT 1",
                (PENDING, PROCESSING, stale_cutoff),
            ).fetchone()
            if row is None:
                return None
            cur = self._conn.execute(
                "UPDATE jobs SET status = ?, updated_at = ?, error = NULL "
                "WHERE job_id = ? AND status = ? AND updated_at = ?",
                (
                    PROCESSING, _utc_now(), row["job_id"], row["status"],
                    row["updated_at"],
                ),
            )
            if cur.rowcount != 1:
                self._conn.rollback()
                return None
            self._conn.commit()
        return self.get_job(row["job_id"])

    def mark_completed(self, job_id: str, result: Dict[str, Any]) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET status = ?, result = ?, error = NULL, "
                "updated_at = ? WHERE job_id = ?",
                (COMPLETED, json.dumps(result), _utc_now(), job_id),
            )
            self._conn.commit()

    def mark_failed(self, job_id: str, error: str) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET status = ?, error = ?, updated_at = ? "
                "WHERE job_id = ?",
                (FAILED, error[:4000], _utc_now(), job_id),
            )
            self._conn.commit()
