"""Cross-request dynamic batching: coalesce concurrent scoring calls.

Counterpart of ``inference/batcher.py`` in the JAX package. A serving layer
handles requests on a thread pool, and each request scores its windows
through its own engine calls, so at concurrency K the device would see K
small batches instead of one batch K times larger. A shared queue and one
dispatcher thread drain whatever is pending into ONE padded forward (the
engine's power-of-two buckets bound the shapes).

Only the blocking entry points coalesce (``score_logits``,
``score_probs``). The asynchronous ones (``dispatch_logits``,
``dispatch_track_logits``) and the track-gather path pass through to the
inner engine unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class _Pending:
    """One caller's windows awaiting a coalesced forward."""

    __slots__ = ("visual", "audio", "event", "result", "error")

    def __init__(self, visual: np.ndarray, audio: np.ndarray):
        self.visual = visual
        self.audio = audio
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class CoalescingEngine:
    """Thread-safe facade over a :class:`ScoringEngine` that merges
    concurrent ``score_logits``/``score_probs`` calls into shared batches.

    Parameters
    ----------
    engine:
        The inner engine. All other attributes/methods (calibrator,
        config, track scoring, async dispatch) pass through to it.
    max_wait_ms:
        How long the dispatcher lingers after picking up work for more
        requests to land before launching the forward. Zero still
        coalesces whatever arrived while the previous batch was in
        flight (natural batching under load).
    max_batch:
        Per-forward window cap; defaults to the inner engine's.
    """

    def __init__(self, engine, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None):
        self._engine = engine
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.coalesce_max_batch = int(max_batch or engine.max_batch)
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._wakeup = threading.Event()
        self._closed = False
        # Telemetry: how much coalescing actually happens.
        self.batches_dispatched = 0
        self.items_coalesced = 0
        self._thread = threading.Thread(
            target=self._run, name="coalescing-engine", daemon=True
        )
        self._thread.start()

    # ── passthrough ──────────────────────────────────────────────────────
    def __getattr__(self, name):
        return getattr(self._engine, name)

    @property
    def calibrator(self):
        return self._engine.calibrator

    @calibrator.setter
    def calibrator(self, value):
        self._engine.calibrator = value

    # ── coalesced entry points ───────────────────────────────────────────
    def score_logits(self, visual: np.ndarray, audio: np.ndarray
                     ) -> np.ndarray:
        n = int(visual.shape[0])
        if n == 0:
            return np.zeros((0,), np.float32)
        if audio.ndim == 3:
            audio = audio[..., None]
        # Oversized requests stream through in engine-sized chunks so one
        # giant request cannot monopolize a coalesced batch.
        if n > self.coalesce_max_batch:
            parts = [
                self.score_logits(visual[i: i + self.coalesce_max_batch],
                                  audio[i: i + self.coalesce_max_batch])
                for i in range(0, n, self.coalesce_max_batch)
            ]
            return np.concatenate(parts)
        item = _Pending(visual, audio)
        with self._lock:
            if self._closed:
                raise RuntimeError("CoalescingEngine is closed")
            self._queue.append(item)
        self._wakeup.set()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def score_probs(self, visual: np.ndarray, audio: np.ndarray
                    ) -> np.ndarray:
        return self._engine.calibrator(self.score_logits(visual, audio))

    # ── dispatcher ───────────────────────────────────────────────────────
    def _drain(self) -> List[_Pending]:
        """Take queued items up to the batch cap (whole items only; every
        item is <= cap by construction)."""
        batch: List[_Pending] = []
        total = 0
        with self._lock:
            while self._queue:
                n = int(self._queue[0].visual.shape[0])
                if batch and total + n > self.coalesce_max_batch:
                    break
                item = self._queue.pop(0)
                batch.append(item)
                total += n
            if not self._queue:
                self._wakeup.clear()
        return batch

    def _run(self) -> None:
        while True:
            self._wakeup.wait()
            if self._closed:
                break
            # Linger briefly so concurrent requests land in this batch.
            if self.max_wait_s:
                time.sleep(self.max_wait_s)
            batch = self._drain()
            if not batch:
                continue
            try:
                sizes = [int(it.visual.shape[0]) for it in batch]
                visual = (batch[0].visual if len(batch) == 1
                          else np.concatenate([it.visual for it in batch]))
                audio = (batch[0].audio if len(batch) == 1
                         else np.concatenate([it.audio for it in batch]))
                logits = self._engine.score_logits(visual, audio)
                self.batches_dispatched += 1
                self.items_coalesced += len(batch)
                lo = 0
                for it, sz in zip(batch, sizes):
                    it.result = np.asarray(logits[lo: lo + sz], np.float32)
                    lo += sz
                    it.event.set()
            except BaseException as e:  # propagate to every waiter
                logger.exception("Coalesced forward failed")
                for it in batch:
                    if not it.event.is_set():
                        it.error = e
                        it.event.set()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
        self._wakeup.set()
        err = RuntimeError("CoalescingEngine closed")
        for it in pending:
            it.error = err
            it.event.set()
        self._thread.join(timeout=5.0)
