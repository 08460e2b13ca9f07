"""Background job worker.

Counterpart of ``serving/worker.py`` in the JAX package: a thread that
claims jobs (stale reclaim included), runs the port's ``Predictor`` and
persists results or failures. It runs embedded in the API process or on
its own:

    python -m lipsync_tpu_torch.serving.worker

which serves on ``Settings.device`` (cuda:0 by default; it raises where
there is no CUDA).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Optional

from lipsync_tpu_torch.serving.jobs import JobStore
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class JobWorker:
    def __init__(
        self,
        predictor,
        store: JobStore,
        poll_interval_sec: float = 1.0,
        processing_timeout_sec: int = 900,
    ):
        self.predictor = predictor
        self.store = store
        self.poll_interval_sec = max(0.05, poll_interval_sec)
        self.processing_timeout_sec = max(30, processing_timeout_sec)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        if self._thread and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()
        logger.info("Job worker started (poll=%.1fs)", self.poll_interval_sec)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
        logger.info("Job worker stopped")

    def run_once(self) -> bool:
        """Claim and execute one job. Returns True if a job was processed."""
        job = self.store.get_next_claimable_job(self.processing_timeout_sec)
        if job is None:
            return False
        logger.info("Processing job %s (%s)", job.job_id, job.input_path)
        try:
            result = self.predictor.predict(job.input_path)
            self.store.mark_completed(job.job_id, result)
        except Exception as e:
            logger.exception("Job %s failed", job.job_id)
            self.store.mark_failed(
                job.job_id, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            )
        return True

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            try:
                processed = self.run_once()
            except Exception:
                logger.exception("Worker loop error")
                processed = False
            if not processed:
                self._stop.wait(self.poll_interval_sec)


def main() -> None:
    """The standalone worker process."""
    from lipsync_tpu_torch.inference.predictor import Predictor
    from lipsync_tpu_torch.serving.config import get_settings

    settings = get_settings()
    store = JobStore(settings.sqlite_db_path)
    predictor = Predictor(
        model_path=settings.model_path,
        config=settings.to_predictor_config(),
        device=settings.device,
    )
    worker = JobWorker(
        predictor, store,
        poll_interval_sec=settings.worker_poll_interval_sec,
        processing_timeout_sec=settings.worker_processing_timeout_sec,
    )
    worker.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        worker.stop()


if __name__ == "__main__":
    main()
