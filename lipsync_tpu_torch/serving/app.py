"""HTTP service exposing the reference's REST contract.

Counterpart of ``serving/app.py`` in the JAX package, with the same routes,
bodies and status codes:

    GET  /                       service info
    POST /api/lip-sync           multipart upload -> LipSyncResponse
    POST /jobs                   multipart upload -> job id
    GET  /result/{job_id}        202 until COMPLETED; minimal vs debug payload
    POST /api/metrics/evaluate   batch P/R/F1
    GET  /healthz

Built on stdlib ``http.server`` (threaded) and the stdlib response models
of ``serving/schemas.py``; the prediction path is the port's
``Predictor`` on ``Settings.device``, behind a ``CoalescingEngine`` that
merges concurrent requests' windows into shared forwards. Run it with

    python -m lipsync_tpu_torch.serving.app

(cuda:0 by default; it raises where there is no CUDA). A missing model
file leaves the service up without a model: predict routes answer 503.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from lipsync_tpu_torch.serving.config import Settings, get_settings
from lipsync_tpu_torch.serving.jobs import JobStore
from lipsync_tpu_torch.serving.schemas import (
    BatchEvaluateResponse,
    JobResultResponse,
    LipSyncResponse,
    PredictJobCreateResponse,
)
from lipsync_tpu_torch.serving.worker import JobWorker
from lipsync_tpu_torch.utils.file_manager import save_bytes_to_temp
from lipsync_tpu_torch.utils.logger import get_logger
from lipsync_tpu_torch.utils.metrics import compute_metrics

logger = get_logger(__name__)

MINIMAL_RESULT_KEYS = {
    "verdict", "is_real", "is_fake", "confidence",
    "manipulation_probability", "detail",
}


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Minimal multipart/form-data parser: name -> (filename, data)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = b"--" + m.group(1).encode()
    parts: Dict[str, Tuple[str, bytes]] = {}
    for chunk in body.split(boundary)[1:]:
        if chunk in (b"--\r\n", b"--"):
            continue
        chunk = chunk.lstrip(b"\r\n")
        header_end = chunk.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = chunk[:header_end].decode("utf-8", "replace")
        data = chunk[header_end + 4 :]
        if data.endswith(b"\r\n"):
            data = data[:-2]
        name_m = re.search(r'name="([^"]*)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        if name_m:
            parts[name_m.group(1)] = (
                file_m.group(1) if file_m else "", data
            )
    return parts


class AppState:
    """Shared service state: settings, predictor, job store, worker."""

    def __init__(
        self,
        settings: Optional[Settings] = None,
        predictor=None,
        store: Optional[JobStore] = None,
    ):
        self.settings = settings or get_settings()
        self.predictor = predictor
        self.store = store
        self.worker: Optional[JobWorker] = None
        self.warmup: Optional[threading.Thread] = None

    def startup(self, load_model: bool = True) -> None:
        """Settings -> predictor load -> DB init -> embedded worker start. A
        missing model file leaves ``predictor=None`` (the API answers 503)
        instead of failing; a missing CUDA device raises."""
        if self.store is None:
            self.store = JobStore(self.settings.sqlite_db_path)
        if load_model and self.predictor is None:
            from lipsync_tpu_torch.inference.predictor import Predictor

            try:
                self.predictor = Predictor(
                    model_path=self.settings.model_path,
                    config=self.settings.to_predictor_config(),
                    device=self.settings.device,
                )
            except FileNotFoundError:
                logger.warning(
                    "Model weights not found at %s — service starts without "
                    "a model (503 on predict)", self.settings.model_path,
                )
        if self.predictor is not None and hasattr(self.predictor, "engine"):
            if (
                self.settings.coalesce_requests
                and self.predictor.engine is not None
                and hasattr(self.predictor.engine, "score_logits")
            ):
                # Cross-request dynamic batching: concurrent requests'
                # windows merge into shared forwards (inference/batcher.py).
                from lipsync_tpu_torch.inference.batcher import (
                    CoalescingEngine,
                )

                self.predictor.engine = CoalescingEngine(
                    self.predictor.engine,
                    max_wait_ms=self.settings.coalesce_max_wait_ms,
                )
            # Run the canonical window shapes once before traffic arrives.
            self.warmup = threading.Thread(
                target=self.predictor.engine.warmup, daemon=True
            )
            self.warmup.start()
        if self.settings.run_embedded_worker and self.predictor is not None:
            self.worker = JobWorker(
                self.predictor, self.store,
                poll_interval_sec=self.settings.worker_poll_interval_sec,
                processing_timeout_sec=self.settings.worker_processing_timeout_sec,
            )
            self.worker.start()

    def shutdown(self) -> None:
        if self.worker:
            self.worker.stop()
        if self.warmup:
            self.warmup.join()
        if self.store:
            self.store.close()
        if self.predictor:
            self.predictor.close()


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("%s " + fmt, self.client_address[0], *args)

        # ── helpers ──────────────────────────────────────────────────────
        def _json(self, code: int, payload: Any) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, detail: str) -> None:
            self._json(code, {"detail": detail})

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _upload(self) -> Optional[bytes]:
            ctype = self.headers.get("Content-Type", "")
            if not ctype.startswith("multipart/form-data"):
                self._error(400, "expected multipart/form-data")
                return None
            parts = parse_multipart(self._read_body(), ctype)
            part = parts.get("video_file") or next(iter(parts.values()), None)
            if part is None or not part[1]:
                self._error(400, "missing video_file upload")
                return None
            return part[1]

        # ── routes ───────────────────────────────────────────────────────
        def do_GET(self) -> None:
            url = urlparse(self.path)
            if url.path == "/":
                self._json(200, {
                    "service": state.settings.project_name,
                    "docs": None,
                    "endpoints": [
                        "/api/lip-sync", "/jobs", "/result/{job_id}",
                        "/api/metrics/evaluate", "/healthz",
                    ],
                })
            elif url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model_loaded": state.predictor is not None,
                })
            elif url.path.startswith("/result/"):
                self._get_result(url)
            else:
                self._error(404, "Not found")

        def do_POST(self) -> None:
            url = urlparse(self.path)
            if url.path == "/api/lip-sync":
                self._post_lip_sync()
            elif url.path == "/jobs":
                self._post_job()
            elif url.path == "/api/metrics/evaluate":
                self._post_evaluate()
            else:
                self._error(404, "Not found")

        def _post_lip_sync(self) -> None:
            if state.predictor is None:
                self._error(
                    503,
                    f"Model not loaded. Place trained weights at "
                    f"{state.settings.model_path} and restart the service.",
                )
                return
            data = self._upload()
            if data is None:
                return
            tmp = save_bytes_to_temp(data, suffix=".mp4")
            try:
                result = state.predictor.predict(tmp)
                response = LipSyncResponse.from_result(result)
                self._json(200, response.to_dict())
            except ValueError as e:
                self._error(400, str(e))
            except Exception:
                logger.exception("Lip-sync request failed with server error")
                self._error(500, "Lip-sync inference failed")
            finally:
                try:
                    tmp.unlink(missing_ok=True)
                except OSError:
                    pass

        def _post_job(self) -> None:
            if state.store is None:
                self._error(503, "Database not ready")
                return
            if state.predictor is None:
                self._error(503, "Model not loaded")
                return
            data = self._upload()
            if data is None:
                return
            input_path = save_bytes_to_temp(data, suffix=".mp4")
            job = state.store.create_job(
                input_path, payload={"filename": "upload.mp4"}
            )
            resp = PredictJobCreateResponse(
                job_id=job.job_id, status=job.status,
                created_at=job.created_at,
            )
            self._json(200, resp.to_dict())

        def _get_result(self, url) -> None:
            if state.store is None:
                self._error(503, "Database not ready")
                return
            job_id = url.path[len("/result/"):]
            include_debug = (
                parse_qs(url.query).get("include_debug", ["false"])[0].lower()
                == "true"
            )
            job = state.store.get_job(job_id)
            if job is None:
                self._error(404, "Job not found")
                return
            if job.status != "COMPLETED":
                if job.status == "FAILED":
                    resp = JobResultResponse(
                        job_id=job.job_id, status=job.status, error=job.error
                    )
                    self._json(200, resp.to_dict())
                    return
                self._error(
                    202, f"Job not completed yet. Current status={job.status}"
                )
                return
            parsed = json.loads(job.result) if job.result else None
            if parsed is not None and not include_debug:
                parsed = {
                    k: v for k, v in parsed.items() if k in MINIMAL_RESULT_KEYS
                }
            resp = JobResultResponse(
                job_id=job.job_id, status=job.status, result=parsed,
                error=job.error,
            )
            self._json(200, resp.to_dict())

        def _post_evaluate(self) -> None:
            try:
                payload = json.loads(self._read_body())
                evals = payload["evaluations"]
                metrics = compute_metrics(
                    [e["predicted_is_fake"] for e in evals],
                    [e["true_is_fake"] for e in evals],
                )
            except (KeyError, ValueError, TypeError) as e:
                self._error(400, f"invalid request: {e}")
                return
            resp = BatchEvaluateResponse.parse(metrics)
            self._json(200, resp.to_dict())

    return Handler


class Server:
    """Threaded HTTP server wrapper with lifecycle management."""

    def __init__(self, state: Optional[AppState] = None, load_model: bool = True):
        self.state = state or AppState()
        self.state.startup(load_model=load_model)
        self.httpd = ThreadingHTTPServer(
            (self.state.settings.host, self.state.settings.port),
            make_handler(self.state),
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        logger.info("Serving on %s:%d", *self.httpd.server_address[:2])

    def serve_forever(self) -> None:
        logger.info("Serving on %s:%d", *self.httpd.server_address[:2])
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.state.shutdown()


def main() -> None:
    Server().serve_forever()


if __name__ == "__main__":
    main()
