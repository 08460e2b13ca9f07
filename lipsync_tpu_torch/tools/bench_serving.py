"""Serving throughput benchmark.

    python -m lipsync_tpu_torch.tools.bench_serving --requests 50 \
        --concurrency 4 [--model-path FILE | --stub-model] [--device cuda:0]
    python -m lipsync_tpu_torch.tools.bench_serving --engine-only \
        --model-path FILE [--coalesce on|off] [--windows-per-request 6]

The port's counterpart of the JAX package's script ``bench_serving``, with
its flags and report keys. It replays a set of synthetic clips (written
with ``preprocessing/mux.py``) against the live HTTP service
(``serving/app.py::Server``) at a fixed concurrency and reports QPS and
latency percentiles. ``--stub-model`` measures the serving stack alone;
``--model-path`` runs the full pipeline on ``--device`` (cuda:0 unless
asked): ingest, detection, crops, the log-mel (K1), the model (K2). The
clients post multipart uploads over stdlib ``urllib``. ``--engine-only``
skips HTTP and decode: concurrent ``score_probs`` of pre-decoded windows,
with or without the ``CoalescingEngine`` (:func:`engine_only_bench`, which
``bench_coalesce_r5`` drives over one loaded engine).

``main(..., detector_backend=)`` gives the served predictor a face detector
in place of the default ladder.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import add_device_argument


def make_clips(n_clips: int, seconds: float, out_dir: Path):
    from lipsync_tpu_torch.preprocessing import mux
    from lipsync_tpu_torch.utils.synthetic import (
        speechish_pcm,
        synthetic_frames,
    )

    clips = []
    for i in range(n_clips):
        frames = synthetic_frames(int(seconds * 15), seed=i)
        pcm = speechish_pcm(seconds, seed=i)
        clips.append(
            mux.write_video(out_dir / f"clip_{i}.avi", frames, 15.0, pcm,
                            16000)
        )
    return clips


class _StubPredictor:
    def predict(self, path):
        return {
            "verdict": "real", "is_real": True, "is_fake": False,
            "confidence": 0.9, "manipulation_probability": 0.1,
        }

    def close(self):
        pass


def post_clip(base: str, body: bytes, timeout: float = 300.0) -> int:
    """POST ``body`` as the ``video_file`` upload of ``/api/lip-sync``;
    the response's status code."""
    import urllib.error
    import urllib.request

    boundary = "bench-serving-boundary"
    data = (f"--{boundary}\r\nContent-Disposition: form-data; "
            'name="video_file"; filename="c.avi"\r\n'
            "Content-Type: video/avi\r\n\r\n").encode() + body + (
        f"\r\n--{boundary}--\r\n").encode()
    req = urllib.request.Request(
        base + "/api/lip-sync", data=data,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def engine_only_bench(args, engine=None):
    """Concurrent scoring with PRE-DECODED inputs: isolates cross-request
    batching from host decode. Each simulated request scores
    ``--windows-per-request`` model windows (a short 2-track clip with
    refinement scores ~4-10); ``--coalesce on`` merges concurrent requests
    into shared forwards.

    ``engine`` lets a caller (``bench_coalesce_r5``) reuse ONE loaded
    engine across a whole A/B matrix; else ``args.model_path`` is loaded on
    ``args.device`` (cuda:0 when ``args`` has none)."""
    from lipsync_tpu_torch.inference.batcher import CoalescingEngine
    from lipsync_tpu_torch.inference.engine import load_engine

    shared = engine is not None
    if not shared:
        engine = load_engine(args.model_path,
                             device=getattr(args, "device", None))
    coalesce = args.coalesce == "on"
    if coalesce:
        engine = CoalescingEngine(
            engine, max_wait_ms=args.coalesce_wait_ms
        )
    w = args.windows_per_request
    rng = np.random.RandomState(0)
    visual = rng.randint(
        0, 256,
        size=(w, engine.config.video_frames, engine.config.crop_size,
              engine.config.crop_size, 3),
    ).astype(np.uint8)
    audio = rng.randn(
        w, engine.config.mel_bins, engine.config.audio_frames
    ).astype(np.float32) * 20.0 - 40.0

    # Warm EVERY bucket shape this run can reach: a request is w windows,
    # so coalesced batches land on the power-of-two buckets up to
    # concurrency*w; a fresh bucket's first forward (cuDNN plans,
    # allocations) is deployment warmup, not steady-state QPS.
    max_total = min(256, args.concurrency * w)
    base = engine._engine if coalesce else engine
    nb = 1
    while nb < max_total * 2 and nb <= 256:
        if nb * 2 >= w:  # buckets a w-window request can land on
            reps = (nb + w - 1) // w
            vb = np.repeat(visual, reps, axis=0)[:nb]
            ab = np.repeat(audio, reps, axis=0)[:nb]
            base.score_probs(vb, ab)
        nb *= 2

    lock = threading.Lock()
    counter = iter(range(args.requests))
    latencies = []

    def worker():
        while True:
            with lock:
                try:
                    next(counter)
                except StopIteration:
                    return
            t0 = time.perf_counter()
            engine.score_probs(visual, audio)
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)

    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=worker) for _ in range(args.concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start

    lat = np.asarray(sorted(latencies))
    out = {
        "metric": "engine_concurrent_qps",
        "value": len(lat) / wall,
        "unit": "requests/sec",
        "windows_per_sec": len(lat) * w / wall,
        "requests": len(lat),
        "concurrency": args.concurrency,
        "windows_per_request": w,
        "coalesce": coalesce,
        "coalesce_wait_ms": args.coalesce_wait_ms if coalesce else None,
        "batches_dispatched": getattr(engine, "batches_dispatched", None),
        "items_coalesced": getattr(engine, "items_coalesced", None),
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p95_ms": float(np.percentile(lat, 95)) * 1e3,
    }
    if coalesce:
        engine.close()
    print(json.dumps(out))
    return out


def main(argv: Optional[List[str]] = None, detector_backend=None):
    from lipsync_tpu_torch.serving.app import AppState, Server
    from lipsync_tpu_torch.serving.config import Settings

    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--clip-seconds", type=float, default=3.0)
    p.add_argument("--n-clips", type=int, default=8)
    p.add_argument("--model-path", type=Path, default=None)
    p.add_argument("--stub-model", action="store_true")
    p.add_argument("--detection-stride", type=int, default=1,
                   help="host detector stride (Settings.detection_stride)")
    p.add_argument("--coalesce", choices=["on", "off"], default="on",
                   help="cross-request dynamic batching "
                        "(Settings.coalesce_requests)")
    p.add_argument("--coalesce-wait-ms", type=float, default=2.0)
    p.add_argument("--engine-only", action="store_true",
                   help="skip HTTP/decode: concurrent scoring of "
                        "pre-decoded windows (isolates batching from the "
                        "host)")
    p.add_argument("--windows-per-request", type=int, default=6)
    add_device_argument(p)
    args = p.parse_args(argv)

    if args.engine_only:
        if args.model_path is None:
            raise SystemExit("--engine-only requires --model-path")
        return engine_only_bench(args)

    tmp = Path(tempfile.mkdtemp())
    clips = make_clips(args.n_clips, args.clip_seconds, tmp)
    payloads = [c.read_bytes() for c in clips]

    settings = Settings(
        port=0, run_embedded_worker=False,
        sqlite_db_path=str(tmp / "jobs.db"),
        model_path=args.model_path or Path("/nonexistent"),
        device=args.device,
        detection_stride=args.detection_stride,
        coalesce_requests=args.coalesce == "on",
        coalesce_max_wait_ms=args.coalesce_wait_ms,
    )
    predictor = None
    if args.stub_model:
        predictor = _StubPredictor()
    elif detector_backend is not None and args.model_path is not None:
        from lipsync_tpu_torch.inference.predictor import Predictor

        predictor = Predictor(
            model_path=args.model_path,
            config=settings.to_predictor_config(),
            detector_backend=detector_backend, device=args.device)
    state = AppState(settings=settings, predictor=predictor)
    server = Server(state, load_model=not args.stub_model)
    if server.state.predictor is None:
        raise SystemExit("No model available; pass --model-path or --stub-model")
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"

    latencies = []
    errors = [0]
    lock = threading.Lock()
    counter = iter(range(args.requests))

    def worker():
        while True:
            with lock:
                try:
                    i = next(counter)
                except StopIteration:
                    return
            body = payloads[i % len(payloads)]
            t0 = time.perf_counter()
            status = post_clip(base, body)
            dt = time.perf_counter() - t0
            with lock:
                if status == 200:
                    latencies.append(dt)
                else:
                    errors[0] += 1

    try:
        # Warm one request (the model's first forwards, kernel builds).
        post_clip(base, payloads[0], timeout=600.0)

        t_start = time.perf_counter()
        threads = [
            threading.Thread(target=worker) for _ in range(args.concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
    finally:
        server.stop()

    lat = np.asarray(sorted(latencies))
    out = {
        "metric": "serving_qps",
        "value": len(lat) / wall,
        "unit": "requests/sec",
        "requests": len(lat),
        "errors": errors[0],
        "concurrency": args.concurrency,
        "clip_seconds": args.clip_seconds,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3 if len(lat) else None,
        "p95_ms": float(np.percentile(lat, 95)) * 1e3 if len(lat) else None,
        "stub_model": bool(args.stub_model),
        "detection_stride": args.detection_stride,
        "coalesce": args.coalesce == "on",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
