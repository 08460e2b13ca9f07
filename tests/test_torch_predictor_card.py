"""``Predictor.predict`` and the HTTP service on a CUDA card, at the
published widths of ``ModelConfig()`` and on BatchNorm-calibrated seeded
weights: clip S (30 frames + 2.0 s: the short path with refinement and the
mouth-motion check) and clip L (150 frames + 10 s: the pipelined long path,
and the batch path) through the bf16 and fp32 engines, each ``predict``
launching K1 and K2, the fp32 runs against the same runs with the kernels'
twins; then the service's routes against the same predictor's ``predict``
and its coalescing of concurrent clients.

A card's host may lack FFmpeg: the clips are held in memory
(``torch_card.MemoryClips`` stands in for ``ingest``'s readers), and the
detector knows each frame's mouth box (``torch_card.ClipBoxes``).

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_*_card.py --noconftest -m card
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_card
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.predictor import Predictor, PredictorConfig
from lipsync_tpu_torch.models import ModelConfig
from lipsync_tpu_torch.serving.app import MINIMAL_RESULT_KEYS, AppState, Server
from lipsync_tpu_torch.serving.config import Settings
from lipsync_tpu_torch.serving.schemas import LipSyncResponse
from torch_card import card, launched, launches, window_probs  # noqa: F401
from torch_card import main_path_inputs  # noqa: F401

# Every K1 and K2 input of this file's runs is one the kernel tests hold.
pytestmark = [pytest.mark.card, pytest.mark.usefixtures("main_path_inputs")]
CONFIGS = {"S": PredictorConfig(refine_margin=1.5), "L": PredictorConfig(),
           "L_batch": PredictorConfig(pipelined_long_video=False)}
RUNS = [("S", "bf16"), ("S", "fp32"), ("L", "bf16"), ("L", "fp32"),
        ("L_batch", "bf16")]


@pytest.fixture(scope="module")
def calibrated(card):
    return torch_card.weight_sets(ModelConfig(), card)["bn_calibrated"]


@pytest.fixture(scope="module")
def engines(card, calibrated):
    yield {"bf16": ScoringEngine(calibrated, ModelConfig(), device=card),
           "fp32": ScoringEngine(calibrated, ModelConfig(),
                                 use_bfloat16=False, device=card)}
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def clips(card):
    clips, memory, boxes, paths = torch_card.clip_set()
    with pytest.MonkeyPatch.context() as m:
        memory.install(m)
        yield clips, memory, boxes, paths


def predictor(engines, clips, run, dtype):
    return Predictor(config=CONFIGS[run], model_config=ModelConfig(),
                     engine=engines[dtype], detector_backend=clips[2],
                     device=engines[dtype].device)


def predict(engines, clips, run, dtype):
    """One ``predict`` of the clip of ``run``: (result, launches)."""
    pred = predictor(engines, clips, run, dtype)
    before = launches()
    result = pred.predict(clips[3][run[0]])
    return result, launched(before)


@pytest.fixture(scope="module")
def predicted(engines, clips):
    """Each clip through each engine, and L once more through the batch
    path."""
    return {(run, dtype): predict(engines, clips, run, dtype)
            for run, dtype in RUNS}


@pytest.mark.parametrize("run", RUNS, ids="_".join)
def test_every_predict_launches_k1_and_k2(predicted, run):
    result, n = predicted[run]
    assert result["verdict"] and result["tracks"]
    assert n["log_mel"] >= 1 and n["hf_stem"] >= 1


@pytest.mark.parametrize("clip", ["S", "L"])
def test_bf16_and_fp32_agree(predicted, clip):
    """The served bf16 engine and the fp32 one: the same verdict and
    selected track, confidence within 4e-3."""
    r16, r32 = predicted[clip, "bf16"][0], predicted[clip, "fp32"][0]
    assert r16["verdict"] == r32["verdict"]
    assert r16["selected_track_id"] == r32["selected_track_id"]
    assert abs(r16["confidence"] - r32["confidence"]) <= 4e-3


def test_pipelined_long_path_equals_the_batch_path(predicted):
    """L through the pipelined long path and through the batch path in
    bf16: the same verdict, window probabilities within 1e-3."""
    pipe, batch = predicted["L", "bf16"][0], predicted["L_batch", "bf16"][0]
    assert pipe["verdict"] == batch["verdict"]
    p_pipe, p_batch = window_probs(pipe), window_probs(batch)
    assert p_pipe.shape == p_batch.shape
    assert np.abs(p_pipe - p_batch).max() <= 1e-3


@pytest.mark.parametrize("clip", ["S", "L"])
def test_fp32_predict_matches_the_twins(engines, clips, predicted,
                                        monkeypatch, clip):
    """The fp32 ``predict`` with every kernel's twin in its place (which
    launches none): the same verdict, confidence and window probabilities
    within 1e-3."""
    with monkeypatch.context() as m:
        torch_card.plain_kernels(m)
        twin, n = predict(engines, clips, clip, "fp32")
    assert not any(n.values())
    r32 = predicted[clip, "fp32"][0]
    assert r32["verdict"] == twin["verdict"]
    assert abs(r32["confidence"] - twin["confidence"]) <= 1e-3
    p32, p_twin = window_probs(r32), window_probs(twin)
    assert p32.shape == p_twin.shape
    assert np.abs(p32 - p_twin).max() <= 1e-3


@pytest.mark.parametrize("clip", ["S", "L"])
def test_predict_over_two_shards_equals_one_device(card, calibrated, engines,
                                                   clips, predicted, tmp_path,
                                                   clip):
    """The bf16 predictor over an engine of two shards on the one card: the
    same verdict and tracks as over one device, confidence within 1e-6;
    ``PredictorConfig(data_parallel_devices=2)`` takes the first two cards,
    fewer if fewer exist."""
    from lipsync_tpu_torch.parallel import mesh as mesh_lib

    mesh = {"bf16": ScoringEngine(calibrated, ModelConfig(),
                                  mesh=[card, card])}
    got, _ = predict(mesh, clips, clip, "bf16")
    want = predicted[clip, "bf16"][0]

    def spans(r):
        return [(t["track_id"], [list(w) for w in t["window_spans"]])
                for t in r["tracks"] or []]

    assert got["verdict"] == want["verdict"]
    assert spans(got) == spans(want)
    assert abs(got["confidence"] - want["confidence"]) <= 1e-6
    torch.save({k: v.detach().cpu() for k, v in calibrated.items()},
               tmp_path / "w.pth")
    pred = Predictor(model_path=tmp_path / "w.pth",
                     config=PredictorConfig(data_parallel_devices=2),
                     model_config=ModelConfig(), device=card)
    assert pred.engine.mesh == mesh_lib.make_mesh(2, device_type=card.type)


def test_predict_from_path_on_a_missing_file_raises(engines, clips):
    with pytest.raises(FileNotFoundError):
        predictor(engines, clips, "S", "bf16").predict_from_path(
            "/no/such/clip.avi")


# ── the HTTP service ─────────────────────────────────────────────────────

class Client:
    """The service's routes over stdlib ``urllib``."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def _send(self, req):
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, route):
        return self._send(urllib.request.Request(self.base + route))

    def post_json(self, route, payload):
        return self._send(urllib.request.Request(
            self.base + route, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}))

    def post_upload(self, route, data: bytes):
        boundary = "card-test-boundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="video_file"; filename="clip.mp4"\r\n'
                "Content-Type: video/mp4\r\n\r\n").encode() + data + (
            f"\r\n--{boundary}--\r\n").encode()
        return self._send(urllib.request.Request(
            self.base + route, data=body, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"}))


def json_diff(a, b, path="$"):
    """(largest difference between two JSON values' floats, the paths
    where anything else differs)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return 0.0, [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        parts = [json_diff(a[k], b[k], f"{path}.{k}") for k in a]
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return 0.0, [f"{path}: lengths {len(a)} != {len(b)}"]
        parts = [json_diff(x, y, f"{path}[{i}]")
                 for i, (x, y) in enumerate(zip(a, b))]
    elif type(a) is float and type(b) is float:
        return abs(a - b), []
    else:
        return 0.0, [] if (type(a), a) == (type(b), b) else [
            f"{path}: {a!r} != {b!r}"]
    return (max((d for d, _ in parts), default=0.0),
            [m for _, ms in parts for m in ms])


@pytest.fixture(scope="module")
def service(card, calibrated, clips, tmp_path_factory):
    """``python -m lipsync_tpu_torch.serving.app``'s server in this
    process: the calibrated weights saved as a ``.pth``, ``Settings``
    pointing at it, the port's ``Predictor`` from
    ``settings.to_predictor_config()``, and ``Server(AppState(...),
    load_model=False)``, whose start-up wraps the engine in
    ``CoalescingEngine``, runs the warmup and starts the embedded worker:
    ``(client, predictor)``."""
    work = tmp_path_factory.mktemp("serving")
    torch.save({k: v.detach().cpu() for k, v in calibrated.items()},
               work / "calibrated.pth")
    settings = Settings(model_path=work / "calibrated.pth", port=0,
                        device=str(card), sqlite_db_path=str(work / "jobs.db"),
                        worker_poll_interval_sec=0.05)
    predictor = Predictor(model_path=settings.model_path,
                          config=settings.to_predictor_config(),
                          model_config=ModelConfig(),
                          detector_backend=clips[2], device=settings.device)
    state = AppState(settings, predictor=predictor)
    server = Server(state, load_model=False)
    server.start_background()
    try:
        state.warmup.join()
        yield Client(server.port), predictor
    finally:
        server.stop()
        torch.cuda.empty_cache()


def test_healthz(service):
    assert service[0].get("/healthz") == (
        200, {"status": "ok", "model_loaded": True})


@pytest.mark.parametrize("clip", ["S", "L"])
def test_lip_sync_answers_as_predict(service, clips, clip):
    """``POST /api/lip-sync`` of the clip launches K1 and K2 and answers
    ``LipSyncResponse.from_result(predict(clip))``, every float within
    1e-6."""
    client, predictor = service
    before = launches()
    code, body = client.post_upload("/api/lip-sync",
                                    clips[1].upload(clip))
    n = launched(before)
    assert code == 200, body
    assert n["log_mel"] >= 1 and n["hf_stem"] >= 1
    want = LipSyncResponse.from_result(
        predictor.predict(clips[3][clip])).to_dict()
    diff, mismatches = json_diff(body, want)
    assert not mismatches and diff <= 1e-6, mismatches[:5]


def test_job_runs_to_completed(service, clips):
    """``POST /jobs`` of L, polled to COMPLETED: the minimal result equal
    to ``/api/lip-sync``'s answer's keys, the debug result to ``predict``'s
    own result (1e-6)."""
    client, predictor = service
    code, job = client.post_upload("/jobs", clips[1].upload("L"))
    assert code == 200, job
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        status, res = client.get(f"/result/{job['job_id']}")
        if status != 202:
            break
        time.sleep(0.05)
    assert res.get("status") == "COMPLETED", res
    direct = predictor.predict(clips[3]["L"])
    body = LipSyncResponse.from_result(direct).to_dict()
    want_min = {k: v for k, v in body.items() if k in MINIMAL_RESULT_KEYS}
    diff, mismatches = json_diff(res["result"], want_min)
    assert not mismatches and diff <= 1e-6, mismatches[:5]
    debug = client.get(f"/result/{job['job_id']}?include_debug=true")[1]
    diff, mismatches = json_diff(debug["result"],
                                 json.loads(json.dumps(direct)))
    assert not mismatches and diff <= 1e-6, mismatches[:5]


def test_metrics_route(service):
    code, m = service[0].post_json("/api/metrics/evaluate", {
        "evaluations": [{"predicted_is_fake": True, "true_is_fake": True},
                        {"predicted_is_fake": False, "true_is_fake": True}]})
    assert code == 200 and (m["tp"], m["fn"], m["total"]) == (1, 1, 2)


def test_concurrent_clients_coalesce(service, clips, monkeypatch):
    """4 clients posting 2 requests of S each at once: all answered 200
    with the same verdict and confidence within 1e-3, in fewer coalesced
    batches than scoring calls (the linger raised to 25 ms so that the
    clients' calls land in one window)."""
    client, predictor = service
    code, want = client.post_upload("/api/lip-sync", clips[1].upload("S"))
    assert code == 200
    eng = predictor.engine
    calls, lock = [0], threading.Lock()
    score_probs = eng.score_probs

    def counted(visual, audio):
        with lock:
            calls[0] += 1
        return score_probs(visual, audio)

    monkeypatch.setattr(eng, "score_probs", counted)
    monkeypatch.setattr(eng, "max_wait_s", 0.025)
    dispatched = eng.batches_dispatched
    barrier = threading.Barrier(4)

    def client_thread(_):
        barrier.wait(timeout=60)
        return [client.post_upload("/api/lip-sync", clips[1].upload("S"))
                for _ in range(2)]

    with ThreadPoolExecutor(4) as pool:
        results = [r for rs in pool.map(client_thread, range(4)) for r in rs]
    assert {c for c, _ in results} == {200}
    assert all(b["verdict"] == want["verdict"] for _, b in results)
    assert max(abs(b["confidence"] - want["confidence"])
               for _, b in results) <= 1e-3
    assert eng.batches_dispatched - dispatched < calls[0]
