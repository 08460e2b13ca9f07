"""The port's serving layer (``lipsync_tpu_torch/serving``) against the JAX
package's, on the CPU, through real sockets with stdlib ``urllib``.

- Every test of ``tests/test_serving.py``, mirrored against the port's
  ``Server`` with a fake predictor.
- ``Settings`` and ``to_predictor_config`` field by field against the JAX
  package's (only ``device`` differs: "cuda" for "tpu").
- The two apps serving the same fake result: identical JSON bodies on every
  route (the job's ``created_at`` string included) and the same 400 on a
  bad verdict.
- End to end: the port's ``Server`` over the port's ``Predictor`` and the
  JAX ``Server`` over the JAX ``Predictor``, on the same video file and the
  same bridged weights: probabilities within 1e-5, other floats 1e-4,
  everything else equal; 4 concurrent requests give the sequential body.
"""

import dataclasses
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.predictor import Predictor as JPredictor
from lipsync_tpu.inference.predictor import PredictorConfig as JConfig
from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu.serving import app as japp
from lipsync_tpu.serving import config as jconfig
from lipsync_tpu.serving import jobs as jjobs
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.predictor import Predictor, PredictorConfig
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from lipsync_tpu_torch.serving import app as papp
from lipsync_tpu_torch.serving import config as pconfig
from lipsync_tpu_torch.serving import jobs as pjobs
from lipsync_tpu_torch.serving.app import AppState, Server, parse_multipart
from lipsync_tpu_torch.serving.config import Settings
from lipsync_tpu_torch.serving.jobs import PENDING, PROCESSING, JobStore
from lipsync_tpu_torch.serving.worker import JobWorker
from tests.fixtures import synthetic_frames, write_av_video
from tests.torch_parity import assert_same, seeded_pair

torch.set_num_threads(1)

BOX = (60, 70, 110, 105)


class FakePredictor:
    def __init__(self, result=None, fail=False):
        self.result = result or {
            "verdict": "real", "is_real": True, "is_fake": False,
            "confidence": 0.9, "manipulation_probability": 0.1,
            "detail": "ok", "selection_margin": 1.0, "tracks": None,
        }
        self.fail = fail
        self.calls = 0

    def predict(self, path):
        self.calls += 1
        if self.fail:
            raise ValueError("bad input video")
        return dict(self.result)

    def close(self):
        pass


class Client:
    """``httpx.Client``'s few calls the tests use, on stdlib ``urllib``."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def _send(self, req):
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        return self._send(urllib.request.Request(self.base + path))

    def post_json(self, path, payload):
        return self._send(urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}))

    def post_file(self, path, data=b"\x00\x01fakebytes",
                  filename="clip.mp4"):
        boundary = "PortTestBoundary"
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="video_file"; filename="{filename}"\r\n'
            "Content-Type: video/mp4\r\n\r\n"
        ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
        return self._send(urllib.request.Request(
            self.base + path, data=body,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"}))


def _settings(tmp_path, **kw):
    return Settings(port=0, sqlite_db_path=str(tmp_path / "jobs.db"),
                    run_embedded_worker=False, device="cpu", **kw)


@pytest.fixture()
def server(tmp_path):
    srv = Server(AppState(settings=_settings(tmp_path),
                          predictor=FakePredictor()), load_model=False)
    srv.start_background()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    return Client(server.port)


# ── tests/test_serving.py, against the port ──────────────────────────────


def test_root_and_health(client):
    code, body = client.get("/")
    assert code == 200
    assert "/api/lip-sync" in body["endpoints"]
    assert client.get("/healthz")[1]["model_loaded"] is True


def test_lip_sync_endpoint(client, server):
    code, body = client.post_file("/api/lip-sync")
    assert code == 200
    assert body["verdict"] == "real"
    assert body["confidence"] == 0.9
    assert server.state.predictor.calls == 1


def test_lip_sync_400_on_value_error(tmp_path):
    srv = Server(AppState(settings=_settings(tmp_path),
                          predictor=FakePredictor(fail=True)),
                 load_model=False)
    srv.start_background()
    try:
        code, body = Client(srv.port).post_file("/api/lip-sync")
        assert code == 400
        assert "bad input video" in body["detail"]
    finally:
        srv.stop()


def test_lip_sync_503_without_model(tmp_path):
    settings = _settings(tmp_path, model_path=tmp_path / "missing.pth")
    srv = Server(AppState(settings=settings), load_model=True)
    srv.start_background()
    try:
        code, body = Client(srv.port).post_file("/api/lip-sync")
        assert code == 503
        assert "Model not loaded" in body["detail"]
    finally:
        srv.stop()


def test_job_flow_end_to_end(client, server):
    code, body = client.post_file("/jobs")
    assert code == 200
    job_id = body["job_id"]
    assert body["status"] == PENDING
    assert client.get(f"/result/{job_id}")[0] == 202
    worker = JobWorker(server.state.predictor, server.state.store)
    assert worker.run_once() is True
    code, body = client.get(f"/result/{job_id}")
    assert code == 200
    assert body["status"] == "COMPLETED"
    assert set(body["result"]) <= papp.MINIMAL_RESULT_KEYS
    body = client.get(f"/result/{job_id}?include_debug=true")[1]
    assert "selection_margin" in body["result"]


def test_job_result_404(client):
    assert client.get("/result/nonexistent")[0] == 404


def test_job_failure_is_persisted(server, client):
    job_id = client.post_file("/jobs")[1]["job_id"]
    JobWorker(FakePredictor(fail=True), server.state.store).run_once()
    body = client.get(f"/result/{job_id}")[1]
    assert body["status"] == "FAILED"
    assert "bad input video" in body["error"]


def test_metrics_evaluate_endpoint(client):
    evals = [
        {"predicted_is_fake": True, "true_is_fake": True},
        {"predicted_is_fake": True, "true_is_fake": False},
        {"predicted_is_fake": False, "true_is_fake": False},
        {"predicted_is_fake": False, "true_is_fake": True},
    ]
    code, m = client.post_json("/api/metrics/evaluate",
                               {"evaluations": evals})
    assert code == 200
    assert m["tp"] == 1 and m["fp"] == 1 and m["tn"] == 1 and m["fn"] == 1
    assert m["precision"] == 0.5 and m["recall"] == 0.5


def test_stale_processing_reclaim(tmp_path):
    store = JobStore(str(tmp_path / "jobs.db"))
    job = store.create_job(tmp_path / "x.mp4")
    assert store.get_next_claimable_job().status == PROCESSING
    assert store.get_next_claimable_job(processing_timeout_sec=900) is None
    time.sleep(0.01)
    reclaimed = store.get_next_claimable_job(processing_timeout_sec=0)
    assert reclaimed is not None and reclaimed.job_id == job.job_id
    assert store._conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"


def test_multipart_parser_roundtrip():
    boundary = "XBOUNDARY"
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="video_file"; '
        'filename="a.mp4"\r\n'
        "Content-Type: video/mp4\r\n\r\n"
    ).encode() + b"\x00\x01\x02binary\r\ndata" + (
        f"\r\n--{boundary}--\r\n"
    ).encode()
    ctype = f"multipart/form-data; boundary={boundary}"
    parts = parse_multipart(body, ctype)
    assert parts == japp.parse_multipart(body, ctype)
    assert parts["video_file"] == ("a.mp4", b"\x00\x01\x02binary\r\ndata")


def test_default_checkpoint_discovery(tmp_path, monkeypatch):
    from lipsync_tpu_torch.utils import weights as w

    monkeypatch.delenv("MODEL_PATH", raising=False)
    monkeypatch.setattr(w, "FLAGSHIP_DIR", tmp_path / "flagship")
    assert w.default_checkpoint() is None
    assert w.default_calibration() is None
    (tmp_path / "flagship").mkdir()
    assert w.default_checkpoint() == tmp_path / "flagship"
    override = tmp_path / "override.pth"
    override.write_bytes(b"x")
    monkeypatch.setenv("MODEL_PATH", str(override))
    assert w.default_checkpoint() == override
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "nope.pth"))
    assert w.default_checkpoint() == tmp_path / "flagship"


@pytest.mark.parametrize("sidecar", [
    {"calibration_platt_a": 0.8, "calibration_platt_b": 0.1},
    {"other": 1},
    None,  # unreadable
])
def test_get_settings_flagship_fallback(tmp_path, monkeypatch, sidecar):
    """The port's ``get_settings`` against the JAX package's, on the same
    environment: the flagship, its Platt sidecar, MODEL_PATH and
    SQLITE_DB_URL with and without ``sqlite:///``."""
    from lipsync_tpu.utils import weights as jw
    from lipsync_tpu_torch.utils import weights as pw

    monkeypatch.delenv("MODEL_PATH", raising=False)
    monkeypatch.delenv("SQLITE_DB_URL", raising=False)
    flagship = tmp_path / "flagship"
    flagship.mkdir()
    flagship.with_suffix(".json").write_text(
        "{not json" if sidecar is None else json.dumps(sidecar))
    for mod in (jw, pw):
        monkeypatch.setattr(mod, "FLAGSHIP_DIR", flagship)
    monkeypatch.chdir(tmp_path)

    def both():
        p, j = pconfig.get_settings(), jconfig.get_settings()
        got = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
        assert got.pop("device") == "cuda"
        assert got.pop("architecture") == "lip_sync"  # the port's own
        assert got == {k: v for k, v in j.model_dump().items()
                       if k != "device"}
        return p

    s = both()
    assert s.model_path == flagship
    assert (s.calibration_method == "platt") == ("calibration_platt_a"
                                                 in (sidecar or {}))
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "other.pth"))
    for url in ("sqlite:///" + str(tmp_path / "a.db"), str(tmp_path / "b.db")):
        monkeypatch.setenv("SQLITE_DB_URL", url)
        s = both()
        assert s.model_path == tmp_path / "other.pth"
        assert s.calibration_method == "none"
        assert s.sqlite_db_path.endswith(".db")


# ── Settings and the contract against the JAX package ───────────────────


def test_settings_fields_and_defaults_match_jax():
    """Every JAX field, in order and with its default; the port's own
    ``architecture`` (the detector, LipSyncModel by default) besides."""
    port = [(f.name, f.default) for f in dataclasses.fields(Settings)]
    assert port.pop([n for n, _ in port].index("architecture")) == (
        "architecture", "lip_sync")
    jax_fields = [(k, v.default)
                  for k, v in jconfig.Settings.model_fields.items()]
    assert [n for n, _ in port] == [n for n, _ in jax_fields]
    assert dict(port).pop("device") == "cuda"
    assert ({n: d for n, d in port if n != "device"}
            == {n: d for n, d in jax_fields if n != "device"})


@pytest.mark.parametrize("knobs", [
    {},
    {"confidence_threshold": 0.4, "max_tracks": 3, "chunk_stride": 4,
     "calibration_method": "platt", "calibration_platt_a": 0.7,
     "shared_visual_encoding": True, "quantized_int8": True,
     "fold_hf_stem": True, "detection_stride": 2, "fake_vote_gate": 0.3,
     "speaking_score_mode": "articulation", "max_total_frames": 64},
])
def test_to_predictor_config_matches_jax(knobs):
    got = vars(Settings(**knobs).to_predictor_config())
    want = vars(jconfig.Settings(**knobs).to_predictor_config())
    assert got.pop("architecture") == "lip_sync"  # the port's own
    assert got == want


def test_settings_coerce_and_reject_as_jax_does():
    knobs = dict(port=8080.0, model_path="w.pth", use_bfloat16=0,
                 trim_ratio=np.float32(0.25), max_tracks=np.int64(3))
    s, j = Settings(**knobs), jconfig.Settings(**knobs)
    assert ({k: getattr(s, k) for k in knobs}
            == {k: getattr(j, k) for k in knobs})
    assert [type(getattr(s, k)) for k in knobs] == [type(getattr(j, k))
                                                    for k in knobs]
    for bad in ({"port": "x"}, {"max_tracks": 2.5}, {"project_name": 3},
                {"use_bfloat16": 2}):
        with pytest.raises(ValueError):
            Settings(**bad)
        with pytest.raises(ValueError):
            jconfig.Settings(**bad)


def test_data_parallel_devices_still_raises(tmp_path):
    """``Settings.data_parallel_devices`` raised until data parallelism was
    ported; it now reaches the engine as a two-shard mesh, as the JAX
    package's reaches ``make_mesh(2)``."""
    path = tmp_path / "w.pth"
    model, cfg, _, _ = seeded_pair(5)
    torch.save(model.state_dict(), path)
    settings = Settings(data_parallel_devices=2, model_path=path)
    assert (settings.to_predictor_config().data_parallel_devices
            == jconfig.Settings(data_parallel_devices=2)
            .to_predictor_config().data_parallel_devices == 2)
    p = Predictor(model_path=path, config=settings.to_predictor_config(),
                  model_config=cfg, device="cpu")
    assert p.engine.mesh == [torch.device("cpu")] * 2


RICH_RESULT = {
    "verdict": "uncertain", "is_real": True, "is_fake": 0, "confidence": 1,
    "manipulation_probability": 0.0,
    "tracks": [{
        "track_id": 2.0, "is_real": True, "is_fake": False,
        "confidence": 0.75, "manipulation_probability": 0.25,
        "raw_confidence": 0.7, "stability": 1, "hits": 30,
        "total_frames": 30, "speaking_activity": 0.5,
        "selection_score": 0.6, "window_confidences": [0.7, 0.8, 1],
        "window_spans": [(0, 8), (4, 12)], "track_start_frame": 0,
        "consecutive_miss_max": 0, "bbox": [1, 2.5, 30, 40.25],
    }],
    "selected_track_id": 2, "selection_uncertain": False,
    "selection_margin": 1.0, "speaker_case": "single_speaker",
    "verdicts": {"active_speaker_policy_is_fake": False},
    "window_results": [{
        "window_index": 0, "frame_start": 0, "frame_end": 8,
        "time_start_sec": 0.0, "time_end_sec": 0.533,
        "selected_track_id": 2, "confidence": 0.7, "is_real": True,
        "is_fake": False, "speaking_activity": 0.4, "vad_coverage": 1.0,
    }],
    "speaker_timeline": [{"selected_track_id": 2, "frame_start": 0,
                          "frame_end": 12, "time_start_sec": 0.0,
                          "time_end_sec": 0.8}],
    "mouth_motion_check": {"check_result": "ok", "audio_energy": -20,
                           "mouth_motion_energy": 0.02, "windows": 3},
    "temporal_drift": float("nan"), "segment_verdicts": None,
    "track_policy_verdicts": {"x": True}, "detail": "Long video (2.0s).",
}


def _serve_both(tmp_path, result):
    """The port's and the JAX package's server, each over a fake predictor
    with ``result``, with the job store's clock and ids fixed."""
    servers = []
    for mod, settings in ((papp, _settings(tmp_path / "p")),
                          (japp, jconfig.Settings(
                              port=0, run_embedded_worker=False,
                              sqlite_db_path=str(tmp_path / "j.db")))):
        (tmp_path / "p").mkdir(exist_ok=True)
        srv = mod.Server(mod.AppState(settings=settings,
                                      predictor=FakePredictor(result)),
                         load_model=False)
        srv.start_background()
        servers.append(srv)
    return servers


def test_json_bodies_equal_jax_on_every_route(tmp_path, monkeypatch):
    stamp = "2026-01-02T03:04:05.678901+00:00"
    for mod in (pjobs, jjobs):
        monkeypatch.setattr(mod, "_utc_now", lambda: stamp)
        monkeypatch.setattr(mod, "uuid4", lambda: "fixed-job-id")
    servers = _serve_both(tmp_path, RICH_RESULT)
    try:
        clients = [Client(s.port) for s in servers]
        evals = {"evaluations": [
            {"predicted_is_fake": True, "true_is_fake": True},
            {"predicted_is_fake": False, "true_is_fake": True}]}
        calls = [
            lambda c: c.get("/"), lambda c: c.get("/healthz"),
            lambda c: c.get("/nope"),
            lambda c: c.post_file("/api/lip-sync"),
            lambda c: c.post_file("/jobs"),
            lambda c: c.get("/result/fixed-job-id"),
            lambda c: c.get("/result/missing"),
            lambda c: c.post_json("/api/metrics/evaluate", evals),
            lambda c: c.post_json("/api/metrics/evaluate", {"x": 1}),
            lambda c: c.post_json("/nope", {}),
        ]
        bodies = []
        for i, call in enumerate(calls):
            got, want = call(clients[0]), call(clients[1])
            assert got == want, (i, got, want)
            bodies.append(got)
        assert bodies[4][1]["created_at"] == "2026-01-02T03:04:05.678901Z"
        assert bodies[5][0] == 202
        for srv in servers:
            JobWorker(srv.state.predictor, srv.state.store).run_once()
        for query in ("", "?include_debug=true"):
            got = clients[0].get("/result/fixed-job-id" + query)
            assert got == clients[1].get("/result/fixed-job-id" + query)
            assert got[0] == 200
        assert got[1]["result"]["tracks"][0]["window_spans"] == [[0, 8],
                                                                 [4, 12]]
        body = clients[0].post_file("/api/lip-sync")[1]
        assert "window_spans" not in body["tracks"][0]
        assert body["temporal_drift"] is None and body["confidence"] == 1.0
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("bad", [
    {"verdict": "maybe"}, {"confidence": "high"}, {"is_real": None},
    {"tracks": [{"track_id": 1.5}]},
])
def test_invalid_result_is_a_400_in_both(tmp_path, bad):
    servers = _serve_both(tmp_path, {**RICH_RESULT, **bad})
    try:
        got, want = (Client(s.port).post_file("/api/lip-sync")
                     for s in servers)
        assert got[0] == want[0] == 400
    finally:
        for srv in servers:
            srv.stop()


# ── End to end over both packages' predictors ───────────────────────────


class _JaxPredictor:
    """The JAX predictor as its tests call it: highest matmul precision, in
    the handler's thread (cv2 visible, as for the port)."""

    def __init__(self, predictor):
        self.predictor = predictor

    def predict(self, path):
        with jax.default_matmul_precision("highest"):
            return self.predictor.predict(path)

    def close(self):
        pass


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    _, cfg, variables, jcfg = seeded_pair(5, crop_size=48)
    knobs = {"chunk_size": 8, "chunk_stride": 4}
    port = Predictor(config=PredictorConfig(**knobs), model_config=cfg,
                     engine=ScoringEngine(variables, cfg, device="cpu",
                                          use_bfloat16=False),
                     detector_backend=FakeDetector(lambda i: [BOX]),
                     device="cpu")
    ref = JPredictor(config=JConfig(**knobs), model_config=jcfg,
                     engine=JEngine(variables, jcfg, use_bfloat16=False),
                     detector_backend=JFake(lambda i: [BOX]))
    clips = {
        "short": write_av_video(d / "short.avi", synthetic_frames(n=8)),
        "long": write_av_video(d / "long.avi", synthetic_frames(n=20)),
    }
    psrv = Server(AppState(settings=_settings(d), predictor=port),
                  load_model=False)
    jsrv = japp.Server(japp.AppState(
        settings=jconfig.Settings(port=0, run_embedded_worker=False,
                                  sqlite_db_path=str(d / "j.db")),
        predictor=_JaxPredictor(ref)), load_model=False)
    for s in (psrv, jsrv):
        s.start_background()
    yield Client(psrv.port), Client(jsrv.port), psrv, clips
    for s in (psrv, jsrv):
        s.stop()


@pytest.mark.parametrize("clip", ["short", "long"])
def test_lip_sync_matches_jax_end_to_end(e2e, clip):
    port, ref, _, clips = e2e
    data = clips[clip].read_bytes()
    got, want = port.post_file("/api/lip-sync", data), ref.post_file(
        "/api/lip-sync", data)
    assert got[0] == want[0] == 200, (got, want)
    assert got[1]["tracks"] and got[1]["verdict"] in ("real", "fake",
                                                       "uncertain")
    assert_same(got[1], want[1])


def test_concurrent_requests_give_the_sequential_body(e2e):
    port, _, psrv, clips = e2e
    data = clips["short"].read_bytes()
    sequential = port.post_file("/api/lip-sync", data)
    engine = psrv.state.predictor.engine
    before = engine.batches_dispatched
    barrier = threading.Barrier(4)

    def one(_):
        barrier.wait()
        return port.post_file("/api/lip-sync", data)

    with ThreadPoolExecutor(4) as pool:
        bodies = list(pool.map(one, range(4)))
    for code, body in bodies:
        assert code == 200
        assert_same(body, sequential[1], tol=1e-6)
    assert engine.batches_dispatched - before >= 1
