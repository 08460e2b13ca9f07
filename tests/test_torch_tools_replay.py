"""The port's replay harnesses against the JAX package's scripts of the
same names, on the CPU: ``eval_shared_encoding`` (synthetic tracks through
both engine paths), ``eval_shared_encoding_flips`` (labelled clips through
``Predictor.predict``, shared encoding off then on) and ``eval_multiface``
(multi-face scenes through real decode, the default Haar ladder, the
tracker and the model or the stub engine). Both packages run on the same
bridged seeded weights (``tests/torch_parity.py::seeded_pair`` at the
parity tests' narrow width) and the same seeded files. Also: a failing K1
or K2 ends each harness's run, and ``--device`` asks for cuda:0.

Tolerances: probabilities and confidences within 1e-4 (the fp32 engine
bound of ``tests/test_torch_engine.py``); verdicts, track attribution and
JSON keys equal.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import eval_multiface as j_mf  # noqa: E402
import eval_shared_encoding as j_shared  # noqa: E402
import eval_shared_encoding_flips as j_flips  # noqa: E402

import lipsync_tpu.inference.engine as j_engine_mod  # noqa: E402
import lipsync_tpu.inference.predictor as j_predictor_mod  # noqa: E402
import lipsync_tpu.models as j_models  # noqa: E402
import lipsync_tpu.preprocessing.ingest as j_ingest  # noqa: E402
from lipsync_tpu.inference.engine import ScoringEngine as JEngine  # noqa: E402
from lipsync_tpu.preprocessing.face_detection import (  # noqa: E402
    FakeDetector as JFake,
)
from lipsync_tpu_torch.inference.engine import ScoringEngine  # noqa: E402
from lipsync_tpu_torch.models import artifact as artifact_mod  # noqa: E402
from lipsync_tpu_torch.preprocessing import audio as audio_mod  # noqa: E402
from lipsync_tpu_torch.preprocessing import ingest  # noqa: E402
from lipsync_tpu_torch.preprocessing.face_detection import (  # noqa: E402
    FakeDetector,
)
from lipsync_tpu_torch.tools import eval_multiface  # noqa: E402
from lipsync_tpu_torch.tools import eval_shared_encoding  # noqa: E402
from lipsync_tpu_torch.tools import eval_shared_encoding_flips  # noqa: E402
from lipsync_tpu_torch.tools import make_synthetic_dataset as gen  # noqa: E402
from tests.torch_parity import seeded_pair  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
BOX = (50, 60, 130, 120)


def jax_call(fn, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def engines():
    _, cfg, variables, jcfg = seeded_pair(
        5, video_frames=8, crop_size=48, audio_frames=32)
    return (ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False),
            JEngine(variables, jcfg, use_bfloat16=False), cfg, jcfg,
            variables)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two multi-face scenes written as the generator writes them: a
    2-face all-fake scene (a dubbed speaker and a listener) and a 3-face
    mixed scene (a synced and a dubbed speaker beside a listener), 2 s
    each."""
    out = tmp_path_factory.mktemp("scenes")
    for scene, faces, seed in (("all_fake", 2, 3), ("mixed", 3, 4)):
        gen.main(["--output-dir", str(out), "--style", "multiface",
                  "--n-per-class", "1", "--seconds", "2.0", "--seed",
                  str(seed), "--scenes", scene, "--n-faces", str(faces)])
    return out


@pytest.fixture(autouse=True)
def one_decode(monkeypatch):
    """Both packages read video through the port's reader. The native RGB
    conversion leaves each frame's last ``w % 8`` columns unwritten (4 of
    the generator's 180 and 340 pixels): the port zeroes its buffer, the
    JAX package's holds whatever the heap held, which can move a detection
    at the frame's right edge between runs."""
    monkeypatch.setattr(j_ingest, "read_video", ingest.read_video)


def _within(got, want, tol=1e-4, path="$"):
    """``got`` and ``want`` have the same keys everywhere; numbers within
    ``tol``, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _within(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _within(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= tol or (np.isnan(got) and np.isnan(want)), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


# ── eval_shared_encoding ─────────────────────────────────────────────────


def test_eval_shared_encoding_matches_the_jax_script(tmp_path, monkeypatch,
                                                     capsys):
    """Both scripts at the narrow geometry on the same seeded weights: the
    per-window probabilities of both paths within 1e-4, and the report's
    keys and deviations."""
    _, cfg, variables, jcfg = seeded_pair(
        0, video_frames=8, crop_size=32, audio_frames=32)
    probs = {"port": [], "jax": []}

    def recorded(engine, key):
        real = engine.score_track_probs

        def score_track_probs(*args):
            out = real(*args)
            probs[key].append(np.asarray(out))
            return out
        engine.score_track_probs = score_track_probs
        return engine

    real_make = eval_shared_encoding.make_engines

    def port_engines(c, seed, device):
        assert seed == 0
        return tuple(recorded(e, "port") for e in real_make(c, seed, device))

    monkeypatch.setattr(eval_shared_encoding, "ModelConfig", lambda: cfg)
    monkeypatch.setattr(eval_shared_encoding, "make_engines", port_engines)
    monkeypatch.setattr(j_models, "ModelConfig", lambda: jcfg)
    # The script's random init is replaced by the bridged weights.
    monkeypatch.setattr(j_models, "LipSyncModel", _Initialised)
    monkeypatch.setattr(
        j_engine_mod, "ScoringEngine",
        lambda v, c, shared_visual_encoding=False: recorded(
            JEngine(variables, jcfg, use_bfloat16=False,
                    shared_visual_encoding=shared_visual_encoding), "jax"))
    argv = ["--n-tracks", "2", "--n-frames", "24", "--stride", "4"]
    assert eval_shared_encoding.main(
        [*argv, "--out", str(tmp_path / "p.json"), *CPU]) == 0
    capsys.readouterr()
    assert jax_call(j_shared.main,
                    [*argv, "--out", str(tmp_path / "j.json")]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert len(probs["port"]) == len(probs["jax"]) == 4
    for p, j in zip(probs["port"], probs["jax"]):
        np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)
    assert set(got) == set(want) and got["platform"] == "cpu"
    for key in ("n_tracks", "n_frames_per_track", "n_windows", "platform"):
        assert got[key] == want[key], key
    _within(got["prob_abs_diff"], want["prob_abs_diff"], tol=1e-4)
    assert np.isfinite(list(got["prob_abs_diff"].values())).all()


class _Initialised:
    """Stands in for the JAX ``LipSyncModel`` whose ``init`` the script
    calls: the engines above hold the weights, so ``init`` returns none."""

    def __init__(self, cfg, dtype=None):
        pass

    def init(self, *args):
        return {}


def test_mel_window_matches_the_jax_script():
    rng = np.random.RandomState(2)
    mel = rng.randn(80, 300).astype(np.float32)
    for start in (0, 8, 17, 64, 200):
        np.testing.assert_array_equal(
            eval_shared_encoding._mel_window(mel, start, 15.0, 100.0, 32),
            j_shared._mel_window(mel, start, 15.0, 100.0, 32))


# ── eval_shared_encoding_flips ───────────────────────────────────────────


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    """The generator's envelope clips, two per class, 2 s."""
    out = tmp_path_factory.mktemp("labelled")
    gen.main(["--output-dir", str(out), "--n-per-class", "2", "--seconds",
              "2.0", "--seed", "21", "--jitter", "--hard-negatives"])
    return out


def test_eval_shared_encoding_flips_matches_the_jax_script(
        tmp_path, monkeypatch, engines, labelled, capsys):
    _, _, cfg, jcfg, variables = engines
    weights = tmp_path / "w.pth"
    torch.save(engines[0].model.state_dict(), weights)
    real_predictor = j_predictor_mod.Predictor

    def jax_predictor(model_path, config):
        assert model_path == weights
        engine = JEngine(variables, jcfg, use_bfloat16=False,
                         shared_visual_encoding=config.shared_visual_encoding)
        return real_predictor(config=config, model_config=jcfg,
                              engine=engine,
                              detector_backend=JFake(lambda i: [BOX]))

    monkeypatch.setattr(j_predictor_mod, "Predictor", jax_predictor)
    argv = ["--data-dir", str(labelled), "--model-path", str(weights),
            "--limit", "4"]
    assert eval_shared_encoding_flips.main(
        [*argv, "--out", str(tmp_path / "p.json"), *CPU],
        model_config=cfg,
        detector_backend=FakeDetector(lambda i: [BOX])) == 0
    capsys.readouterr()
    assert jax_call(j_flips.main,
                    [*argv, "--out", str(tmp_path / "j.json")]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got["n_clips"] == want["n_clips"] == 4
    _within(got, want, tol=1e-4)


# ── eval_multiface ───────────────────────────────────────────────────────


def _multiface_rows(path):
    out = json.loads(path.read_text())
    for row in out["clips"]:
        row.pop("elapsed_sec")
    for group in out["summary"].values():
        group.pop("mean_elapsed_sec")
    return out


@pytest.mark.parametrize("route", ["engine", "stub_engine"])
def test_eval_multiface_matches_the_jax_script(tmp_path, engines, scenes,
                                               capsys, route):
    """Real decode, the default Haar ladder and the tracker on both sides;
    the model (or the stub) scores the tracks."""
    port_engine, jax_engine = engines[:2]
    argv = ["--data-dir", str(scenes), "--speaking-score-mode",
            "articulation", "--calibration-method", "platt",
            "--calibration-platt-a", "2.0", "--calibration-platt-b", "0.3"]
    if route == "stub_engine":
        argv.append("--stub-engine")
        kwargs, jkwargs = {}, {}
    else:  # the 2-face scene through the model
        argv += ["--limit", "1"]
        kwargs, jkwargs = {"engine": port_engine}, {"engine": jax_engine}
    assert eval_multiface.main([*argv, "--output", str(tmp_path / "p.json"),
                                *CPU], **kwargs) == 0
    capsys.readouterr()
    assert jax_call(j_mf.main, [*argv, "--output", str(tmp_path / "j.json")],
                    **jkwargs) == 0
    got = _multiface_rows(tmp_path / "p.json")
    want = _multiface_rows(tmp_path / "j.json")
    assert [r["clip"] for r in got["clips"]] == [
        "all_fake_0000.avi", "mixed_0000.avi"][:len(got["clips"])]
    assert got["summary"]["overall"]["face_recovery"] > 0
    _within(got, want, tol=1e-4)


# ── a failing kernel ends the run ────────────────────────────────────────


def _failing_k1(y, *args, **kwargs):
    raise ValueError("unsupported device for K1")


def _failing_k2(*args, **kwargs):
    raise RuntimeError("hf_stem kernel launch failed: cudaError 98")


KERNELS = {"k1": (audio_mod, "log_mel_spectrogram_fused", _failing_k1,
                  ValueError),
           "k2": (artifact_mod, "hf_stem", _failing_k2, RuntimeError)}


def _run_harness(tool, tmp_path, engines, labelled, scenes, monkeypatch):
    port_engine, _, cfg = engines[:3]
    if tool == "eval_shared_encoding":
        small = seeded_pair(0, video_frames=8, crop_size=32,
                            audio_frames=32)[1]
        monkeypatch.setattr(eval_shared_encoding, "ModelConfig",
                            lambda: small)
        return eval_shared_encoding.main(["--n-tracks", "1", "--n-frames",
                                          "16", *CPU])
    if tool == "eval_shared_encoding_flips":
        weights = tmp_path / "w.pth"
        torch.save(port_engine.model.state_dict(), weights)
        return eval_shared_encoding_flips.main(
            ["--data-dir", str(labelled), "--model-path", str(weights),
             "--limit", "2", "--out", str(tmp_path / "f.json"), *CPU],
            model_config=cfg, detector_backend=FakeDetector(lambda i: [BOX]))
    return eval_multiface.main(
        ["--data-dir", str(scenes), "--limit", "1", "--output",
         str(tmp_path / "m.json"), *CPU], engine=port_engine,
        detector_backend=FakeDetector(lambda i: [BOX]))


FAILING = [(tool, kernel) for tool in (
    "eval_shared_encoding", "eval_shared_encoding_flips", "eval_multiface")
    for kernel in ("k1", "k2")]


@pytest.mark.parametrize("tool,kernel", FAILING,
                         ids=[f"{t}-{k}" for t, k in FAILING])
def test_a_failing_kernel_ends_the_run(tmp_path, engines, labelled, scenes,
                                       monkeypatch, tool, kernel):
    """A kernel wrapper that raises, as the wrappers do for a build or
    launch failure (RuntimeError) or a wrong device (ValueError), ends the
    harness's run: no track or clip is skipped for it."""
    owner, attr, failing, error = KERNELS[kernel]
    monkeypatch.setattr(owner, attr, failing)
    with pytest.raises(error):
        _run_harness(tool, tmp_path, engines, labelled, scenes, monkeypatch)


# ── the device: cuda:0 unless asked ──────────────────────────────────────


DEVICE_TOOLS = {
    "eval_shared_encoding": lambda d: eval_shared_encoding.main([]),
    "eval_shared_encoding_flips": lambda d: eval_shared_encoding_flips.main(
        ["--data-dir", str(d), "--model-path", str(d / "w.pth")]),
    "eval_multiface": lambda d: eval_multiface.main(
        ["--data-dir", str(d), "--stub-engine"]),
}


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOLS))
def test_harnesses_ask_for_cuda(tmp_path, monkeypatch, labelled, tool):
    """Without ``--device`` a harness asks for cuda:0 and raises where
    there is no CUDA, before it loads weights or reads a clip."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "w.pth").write_bytes(b"")
    for sub in ("0_real", "1_fake"):
        (tmp_path / sub).symlink_to(labelled / sub)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEVICE_TOOLS[tool](tmp_path)
