"""The port's calibration and evaluation tools against the JAX package's
scripts of the same names, on the CPU, with both packages' engines on the
same bridged seeded weights (``tests/conftest.py::small_model_config``'s
geometry at the parity tests' narrow width); the isotonic repair against
sklearn; the line between a file a host stage could not use and a failing
kernel; and ``run_synthetic_eval``'s stages.

Tolerances: probabilities and logits within 1e-4 (the fp32 engine bound of
``tests/test_torch_engine.py``); temperature and Platt parameters within
1e-6 on the same logits; the isotonic map and ROC AUC within 1e-12 of
sklearn's.
"""

import csv
import json
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import fit_calibrator as j_fit  # noqa: E402
import run_grid_eval as j_grid  # noqa: E402
import run_synthetic_eval as j_synth  # noqa: E402
import validate_pipeline as j_val  # noqa: E402

from lipsync_tpu.inference.calibration import Calibrator as JCalibrator
from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.predictor import Predictor as JPredictor
from lipsync_tpu.inference.predictor import PredictorConfig as JConfig
from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu_torch.inference.calibration import (
    Calibrator,
    IsotonicCalibrator,
    fit_isotonic,
)
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.predictor import Predictor, PredictorConfig
from lipsync_tpu_torch.models import artifact as artifact_mod
from lipsync_tpu_torch.preprocessing import audio as audio_mod
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from lipsync_tpu_torch.tools import check_setup, fit_calibrator
from lipsync_tpu_torch.tools import filter_corrupt_videos
from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
from lipsync_tpu_torch.tools import precompute_training_tensors as pre
from lipsync_tpu_torch.tools import run_grid_eval, run_synthetic_eval
from lipsync_tpu_torch.tools import validate_pipeline
from lipsync_tpu_torch.utils import synthetic
from tests.conftest import small_model_config
from tests.torch_parity import seeded_pair

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
BOX = (50, 60, 130, 120)
KNOBS = {"chunk_size": 8, "chunk_stride": 4}


def jax_call(fn, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def engines():
    small = small_model_config()
    _, cfg, variables, jcfg = seeded_pair(
        5, video_frames=small.video_frames, crop_size=small.crop_size,
        audio_frames=small.audio_frames)
    return (ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False),
            JEngine(variables, jcfg, use_bfloat16=False), cfg, jcfg)


@pytest.fixture(scope="module")
def pre_dir(tmp_path_factory, engines):
    """Ten preprocessed clips at the engines' crop size, as npy."""
    out = tmp_path_factory.mktemp("pre")
    return synthetic.write_corpus(out, n_clips=10, n_frames=20,
                                  crop_size=engines[2].crop_size,
                                  device="cpu")


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """The generator's clips as .avi (2 s; two per class) and one file
    that cannot be decoded."""
    out = tmp_path_factory.mktemp("videos")
    gen.main(["--output-dir", str(out), "--n-per-class", "2", "--seconds",
              "2.0", "--seed", "11", "--jitter", "--hard-negatives"])
    (out / "1_fake" / "broken.avi").write_bytes(b"not a video")
    return out


def _predictors(engines):
    port_engine, jax_engine, cfg, jcfg = engines
    port = Predictor(config=PredictorConfig(**KNOBS), model_config=cfg,
                     engine=port_engine,
                     detector_backend=FakeDetector(lambda i: [BOX]),
                     device="cpu")
    reference = JPredictor(config=JConfig(**KNOBS), model_config=jcfg,
                           engine=jax_engine,
                           detector_backend=JFake(lambda i: [BOX]))
    return port, reference


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_same_rows(got, want):
    assert [r["path"] for r in got] == [r["path"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key in ("confidence", "inference_time"):
                continue
            assert g[key] == w[key], (key, g, w)
        assert abs(float(g["confidence"]) - float(w["confidence"])) <= 1e-4


# ── the isotonic repair ──────────────────────────────────────────────────


def _labelled(n, seed):
    """Probabilities rounded to two places (ties) and labels drawn from
    them."""
    rng = np.random.default_rng(seed)
    probs = np.round(rng.random(n), 2)
    return probs, (rng.random(n) < probs).astype(np.float64)


@pytest.mark.parametrize("n", [1, 2, 7, 60, 500])
def test_isotonic_fit_matches_sklearn(n):
    from sklearn.isotonic import IsotonicRegression

    probs, labels = _labelled(n, n)
    want = IsotonicRegression(out_of_bounds="clip", y_min=0.0,
                              y_max=1.0).fit(probs, labels)
    got = fit_isotonic(probs, labels)
    queries = np.concatenate([np.linspace(-0.5, 1.5, 301), probs])
    np.testing.assert_allclose(got.predict(queries.reshape(-1, 1)),
                               want.predict(queries.reshape(-1, 1)),
                               atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got.x_thresholds, want.X_thresholds_)
    np.testing.assert_allclose(got.y_thresholds, want.y_thresholds_,
                               atol=1e-12, rtol=0)


def test_isotonic_model_loads_without_sklearn(tmp_path, monkeypatch):
    probs, labels = _labelled(80, 3)
    path = tmp_path / "iso.pkl"
    path.write_bytes(pickle.dumps(fit_isotonic(probs, labels)))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401
    cal = Calibrator.from_config(method="isotonic", isotonic_path=str(path))
    assert cal.method == "isotonic"
    assert isinstance(cal.isotonic_model, IsotonicCalibrator)
    logits = np.linspace(-4, 4, 9)
    want = fit_isotonic(probs, labels).predict(1 / (1 + np.exp(-logits)))
    np.testing.assert_allclose(cal(logits), want.astype(np.float32), rtol=0,
                               atol=0)


def test_unreadable_isotonic_file_falls_back_with_a_warning(tmp_path):
    """The JAX package's fall-back to uncalibrated scores, now said aloud:
    a warning names the file and the exception."""
    import logging

    path = tmp_path / "sklearn_model.pkl"
    path.write_bytes(b"\x80\x04not a pickle")
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("lipsync_tpu_torch.inference.calibration")
    logger.addHandler(handler)
    try:
        cal = Calibrator.from_config(method="isotonic",
                                     isotonic_path=str(path))
    finally:
        logger.removeHandler(handler)
    assert cal.method == "none"
    assert len(records) == 1 and records[0].levelname == "WARNING"
    message = records[0].getMessage()
    assert str(path) in message and "UnpicklingError" in message
    assert JCalibrator.from_config(method="isotonic",
                                   isotonic_path=str(path)).method == "none"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_auc_matches_sklearn_with_ties(seed):
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(seed)
    probs = np.round(rng.random(50), 1)
    truth = rng.random(50) < 0.4
    assert abs(validate_pipeline.roc_auc(probs, truth)
               - roc_auc_score(truth, probs)) <= 1e-12
    assert validate_pipeline.roc_auc(probs, np.zeros(50, bool)) == 0.5


# ── calibration and evaluation against the JAX scripts ───────────────────


def test_fit_calibrator_matches_the_jax_script(tmp_path, engines, pre_dir):
    port_engine, jax_engine = engines[:2]
    common = ["--preprocessed-dir", str(pre_dir), "--batch-size", "4"]
    got = fit_calibrator.main(
        [*common, "--save-logits", str(tmp_path / "p.npz"),
         "--isotonic-out", str(tmp_path / "p.pkl"), *CPU],
        engine=port_engine)
    jax_call(j_fit.main, [*common, "--save-logits", str(tmp_path / "j.npz"),
                          "--isotonic-out", str(tmp_path / "j.pkl")],
             engine=jax_engine)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_array_equal(p["labels"], j["labels"])
    assert len(p["logits"]) == 10
    np.testing.assert_allclose(p["logits"], j["logits"], atol=1e-4, rtol=0)
    # The fits on the same logits.
    same = j_fit.main(["--logits-in", str(tmp_path / "p.npz"),
                       "--isotonic-out", str(tmp_path / "j2.pkl")])
    for key in ("calibration_temperature", "calibration_platt_a",
                "calibration_platt_b"):
        assert abs(got[key] - same[key]) <= 1e-6, key
    port_iso = pickle.loads((tmp_path / "p.pkl").read_bytes())
    jax_iso = pickle.loads((tmp_path / "j2.pkl").read_bytes())
    queries = np.linspace(-0.2, 1.2, 141).reshape(-1, 1)
    np.testing.assert_allclose(port_iso.predict(queries),
                               jax_iso.predict(queries), atol=1e-12, rtol=0)


@pytest.mark.parametrize("method", ["none", "platt", "temperature"])
def test_preprocessed_mode_matches_the_jax_script(tmp_path, engines, pre_dir,
                                                  method):
    port_engine, jax_engine = engines[:2]
    argv = ["--preprocessed-dir", str(pre_dir), "--batch-size", "4",
            "--calibration-method", method, "--calibration-platt-a", "1.7",
            "--calibration-platt-b", "-0.2",
            "--calibration-temperature", "0.6"]
    knobs = dict(method=method, temperature=0.6, platt_a=1.7, platt_b=-0.2)
    port_engine.calibrator = Calibrator.from_config(**knobs)
    jax_engine.calibrator = JCalibrator.from_config(**knobs)
    got = validate_pipeline.run_preprocessed_mode(
        validate_pipeline.build_argparser().parse_args(
            [*argv, "--output-dir", str(tmp_path / "p"), *CPU]),
        engine=port_engine)
    want = jax_call(j_val.run_preprocessed_mode,
                    j_val.build_argparser().parse_args(
                        [*argv, "--output-dir", str(tmp_path / "j")]),
                    engine=jax_engine)
    _assert_same_rows(_rows(tmp_path / "p" / "predictions.csv"),
                      _rows(tmp_path / "j" / "predictions.csv"))
    assert set(got) == set(want)
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-4, key
    assert json.loads((tmp_path / "p" / "metrics.json").read_text()) == got


def test_video_mode_matches_the_jax_script(tmp_path, engines, video_dir):
    port, reference = _predictors(engines)
    argv = ["--data-dir", str(video_dir), "--save-every", "2"]
    got = validate_pipeline.run_video_mode(
        validate_pipeline.build_argparser().parse_args(
            [*argv, "--output-dir", str(tmp_path / "p"), *CPU]),
        predictor=port)
    want = jax_call(j_val.run_video_mode, j_val.build_argparser().parse_args(
        [*argv, "--output-dir", str(tmp_path / "j")]), predictor=reference)
    rows = _rows(tmp_path / "p" / "predictions.csv")
    _assert_same_rows(rows, _rows(tmp_path / "j" / "predictions.csv"))
    # The undecodable file is an error row, as in the JAX script.
    assert [r["verdict"] == "error" for r in rows].count(True) == 1
    assert got["errors"] == want["errors"] == 1
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-4, key


def test_run_grid_eval_matches_the_jax_script(tmp_path, engines, video_dir,
                                              capsys):
    port, reference = _predictors(engines)
    labels = tmp_path / "labels.csv"
    with labels.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "label"])
        w.writeheader()
        for p in sorted(video_dir.rglob("*.avi")):
            w.writerow({"path": str(p), "label": int("real" in p.name)})
        w.writerow({"path": str(tmp_path / "missing.avi"), "label": 1})
    argv = ["--labels-csv", str(labels)]
    got = run_grid_eval.main([*argv, *CPU], predictor=port)
    out_port = capsys.readouterr().out
    want = jax_call(j_grid.main, argv, predictor=reference)
    out_jax = capsys.readouterr().out
    assert got == want and out_port == out_jax
    assert got["tp"] + got["tn"] + got["fp"] + got["fn"] == 4


# ── a failing kernel ends the run; an unusable file does not ─────────────


def _failing_k1(y, *args, **kwargs):
    raise ValueError("unsupported device for K1")


def _failing_k2(*args, **kwargs):
    raise RuntimeError("hf_stem kernel launch failed: cudaError 98")


KERNELS = {"k1": (audio_mod, "log_mel_spectrogram_fused", _failing_k1,
                  ValueError),
           "k2": (artifact_mod, "hf_stem", _failing_k2, RuntimeError)}


def _run_tool(tool, tmp_path, engines, pre_dir, video_dir):
    port_engine = engines[0]
    if tool == "precompute":
        return pre.main(["--data-dir", str(video_dir), "--output-dir",
                         str(tmp_path), "--no-face-detection", *CPU])
    if tool == "fit_calibrator":
        return fit_calibrator.main(["--preprocessed-dir", str(pre_dir),
                                    *CPU], engine=port_engine)
    if tool == "validate_pipeline_preprocessed":
        return validate_pipeline.run_preprocessed_mode(
            validate_pipeline.build_argparser().parse_args(
                ["--preprocessed-dir", str(pre_dir), "--output-dir",
                 str(tmp_path), *CPU]), engine=port_engine)
    port, _ = _predictors(engines)
    if tool == "validate_pipeline_video":
        return validate_pipeline.run_video_mode(
            validate_pipeline.build_argparser().parse_args(
                ["--data-dir", str(video_dir), "--output-dir",
                 str(tmp_path), *CPU]), predictor=port)
    return run_grid_eval.main(["--videos-dir", str(video_dir), *CPU],
                              predictor=port)


FAILING = [("precompute", "k1"), ("fit_calibrator", "k2"),
           ("validate_pipeline_preprocessed", "k2"),
           ("validate_pipeline_video", "k1"),
           ("validate_pipeline_video", "k2"), ("run_grid_eval", "k1"),
           ("run_grid_eval", "k2")]


@pytest.mark.parametrize("tool,kernel", FAILING,
                         ids=[f"{t}-{k}" for t, k in FAILING])
def test_a_failing_kernel_ends_the_run(tmp_path, engines, pre_dir,
                                       video_dir, monkeypatch, tool, kernel):
    """A kernel wrapper that raises, as the wrappers do for a build or
    launch failure (RuntimeError) or a wrong device (ValueError, the type
    ingest raises for an undecodable file), ends the tool's run: it is
    never a failed clip or an error row."""
    owner, attr, failing, error = KERNELS[kernel]
    monkeypatch.setattr(owner, attr, failing)
    with pytest.raises(error):
        _run_tool(tool, tmp_path, engines, pre_dir, video_dir)
    manifest = tmp_path / "manifest.jsonl"
    assert not manifest.exists() or manifest.read_text() == ""
    assert not (tmp_path / "predictions.csv").exists()


def test_a_failing_kernel_exits_non_zero(tmp_path, video_dir):
    """Run as a command, the precompute tool exits with an error status
    when K1 fails."""
    code = (
        "import runpy, sys\n"
        "from lipsync_tpu_torch.preprocessing import audio\n"
        "def failing(y, *a, **k):\n"
        "    raise RuntimeError('log_mel kernel launch failed')\n"
        "audio.log_mel_spectrogram_fused = failing\n"
        f"sys.argv = ['precompute', '--data-dir', {str(video_dir)!r},\n"
        f"            '--output-dir', {str(tmp_path)!r},\n"
        "            '--no-face-detection', '--device', 'cpu']\n"
        "runpy.run_module('lipsync_tpu_torch.tools."
        "precompute_training_tensors', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0
    assert "log_mel kernel launch failed" in proc.stderr
    assert (tmp_path / "manifest.jsonl").read_text() == ""


def test_unusable_files_are_skipped_not_fatal(tmp_path, engines, video_dir):
    """The undecodable file is a failed clip in precompute and a skipped
    clip in the grid evaluation; the rest are scored."""
    counts = pre.main(["--data-dir", str(video_dir), "--output-dir",
                       str(tmp_path), "--no-face-detection", *CPU])
    assert counts == {"new": 4, "failed": 1, "total": 4}
    port, _ = _predictors(engines)
    m = run_grid_eval.main(["--videos-dir", str(video_dir), *CPU],
                           predictor=port)
    assert m["tp"] + m["tn"] + m["fp"] + m["fn"] == 4


# ── the device: cuda:0 unless asked ──────────────────────────────────────


DEVICE_TOOLS = ["precompute", "fit_calibrator", "validate_pipeline",
                "run_grid_eval", "filter_corrupt_videos"]


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_device_tools_ask_for_cuda(tmp_path, monkeypatch, pre_dir,
                                   video_dir, tool):
    """Without ``--device`` a tool with device work asks for cuda:0 and
    raises where there is no CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tmp_path / "w.pth"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if tool == "precompute":
            pre.main(["--data-dir", str(video_dir), "--output-dir",
                      str(tmp_path / "o")])
        elif tool in ("fit_calibrator", "validate_pipeline"):
            from lipsync_tpu_torch.models import LipSyncModel

            torch.save(LipSyncModel().state_dict(), model)
            argv = ["--preprocessed-dir", str(pre_dir), "--model-path",
                    str(model)]
            if tool == "fit_calibrator":
                fit_calibrator.main(argv)
            else:
                validate_pipeline.main(argv)
        elif tool == "run_grid_eval":
            run_grid_eval.main(["--videos-dir", str(video_dir),
                                "--model-path", str(model)])
        else:
            filter_corrupt_videos.main(
                ["--data-dir", str(video_dir), "--dry-run"],
                backend=FakeDetector(lambda i: [BOX]))


def test_check_setup_reports_each_check(tmp_path, monkeypatch, capsys,
                                        video_dir):
    """Here there is no CUDA and no nvcc: those two checks fail and the
    exit code counts them; the native libraries, the cascade file, the
    data directory and one forward (at a narrow width here) pass."""
    from lipsync_tpu_torch import models

    monkeypatch.setattr(models, "ModelConfig", _narrow_config)
    code = check_setup.main(["--data-dir", str(video_dir), *CPU])
    out = capsys.readouterr().out.splitlines()
    status = {line.split("]")[0].strip("[ "): line for line in out
              if line.startswith("[")}
    failed = [line for line in out if line.startswith("[FAIL]")]
    assert code == len(failed) == 2
    assert {line.split(":")[0][7:] for line in failed} == {"cuda", "kernels"}
    names = [line.split(":")[0][7:] for line in out if line.startswith("[")]
    assert names == ["cuda", "kernels", "native ingest", "haar cascades",
                     "native muxer", "model forward", "data dir"]
    assert "5 videos (2 real / 3 fake)" in out[-2]
    assert out[-1] == "PREFLIGHT FAILED" and status


def _narrow_config():
    from lipsync_tpu_torch.models.lip_sync_model import ModelConfig

    small = small_model_config()
    return ModelConfig(visual_feature_dim=64, audio_feature_dim=64,
                       embed_dim=64, video_frames=small.video_frames,
                       crop_size=small.crop_size,
                       audio_frames=small.audio_frames)


# ── the synthetic end-to-end run ─────────────────────────────────────────


def _stages(module, argv, work):
    """The commands ``module.main(argv)`` runs, with ``run`` patched: the
    calibration stage prints Platt values and the evaluation stage writes
    a ``metrics.json``."""
    cmds = []

    def run(cmd, log, fatal=True):
        cmds.append(([str(c) for c in cmd], log.name, fatal))
        if any("validate_pipeline" in str(c) for c in cmd):
            (work / "eval_out").mkdir(parents=True, exist_ok=True)
            (work / "eval_out" / "metrics.json").write_text('{"f1": 0.5}')
        return "calibration_platt_a: 1.2500\ncalibration_platt_b: -0.5000\n"

    with mock.patch.object(module, "run", run):
        assert module.main(["--work-dir", str(work), *argv]) == 0
    return cmds, json.loads((work / "summary.json").read_text())


def _normalized(cmd):
    """(stage name, arguments) of a stage's command in either package."""
    if cmd[1] == "-m":
        name = cmd[2].split(".", 1)[1]
        name = name.removeprefix("tools.")
        return name, cmd[3:]
    return Path(cmd[1]).stem, cmd[2:]


@pytest.mark.parametrize("argv", [
    [],
    ["--n-train", "3", "--epochs", "2", "--phase3-start-epoch", "0",
     "--lr", "3e-4", "--lr-encoder", "1e-5", "--device-augment",
     "--device-cache", "--style", "phoneme", "--no-jitter",
     "--no-hard-negatives"],
    ["--skip-generate", "--skip-precompute", "--skip-train",
     "--device", "cpu"],
], ids=["defaults", "every_flag", "skips_on_cpu"])
def test_run_synthetic_eval_has_the_jax_stages(tmp_path, argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda:0"
    jax_argv = [a for a in argv if a not in ("--device", "cpu")]
    got, got_summary = _stages(run_synthetic_eval, argv, tmp_path / "w")
    want, want_summary = _stages(j_synth, jax_argv, tmp_path / "w")
    assert got_summary == want_summary
    assert [(log, fatal) for _, log, fatal in got] == [
        (log, fatal) for _, log, fatal in want]
    with_device = {"precompute_training_tensors", "training.train",
                   "fit_calibrator", "validate_pipeline"}
    for (g, _, _), (w, _, _) in zip(got, want):
        assert g[0] == w[0] == sys.executable
        name, args = _normalized(g)
        assert (name, ) == (_normalized(w)[0], )
        if name in with_device:
            assert args[-2:] == ["--device", device]
            args = args[:-2]
        assert args == _normalized(w)[1], name
