"""The port's evaluation harnesses over preprocessed windows, and the crop
agreement, against the JAX package's scripts of the same names, on the
CPU: ``eval_cross_tier``, ``eval_unseen_fakes``, ``eval_robustness_grid``
and ``eval_crop_agreement`` (the harnesses that replay tracks and clips
are in ``tests/test_torch_tools_replay.py``). Both packages run on the
same bridged seeded weights (``tests/torch_parity.py::seeded_pair`` at the
parity tests' narrow width) and the same seeded inputs and files, through
the in-process routes (``--in-process``, ``engine=``); the unseen
constructions are generated and precomputed here with real decode and
real Haar detection. Also: a failing kernel ends each harness's run,
``--device`` asks for cuda:0, and none of the 15 tools of this slice
imports the JAX package, ``scripts/`` or ``tests/``.

Tolerances: probabilities and logits within 1e-4 (the fp32 engine bound
of ``tests/test_torch_engine.py``); metrics derived from them and host-only
outputs (IoUs) equal; JSON keys equal.
"""

import ast
import contextlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import eval_crop_agreement as j_crop  # noqa: E402
import eval_cross_tier as j_xtier  # noqa: E402
import eval_robustness_grid as j_grid  # noqa: E402
import eval_unseen_fakes as j_unseen  # noqa: E402

import lipsync_tpu.inference.engine as j_engine_mod  # noqa: E402
from lipsync_tpu.inference.engine import ScoringEngine as JEngine  # noqa: E402
from lipsync_tpu_torch.inference import engine as engine_mod  # noqa: E402
from lipsync_tpu_torch.inference.engine import ScoringEngine  # noqa: E402
from lipsync_tpu_torch.models import artifact as artifact_mod  # noqa: E402
from lipsync_tpu_torch.tools import eval_crop_agreement  # noqa: E402
from lipsync_tpu_torch.tools import eval_cross_tier  # noqa: E402
from lipsync_tpu_torch.tools import eval_robustness_grid  # noqa: E402
from lipsync_tpu_torch.tools import eval_unseen_fakes  # noqa: E402
from lipsync_tpu_torch.utils import synthetic  # noqa: E402
from tests.torch_parity import seeded_pair  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
NEW_TOOLS = (
    "eval_cross_tier", "eval_unseen_fakes", "eval_robustness_grid",
    "eval_shared_encoding", "eval_shared_encoding_flips", "eval_multiface",
    "eval_crop_agreement", "diagnose_sync_signal",
    "inspect_preprocessed_window", "debug_clips",
    "measure_articulation_bands", "probe_link_engine", "diagnose_videos",
    "check_epoch", "checking_threshold")


def jax_call(fn, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kwargs)


def _pair(crop_size):
    _, cfg, variables, jcfg = seeded_pair(
        5, video_frames=8, crop_size=crop_size, audio_frames=32)
    return (ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False),
            JEngine(variables, jcfg, use_bfloat16=False), cfg, jcfg,
            variables)


@pytest.fixture(scope="module")
def engines():
    return _pair(48)


@pytest.fixture(scope="module")
def tiers(tmp_path_factory, engines):
    """Two preprocessed tiers of eight clips at the engines' crop size."""
    out = tmp_path_factory.mktemp("tiers")
    return {name: synthetic.write_corpus(
                out / name, n_clips=8, n_frames=20, seed=seed,
                crop_size=engines[2].crop_size, device="cpu")
            for name, seed in (("envelope", 3), ("phoneme", 4))}


def _loads_engine(monkeypatch, port_engine, jax_engine):
    """``load_engine`` of both packages hands out the prepared engines."""
    monkeypatch.setattr(engine_mod, "load_engine",
                        lambda *a, **k: port_engine)
    monkeypatch.setattr(j_engine_mod, "load_engine",
                        lambda *a, **k: jax_engine)


# ── eval_cross_tier ──────────────────────────────────────────────────────


def _tier_argv(tiers, *extra):
    argv = ["--model-path", "/weights/run/best_model_accuracy",
            "--batch-size", "4", "--in-process", *extra]
    for name, d in tiers.items():
        argv += ["--test-dir", f"{name}={d}"]
    return argv


@pytest.mark.parametrize("platt", [None, ("1.7", "-0.2")],
                         ids=["uncalibrated", "platt"])
def test_eval_cross_tier_matches_the_jax_script(tmp_path, monkeypatch,
                                                engines, tiers, capsys,
                                                platt):
    port_engine, jax_engine = engines[:2]
    _loads_engine(monkeypatch, port_engine, jax_engine)
    extra = [] if platt is None else [
        "--calibration-platt-a", platt[0], "--calibration-platt-b", platt[1]]
    assert eval_cross_tier.main([*_tier_argv(tiers, *extra), "--output",
                                 str(tmp_path / "p.json"), *CPU]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert jax_call(j_xtier.main, [*_tier_argv(tiers, *extra), "--output",
                                   str(tmp_path / "j.json")]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got == want
    assert set(got["tiers"]) == {"envelope", "phoneme"}
    assert got["tiers"]["envelope"]["total"] == 8
    # The same printed lines, the temporary directories' names aside.
    assert [ln.split(" (")[0] for ln in port_lines] == [
        ln.split(" (")[0] for ln in jax_lines]


def test_eval_cross_tier_subprocess_has_the_jax_command(tmp_path,
                                                        monkeypatch):
    """The subprocess route runs the port's validate_pipeline entry point
    with the JAX script's arguments and ``--device``."""
    calls = {}

    def fake_run(cmd, **kwargs):
        calls.setdefault("cmds", []).append(cmd)
        (Path(cmd[cmd.index("--output-dir") + 1]) / "metrics.json"
         ).write_text(json.dumps({"f1": 0.5, "total": 3, "errors": 0}))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    for module in (eval_cross_tier, j_xtier):
        monkeypatch.setattr(module.subprocess, "run", fake_run)
        got = module.score_tier("m.pth", "pre", tmp_path, 0.5, -0.1, 7, 16)
        assert got == {"f1": 0.5, "total": 3}
    port, jax_cmd = calls["cmds"]
    assert port[:3] == [sys.executable, "-m",
                        "lipsync_tpu_torch.tools.validate_pipeline"]
    assert jax_cmd[:2] == [sys.executable, "scripts/validate_pipeline.py"]
    args = port[3:]
    i = args.index("--device")
    assert args[i + 1] == "cuda:0"
    assert args[:i] + args[i + 2:] == jax_cmd[2:]


def test_eval_cross_tier_subprocess_failure_ends_the_run(tmp_path):
    """A validate_pipeline child that fails (here: no weights at the path)
    ends the harness with its message."""
    pre = synthetic.write_corpus(tmp_path / "pre", n_clips=2, n_frames=12,
                                 crop_size=32, device="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "lipsync_tpu_torch.tools.eval_cross_tier",
         "--model-path", str(tmp_path / "missing.pth"), "--test-dir",
         f"t={pre}", *CPU], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert proc.returncode != 0
    assert "validate_pipeline failed on" in proc.stderr
    assert "Model weights not found" in proc.stdout


# ── eval_unseen_fakes ────────────────────────────────────────────────────


def _stages(module, argv, work, monkeypatch):
    cmds = []
    if module is eval_unseen_fakes:  # the device is never used here
        monkeypatch.setattr(module, "get_device", lambda device: device)
    monkeypatch.setattr(module, "run",
                        lambda cmd, log: cmds.append(
                            ([str(c) for c in cmd], log.name)))
    monkeypatch.setattr(module, "score_tier",
                        lambda *a, **k: {"roc_auc": 0.5, "recall": 1.0})
    assert module.main(["--model-path", "w/best", "--work-dir", str(work),
                        *argv]) == 0
    return cmds


@pytest.mark.parametrize("argv", [
    [],
    ["--constructions", "warp,shift", "--n-per-class", "3", "--seconds",
     "2.5", "--seed-base", "7", "--skip-generate", "--device", "cpu"],
], ids=["defaults", "flags"])
def test_eval_unseen_fakes_has_the_jax_stages(tmp_path, monkeypatch, argv,
                                              capsys):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda:0"
    jax_argv = [a for a in argv if a not in ("--device", "cpu")]
    got = _stages(eval_unseen_fakes, argv, tmp_path, monkeypatch)
    port_out = capsys.readouterr().out
    want = _stages(j_unseen, jax_argv, tmp_path, monkeypatch)
    assert port_out == capsys.readouterr().out
    assert [log for _, log in got] == [log for _, log in want]
    for (g, _), (w, _) in zip(got, want):
        assert g[0] == w[0] == sys.executable and g[1] == "-m"
        name = g[2].removeprefix("lipsync_tpu_torch.tools.")
        assert w[1] == f"scripts/{name}.py"
        args = g[3:]
        if name == "precompute_training_tensors":
            assert args[-2:] == ["--device", device]
            args = args[:-2]
        assert args == w[2:], name


def _in_process_run(cmd, log):
    """A stage of the port's harness run in this process: the tool's
    ``main`` on the command's arguments."""
    cmd = [str(c) for c in cmd]
    assert cmd[1] == "-m" and cmd[2].startswith("lipsync_tpu_torch.tools.")
    importlib.import_module(cmd[2]).main(cmd[3:])


def test_eval_unseen_fakes_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's chain (generate, precompute with real decode and Haar
    detection, score) in process, and the JAX script scoring the same
    precomputed constructions: the same JSON."""
    port_engine, jax_engine = _pair(96)[:2]
    _loads_engine(monkeypatch, port_engine, jax_engine)
    monkeypatch.setattr(eval_unseen_fakes, "run", _in_process_run)
    common = ["--model-path", "/w/run/best", "--work-dir", str(tmp_path),
              "--n-per-class", "1", "--seconds", "1.5", "--constructions",
              "shift,warp,composite", "--batch-size", "4", "--in-process",
              "--calibration-platt-a", "1.3", "--calibration-platt-b", "0.1"]
    assert eval_unseen_fakes.main(
        [*common, "--output", str(tmp_path / "p.json"), *CPU]) == 0
    assert jax_call(j_unseen.main, [
        *common, "--skip-generate", "--skip-precompute", "--output",
        str(tmp_path / "j.json")]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got == want
    assert set(got["constructions"]) == {"shift", "warp", "composite"}
    assert [got["constructions"][c]["unseen"] for c in
            ("shift", "warp", "composite")] == [False, True, True]
    assert all(m["total"] == 2 for m in got["constructions"].values())


# ── eval_robustness_grid ─────────────────────────────────────────────────


def test_eval_robustness_grid_matches_the_jax_script(tmp_path, engines,
                                                     tiers):
    """All 17 cells, the codec ones through libx264 here."""
    port_engine, jax_engine = engines[:2]
    argv = ["--preprocessed-dir", str(tiers["envelope"]), "--batch-size",
            "4", "--seed", "3", "--threshold", "0.45"]
    probs = {"port": [], "jax": []}

    def recording(engine, key):
        real = engine.score_probs

        def score_probs(v, a):
            out = real(v, a)
            probs[key].append(np.asarray(out))
            return out
        return score_probs

    with _patched(port_engine, "score_probs",
                  recording(port_engine, "port")), \
            _patched(jax_engine, "score_probs",
                     recording(jax_engine, "jax")):
        got = eval_robustness_grid.main(
            [*argv, "--output", str(tmp_path / "p.json"), *CPU],
            engine=port_engine)
        want = jax_call(j_grid.run_grid, j_grid.build_argparser().parse_args(
            [*argv, "--output", str(tmp_path / "j.json")]),
            engine=jax_engine)
    assert len(got["cells"]) == 17 and list(got["cells"]) == list(
        want["cells"])
    np.testing.assert_allclose(np.concatenate(probs["port"]),
                               np.concatenate(probs["jax"]), atol=1e-4,
                               rtol=0)
    for key in ("timestamp", "preprocessed_dir"):
        got.pop(key)
        want.pop(key)
    assert got == want
    assert json.loads((tmp_path / "p.json").read_text())["cells"] == (
        got["cells"])


@contextlib.contextmanager
def _patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def test_eval_robustness_grid_codec_cell_raises_without_ffmpeg(
        tmp_path, engines, tiers, monkeypatch):
    """A codec cell asked for on a machine whose muxer cannot be built
    raises: the cell is never dropped from the grid."""
    from lipsync_tpu_torch.preprocessing import mux

    def no_ffmpeg():
        raise RuntimeError("g++ failed: libavformat/avformat.h: No such "
                           "file or directory")

    monkeypatch.setattr(mux, "_lib", None)
    monkeypatch.setattr(mux, "_get_lib", no_ffmpeg)
    with pytest.raises(RuntimeError, match="avformat"):
        eval_robustness_grid.main(
            ["--preprocessed-dir", str(tiers["envelope"]), "--cells",
             "clean,codec_crf23", *CPU], engine=engines[0])


def test_eval_robustness_grid_int8_matches_the_jax_script(engines, tiers):
    """``--quantized-int8`` serves through the int8 lowering (K4 then K3;
    their twins here) against the JAX package's int8 engine: the clean and
    brightness cells equal."""
    _, _, cfg, jcfg, variables = engines
    port = ScoringEngine(variables, cfg, device="cpu", use_bfloat16=False,
                         quantized_int8=True)
    reference = JEngine(variables, jcfg, use_bfloat16=False,
                        quantized_int8=True)
    argv = ["--preprocessed-dir", str(tiers["phoneme"]), "--cells",
            "clean,brightness", "--quantized-int8", "--batch-size", "8"]
    got = eval_robustness_grid.main([*argv, *CPU], engine=port)
    want = jax_call(j_grid.run_grid, j_grid.build_argparser().parse_args(
        argv), engine=reference)
    assert list(got["cells"]) == ["clean", "brightness_0.7",
                                  "brightness_1.3"]
    assert got["cells"] == want["cells"]


# ── eval_crop_agreement (host only) ──────────────────────────────────────


TIMES = ("refine_ms_per_frame", "learned_ms_per_frame")


@pytest.mark.parametrize("family", ["standard", "stress", "stride"])
def test_eval_crop_agreement_matches_the_jax_script(family):
    if family == "standard":
        got, want = eval_crop_agreement.run(24, 3), j_crop.run(24, 3)
    elif family == "stress":
        got = eval_crop_agreement.run_stress(16, 4)
        want = j_crop.run_stress(16, 4)
    else:
        got = eval_crop_agreement.run_stride_sim(6, 30, 5)
        want = j_crop.run_stride_sim(6, 30, 5)
    for key in TIMES:
        assert (key in got) == (key in want)
        got.pop(key, None)
        want.pop(key, None)
    assert got == want


def test_eval_crop_agreement_cli_prints_the_report(tmp_path, capsys):
    out = tmp_path / "r.json"
    report = eval_crop_agreement.main(["--n", "6", "--seed", "1", "--out",
                                       str(out)])
    assert json.loads(capsys.readouterr().out) == report
    assert json.loads(out.read_text()) == report
    assert "learned" in report["iou_vs_landmark_analog"]


# ── a failing kernel ends the run ────────────────────────────────────────


def _failing_k2(*args, **kwargs):
    raise RuntimeError("hf_stem kernel launch failed: cudaError 98")


def _run_harness(tool, tmp_path, engines, tiers, monkeypatch):
    port_engine = engines[0]
    if tool == "eval_cross_tier":
        monkeypatch.setattr(engine_mod, "load_engine",
                            lambda *a, **k: port_engine)
        return eval_cross_tier.main(_tier_argv(tiers, *CPU))
    if tool == "eval_unseen_fakes":
        monkeypatch.setattr(engine_mod, "load_engine",
                            lambda *a, **k: port_engine)
        for name, d in tiers.items():
            (tmp_path / f"pre_{name}").symlink_to(d)
        return eval_unseen_fakes.main([
            "--model-path", "w", "--work-dir", str(tmp_path),
            "--constructions", "envelope,phoneme", "--skip-generate",
            "--skip-precompute", "--in-process", *CPU])
    return eval_robustness_grid.main(
        ["--preprocessed-dir", str(tiers["envelope"]), "--cells", "clean",
         *CPU], engine=port_engine)


FAILING = ["eval_cross_tier", "eval_unseen_fakes", "eval_robustness_grid"]


@pytest.mark.parametrize("tool", FAILING)
def test_a_failing_kernel_ends_the_run(tmp_path, engines, tiers,
                                       monkeypatch, tool):
    """A kernel wrapper that raises, as the wrappers do for a build or
    launch failure, ends the harness's run: no tier, construction or cell
    is skipped for it. These harnesses score preprocessed windows, so the
    kernel they run is K2."""
    monkeypatch.setattr(artifact_mod, "hf_stem", _failing_k2)
    with pytest.raises(RuntimeError, match="hf_stem kernel"):
        _run_harness(tool, tmp_path, engines, tiers, monkeypatch)


# ── the device: cuda:0 unless asked ──────────────────────────────────────


DEVICE_TOOLS = {
    "eval_cross_tier": lambda d: eval_cross_tier.main(
        ["--model-path", str(d / "w.pth"), "--test-dir", f"t={d}",
         "--in-process"]),
    "eval_unseen_fakes": lambda d: eval_unseen_fakes.main(
        ["--model-path", str(d / "w.pth"), "--work-dir", str(d),
         "--skip-generate", "--skip-precompute", "--in-process"]),
    "eval_robustness_grid": lambda d: eval_robustness_grid.main(
        ["--preprocessed-dir", str(d), "--model-path", str(d / "w.pth")]),
}


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOLS))
def test_harnesses_ask_for_cuda(tmp_path, monkeypatch, tool):
    """Without ``--device`` a harness asks for cuda:0 and raises where
    there is no CUDA, before it loads weights or reads data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "w.pth").write_bytes(b"")
    (tmp_path / "manifest.jsonl").write_text(
        '{"key": "a", "label": 1, "visual_relpath": "a.npy", '
        '"audio_relpath": "b.npy"}\n')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEVICE_TOOLS[tool](tmp_path)


# ── what the tools import ────────────────────────────────────────────────


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_tool_stands_alone(tool):
    """No tool imports JAX, the JAX package, ``scripts/`` or ``tests/``, or
    names a JAX module or a ``scripts/*.py`` path."""
    source = (ROOT / "lipsync_tpu_torch" / "tools" / f"{tool}.py").read_text()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in (
                "jax", "lipsync_tpu", "scripts", "tests", "fixtures",
                "test_predictor"), (tool, n)
    assert "scripts/" not in source and "lipsync_tpu." not in source
    assert "tests/" not in source, tool
