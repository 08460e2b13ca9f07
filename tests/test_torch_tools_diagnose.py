"""The port's diagnostics against the JAX package's scripts of the same
names, on the CPU: ``diagnose_sync_signal``, ``inspect_preprocessed_window``,
``debug_clips``, ``measure_articulation_bands``, ``probe_link_engine``,
``diagnose_videos``, ``check_epoch`` and ``checking_threshold``, on the
same seeded files (real decode and the default Haar ladder where the
script detects) and, for the probe, the same bridged seeded weights at the
parity tests' narrow width. Also: a failing kernel or crop ends each
device tool's run, and ``--device`` asks for cuda:0.

Tolerances: probabilities and logits within 1e-4, the log-mel within 1e-3
dB (``tests/test_ops.py``), crops within 1e-5 (the engine tests); host-only
outputs (stored-tensor statistics, threshold sweeps, checkpoint metadata,
video diagnoses) equal; the articulation ratios, computed from crops made
on each package's device path, within 1e-4.
"""

import csv
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import check_epoch as j_check  # noqa: E402
import checking_threshold as j_thresh  # noqa: E402
import debug_clips as j_debug  # noqa: E402
import diagnose_sync_signal as j_sync  # noqa: E402
import diagnose_videos as j_videos  # noqa: E402
import inspect_preprocessed_window as j_inspect  # noqa: E402
import measure_articulation_bands as j_bands  # noqa: E402
import probe_link_engine as j_probe  # noqa: E402

import lipsync_tpu.preprocessing.ingest as j_ingest  # noqa: E402
from lipsync_tpu.inference.engine import ScoringEngine as JEngine  # noqa: E402
from lipsync_tpu_torch.inference import engine as engine_mod  # noqa: E402
from lipsync_tpu_torch.preprocessing import ingest  # noqa: E402
from lipsync_tpu_torch.models import artifact as artifact_mod  # noqa: E402
from lipsync_tpu_torch import models as port_models  # noqa: E402
from lipsync_tpu_torch.preprocessing import audio as audio_mod  # noqa: E402
from lipsync_tpu_torch.preprocessing import video as video_mod  # noqa: E402
from lipsync_tpu_torch.tools import check_epoch  # noqa: E402
from lipsync_tpu_torch.tools import checking_threshold  # noqa: E402
from lipsync_tpu_torch.tools import debug_clips  # noqa: E402
from lipsync_tpu_torch.tools import diagnose_sync_signal  # noqa: E402
from lipsync_tpu_torch.tools import diagnose_videos  # noqa: E402
from lipsync_tpu_torch.tools import inspect_preprocessed_window  # noqa: E402
from lipsync_tpu_torch.tools import make_synthetic_dataset as gen  # noqa: E402
from lipsync_tpu_torch.tools import measure_articulation_bands  # noqa: E402
from lipsync_tpu_torch.tools import probe_link_engine  # noqa: E402
from lipsync_tpu_torch.utils import synthetic  # noqa: E402
from tests.torch_parity import seeded_pair  # noqa: E402

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def jax_call(fn, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def pre_dir(tmp_path_factory):
    """Eight preprocessed clips of 20 frames, as npy."""
    out = tmp_path_factory.mktemp("pre")
    return synthetic.write_corpus(out, n_clips=8, n_frames=20, crop_size=32,
                                  seed=6, device="cpu")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """One phoneme-style real clip of the generator, 2 s with audio."""
    out = tmp_path_factory.mktemp("clip")
    gen.main(["--output-dir", str(out), "--style", "phoneme",
              "--n-per-class", "1", "--seconds", "2.0", "--seed", "5"])
    return out / "0_real" / "real_0000.avi"


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two multi-face families: 2-face all_real/all_fake scenes, and the
    3-face mixed scene at articulation gain 0.6."""
    out = tmp_path_factory.mktemp("scenes")
    gen.main(["--output-dir", str(out / "two"), "--style", "multiface",
              "--n-per-class", "1", "--seconds", "2.0", "--seed", "8",
              "--scenes", "all_real,all_fake"])
    gen.main(["--output-dir", str(out / "three"), "--style", "multiface",
              "--n-per-class", "1", "--seconds", "2.0", "--seed", "9",
              "--scenes", "mixed", "--n-faces", "3",
              "--articulation-gain", "0.6"])
    return out


@pytest.fixture(autouse=True)
def one_decode(monkeypatch):
    """Both packages read video through the port's reader: the native RGB
    conversion leaves each frame's last ``w % 8`` columns unwritten, which
    the port zeroes and the JAX package leaves as the heap held them
    (:func:`test_decode_does_not_depend_on_the_heap`)."""
    monkeypatch.setattr(j_ingest, "read_video", ingest.read_video)


def _within(got, want, tol, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _within(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


# ── the preprocessed-data diagnostics (host only) ────────────────────────


@pytest.mark.parametrize("broken", [False, True], ids=["intact", "broken"])
def test_diagnose_sync_signal_matches_the_jax_script(tmp_path, pre_dir,
                                                     capsys, broken):
    """The same report and printed lines; a record the store cannot return
    is skipped by both."""
    d = pre_dir
    if broken:
        d = tmp_path / "pre"
        d.mkdir()
        for f in Path(pre_dir).iterdir():
            (d / f.name).symlink_to(f)
        (d / "clip_0002_audio.npy").unlink()
    argv = ["--preprocessed-dir", str(d), "--limit", "7"]
    got = diagnose_sync_signal.main([*argv, "--json-out",
                                     str(tmp_path / "p.json")])
    port_out = capsys.readouterr().out
    assert j_sync.main([*argv, "--json-out", str(tmp_path / "j.json")]) == 0
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert got["n_clips"] == (6 if broken else 7)
    assert ("skip clip_0002" in port_out) == broken


@pytest.mark.parametrize("index", [0, 5])
def test_inspect_preprocessed_window_matches_the_jax_script(tmp_path,
                                                            pre_dir, capsys,
                                                            index):
    argv = ["--preprocessed-dir", str(pre_dir), "--index", str(index)]
    got = inspect_preprocessed_window.main([*argv, "--out",
                                            str(tmp_path / "p.png")])
    port_out = capsys.readouterr().out.splitlines()
    want = j_inspect.main([*argv, "--out", str(tmp_path / "j.png")])
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == jax_out[0]
    assert port_out[0].startswith(f"sample {index}: label=")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [ln.replace("p.png", "j.png") for ln in port_out[1:]] == jax_out[1:]


def test_inspect_without_matplotlib_still_reads_the_window(
        tmp_path, pre_dir, capsys, monkeypatch):
    """Only the plotting is optional: without matplotlib the window is read
    and its stats printed, then the skip is said."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    sample = inspect_preprocessed_window.main(
        ["--preprocessed-dir", str(pre_dir), "--out",
         str(tmp_path / "w.png")])
    out = capsys.readouterr().out.splitlines()
    assert sample is not None and len(out) == 2
    assert out[0].startswith("sample 0: label=")
    assert out[1].startswith("(plotting skipped: ")
    assert not (tmp_path / "w.png").exists()


# ── debug_clips ──────────────────────────────────────────────────────────


def test_debug_clips_matches_the_jax_script(tmp_path, clip, capsys):
    """Real decode, the default Haar ladder, the crops and the log-mel."""
    argv = ["--video", str(clip)]
    got = debug_clips.main([*argv, "--out", str(tmp_path / "p.png"), *CPU])
    port_out = capsys.readouterr().out.splitlines()
    want = jax_call(j_debug.main, [*argv, "--out", str(tmp_path / "j.png")])
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == jax_out[0]
    assert port_out[0].startswith("alignment_score: ")
    np.testing.assert_allclose(got["motion"], want["motion"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["audio_energy"], want["audio_energy"],
                               atol=1e-3, rtol=0)
    assert abs(got["alignment_score"] - want["alignment_score"]) <= 1e-4
    _within(got["mouth_check"], want["mouth_check"], 1e-4)
    assert len(port_out) == len(jax_out)


def test_debug_clips_without_matplotlib_prints_the_numbers(
        tmp_path, clip, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    debug_clips.main(["--video", str(clip), "--out", str(tmp_path / "d.png"),
                      *CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("alignment_score: ")
    assert out[1].startswith("mouth_check:     {")
    assert out[2].startswith("(plotting skipped: ")


# ── measure_articulation_bands ───────────────────────────────────────────


def test_measure_articulation_bands_matches_the_jax_script(
        tmp_path, scenes, capsys, monkeypatch):
    """Real decode, the default Haar ladder and the tracker on both sides;
    the ratios come from each package's crops: each within 1e-4, and the
    report's (rounded to four places) within one step of that rounding."""
    ratios = {"port": [], "jax": []}
    for module, key in ((measure_articulation_bands, "port"),
                        (j_bands, "jax")):
        def recorded(crops, real=module.articulation_ratio, key=key):
            r = real(crops)
            ratios[key].append(r)
            return r
        monkeypatch.setattr(module, "articulation_ratio", recorded)
    argv = ["--data-dir", f"two={scenes / 'two'}",
            "--data-dir", f"three={scenes / 'three'}"]
    assert measure_articulation_bands.main(
        [*argv, "--out", str(tmp_path / "p.json"), *CPU]) == 0
    capsys.readouterr()
    assert j_bands.main([*argv, "--out", str(tmp_path / "j.json")]) == 0
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert got["families"]["two"]["clips"] == 2
    assert got["families"]["three"]["speaker_band"] is not None
    assert len(ratios["port"]) == len(ratios["jax"]) == 7
    np.testing.assert_allclose(ratios["port"], ratios["jax"], atol=1e-4,
                               rtol=0)
    _within(got, want, 1e-4 * (1 + 1e-9))


# ── probe_link_engine ────────────────────────────────────────────────────


def test_probe_link_engine_matches_the_jax_script(monkeypatch, capsys):
    """Both probes at the narrow width on the same seeded weights: the
    engines' logits on the same payload within 1e-4, and the same printed
    lines, the times aside."""
    _, cfg, variables, jcfg = seeded_pair(
        0, video_frames=8, crop_size=32, audio_frames=32)
    logits = {"port": [], "jax": []}

    def recorded(engine, key):
        real = engine.score_logits

        def score_logits(v, a):
            out = real(v, a)
            logits[key].append(np.asarray(out))
            return out
        engine.score_logits = score_logits
        return engine

    class Initialised:
        def __init__(self, cfg, dtype=None):
            pass

        def init(self, *args):
            return {}

    port_engine = engine_mod.ScoringEngine
    monkeypatch.setattr(port_models, "ModelConfig", lambda: cfg)
    monkeypatch.setattr(
        engine_mod, "ScoringEngine",
        lambda state, c, max_batch, device: recorded(
            port_engine(state, c, max_batch=max_batch, device=device),
            "port"))
    monkeypatch.setattr(j_probe, "ModelConfig", lambda: jcfg)
    monkeypatch.setattr(j_probe, "LipSyncModel", Initialised)
    monkeypatch.setattr(
        j_probe, "ScoringEngine",
        lambda v, c, max_batch: recorded(
            JEngine(variables, jcfg, use_bfloat16=False, max_batch=max_batch),
            "jax"))
    argv = ["--batch", "4", "--groups", "2", "--iters", "2"]
    got = probe_link_engine.main([*argv, *CPU])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["probe_link_engine", *argv])
    jax_call(j_probe.main)
    jax_out = capsys.readouterr().out.splitlines()
    assert len(logits["port"]) == len(logits["jax"]) == 3
    for p, j in zip(logits["port"], logits["jax"]):
        np.testing.assert_allclose(p, j, atol=1e-4, rtol=0)
    times = re.compile(r"\s*[0-9.]+")
    assert [times.sub("#", ln) for ln in port_out] == [
        times.sub("#", ln) for ln in jax_out]
    assert len(got["iters"]) == 2
    assert all(it["link_mb_per_s"] > 0 and it["engine_windows_per_s"] > 0
               for it in got["iters"])


# ── the host-only tools ──────────────────────────────────────────────────


def test_diagnose_videos_matches_the_jax_script(tmp_path, clip, capsys):
    """A readable clip, a file that is not a video, and a link to a file
    that is gone: the same report for each, printed the same."""
    d = tmp_path / "videos"
    d.mkdir()
    (d / "good.avi").symlink_to(clip)
    (d / "garbage.mp4").write_bytes(b"\x00not a video" * 10)
    (d / "missing.mov").symlink_to(tmp_path / "gone.mov")
    got = diagnose_videos.main(["--data-dir", str(d)])
    port_out = capsys.readouterr().out
    want = j_videos.main(["--data-dir", str(d)])
    assert port_out == capsys.readouterr().out
    assert got == want
    by_name = {Path(r["path"]).name: r for r in got}
    assert by_name["good.avi"]["decode"].startswith("ok (16 frames")
    assert by_name["good.avi"]["audio"].startswith("ok (")
    assert by_name["garbage.mp4"]["decode"].startswith("FAILED")
    assert by_name["missing.mov"]["decode"].startswith("FAILED")


def test_decode_does_not_depend_on_the_heap(tmp_path, clip):
    """The generator's 180-pixel frames leave 4 columns that the native
    RGB conversion never writes: the port's reader returns them as zeros,
    whatever the heap held before the read."""
    frames = synthetic.synthetic_frames(n=6, h=48, w=180, seed=2)
    frames[..., -8:, :] = 200
    path = tmp_path / "edge.avi"
    from lipsync_tpu_torch.preprocessing.mux import write_video

    write_video(path, frames, 15.0)
    reads = []
    for seed in range(3):
        junk = [np.random.RandomState(seed).bytes(1 << k)
                for k in range(10, 22)]
        del junk
        reads.append(ingest.read_video(path, 15.0))
        reads.append(ingest.read_video(clip, 15.0))
    for a, b in zip(reads[2:], reads[:-2]):
        np.testing.assert_array_equal(a, b)
    assert not reads[0][..., -4:, :].any()
    assert reads[0][..., -8:-4, :].min() > 150


def test_check_epoch_matches_the_jax_script(tmp_path, capsys):
    ckpt = tmp_path / "best_model_accuracy"
    ckpt.mkdir()
    (ckpt / "metadata.json").write_text(json.dumps(
        {"epoch": 7, "phase": 2, "metrics": {"val_acc": 0.81},
         "model_config": {"video_frames": 32}}))
    argv = [str(ckpt), str(tmp_path / "none")]
    assert check_epoch.main(argv) == 0
    port_out = capsys.readouterr().out
    assert j_check.main(argv) == 0
    assert port_out == capsys.readouterr().out
    assert '"epoch": 7' in port_out and "(no metadata)" in port_out


def test_checking_threshold_matches_the_jax_script(tmp_path, capsys):
    rng = np.random.RandomState(3)
    path = tmp_path / "predictions.csv"
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "true_label", "verdict",
                                          "confidence"])
        w.writeheader()
        for i in range(40):
            label = int(rng.rand() < 0.5)
            conf = float(np.clip(rng.normal(0.35 + 0.3 * label, 0.2), 0, 1))
            w.writerow({"path": f"c{i}.avi", "true_label": label,
                        "verdict": "real" if conf >= 0.5 else "fake",
                        "confidence": f"{conf:.6f}"})
        w.writerow({"path": "bad.avi", "true_label": 1, "verdict": "error",
                    "confidence": "0.5"})
    got = checking_threshold.main([str(path)])
    port_out = capsys.readouterr().out
    want = j_thresh.main([str(path)])
    assert port_out == capsys.readouterr().out
    assert got == want and len(got) == 19
    assert sum(got[0][k] for k in ("tp", "fp", "tn", "fn")) == 40


# ── a failing kernel or crop ends the run ────────────────────────────────


def _failing_k1(y, *args, **kwargs):
    raise RuntimeError("log_mel kernel launch failed: cudaError 700")


def _failing_k2(*args, **kwargs):
    raise RuntimeError("hf_stem kernel launch failed: cudaError 98")


def _failing_crop(*args, **kwargs):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_debug_clips_ends_on_a_failing_k1(tmp_path, clip, monkeypatch):
    monkeypatch.setattr(audio_mod, "log_mel_spectrogram_fused", _failing_k1)
    with pytest.raises(RuntimeError, match="log_mel kernel"):
        debug_clips.main(["--video", str(clip), "--out",
                          str(tmp_path / "d.png"), *CPU])


def test_debug_clips_ends_on_a_failing_crop(tmp_path, clip, monkeypatch):
    monkeypatch.setattr(video_mod, "crop_track_on_device", _failing_crop)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        debug_clips.main(["--video", str(clip), "--out",
                          str(tmp_path / "d.png"), *CPU])


def test_measure_articulation_bands_ends_on_a_failing_crop(
        scenes, monkeypatch):
    monkeypatch.setattr(video_mod, "crop_track_on_device", _failing_crop)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        measure_articulation_bands.main(
            ["--data-dir", f"two={scenes / 'two'}", "--limit", "1", *CPU])


def test_probe_link_engine_ends_on_a_failing_k2(monkeypatch):
    cfg = seeded_pair(0, video_frames=8, crop_size=32, audio_frames=32)[1]
    monkeypatch.setattr(port_models, "ModelConfig", lambda: cfg)
    monkeypatch.setattr(artifact_mod, "hf_stem", _failing_k2)
    with pytest.raises(RuntimeError, match="hf_stem kernel"):
        probe_link_engine.main(["--batch", "2", "--groups", "1", *CPU])


# ── the device: cuda:0 unless asked ──────────────────────────────────────


@pytest.mark.parametrize("tool", ["debug_clips", "measure_articulation_bands",
                                  "probe_link_engine"])
def test_device_tools_ask_for_cuda(monkeypatch, clip, scenes, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if tool == "debug_clips":
            debug_clips.main(["--video", str(clip)])
        elif tool == "measure_articulation_bands":
            measure_articulation_bands.main(
                ["--data-dir", f"two={scenes / 'two'}", "--limit", "1"])
        else:
            probe_link_engine.main([])
