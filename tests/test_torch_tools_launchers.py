"""The port's launchers against the JAX package's, on the CPU: the nine
shell launchers of ``lipsync_tpu_torch/tools/`` and
``run_finetune_strict_venv``, each beside the script of the same name in
``scripts/``; and ``scripts/merge_preprocessed_dirs.py`` (which imports
neither package and both sets of launchers call) on the port's precompute
output.

Each launcher runs twice, the JAX package's and the port's, with the same
tiny environment, under a recording ``python`` first on ``PATH``: a shell shim
that logs its arguments (and the program that ``python -`` reads), writes
the files a later step reads back (``cat`` of a metrics or forgetting
JSON), prints the Platt lines that ``fit_calibrator`` prints, and exits 0.
The two command sequences must be equal once ``scripts/X.py`` reads
``-m lipsync_tpu_torch.tools.X`` and ``lipsync_tpu.`` reads
``lipsync_tpu_torch.``; the in-line programs may differ only by those
names and the JAX one's ``sys.path`` entry for ``scripts/``. Each runs as
a copy of the launcher tree with the literal ``/tmp/`` of its defaults
moved under the run's own directory (the launchers write there; the copy
is otherwise byte-equal), and every other root is an environment knob.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
TOOLS = ROOT / "lipsync_tpu_torch" / "tools"

# The recording ``python``: one line per call (``CALL`` and the arguments,
# separated by \x1f), then for ``python -`` a line with the knobs that the
# in-line program reads and its text in base64.
SHIM = r'''#!/bin/bash
{ printf 'CALL'; for a in "$@"; do printf '\x1f%s' "$a"; done; echo; } \
  >> "$SHIM_LOG"
if [ "$1" = "-" ]; then
  { printf 'STDIN'
    for k in WA WF PA PB OUT SUFFIX MF_DIR MF_EXTRA; do
      printf '\x1f%s=%s' "$k" "${!k-<unset>}"; done
    printf '\x1f'; base64 -w0; echo; } >> "$SHIM_LOG"
fi
case "$*" in *fit_calibrator*)
  echo "calibration_platt_a: 0.5"; echo "calibration_platt_b: 0.1";; esac
prev=
for a in "$@"; do
  case "$*:$prev" in
    *eval_unseen_fakes*:--output)
      mkdir -p "$(dirname "$a")"; echo '{}' > "$a";;
    *validate_pipeline*:--output-dir)
      mkdir -p "$a"; echo '{}' > "$a/metrics.json";;
  esac
  prev=$a
done
'''


def _read_log(log: Path):
    import base64

    calls = []
    for line in log.read_text().splitlines():
        kind, *fields = line.split("\x1f")
        if kind == "CALL":
            calls.append({"argv": fields})
        else:
            *env, text = fields
            calls[-1]["stdin"] = base64.b64decode(text).decode()
            calls[-1]["env"] = {
                k: None if v == "<unset>" else v
                for k, v in (e.split("=", 1) for e in env)}
    return calls


def _tiny_env(name: str, r: str) -> dict:
    """The launcher's knobs at tiny sizes, every root under ``r``."""
    return {
        "run_finetune": {"PREPROCESSED_DIR": f"{r}/pre", "EPOCHS": "1"},
        "quick_finetune": {"DATA_DIR": f"{r}/data"},
        "run_finetune_jenkins": {
            "WORKSPACE": f"{r}/ws", "DATA_DIR": f"{r}/data",
            "EVAL_DATA_DIR": f"{r}/eval", "EPOCHS": "1",
            "CHECKPOINT": f"{r}/w/best_model_accuracy"},
        "smoke_interference": {
            "S": f"{r}/smoke", "NPC_TRAIN": "4", "NPC_CALIB": "2",
            "EPOCHS": "1", "MF_PER_KIND": "1", "UNSEEN_NPC": "2"},
        "train_interference_r4": {
            "NPC": "2", "NPC_CAL": "2", "EPOCHS": "1", "T": f"{r}/intf",
            "W0": f"{r}/w/best_model_accuracy", "OUT": f"{r}/out",
            "SUFFIX": "_t", "CAL0": f"{r}/cal0", "MF_DIR": f"{r}/mf",
            "UNSEEN_DIR": f"{r}/unseen"},
        "regen_r4": {"NPC_TRAIN": "2", "NPC_CALIB": "2", "EPOCHS": "1",
                     "MF_PER_KIND": "1", "UNSEEN_NPC": "2",
                     "W": f"{r}/w", "OUT": f"{r}/out"},
        "adapt_unseen_r4": {"NPC_ADAPT": "2", "NPC_ACAL": "2",
                            "EPOCHS": "1", "A": f"{r}/adapt",
                            "W0": f"{r}/w/best_model_accuracy",
                            "OUT": f"{r}/out/adapted.json"},
        "train_union_flagship": {"NPC_PH": "9", "NPC_INTF": "2",
                                 "NPC_ENV": "2", "EPOCHS": "1",
                                 "U": f"{r}/union", "OUT": f"{r}/out",
                                 "MF_EXTRA": f"{r}/mf_fresh"},
        "train_union_flagship_data_only": {"U": f"{r}/union",
                                           "DATA_ONLY": "1"},
        "datagen_r5": {},
    }[name]


CASES = ["run_finetune", "quick_finetune", "run_finetune_jenkins",
         "smoke_interference", "train_interference_r4", "regen_r4",
         "adapt_unseen_r4", "train_union_flagship",
         "train_union_flagship_data_only", "datagen_r5"]


def _run_launcher(tmp: Path, side: str, case: str, extra=None):
    """Runs the JAX (``side="jax"``) or port launcher of ``case`` from a
    copy of its tree; returns the recorded calls and the output."""
    run = tmp / side
    if side == "jax":
        tree = run / "repo" / "scripts"
        sources = SCRIPTS.glob("*.sh")
    else:
        tree = run / "repo" / "lipsync_tpu_torch" / "tools"
        sources = TOOLS.glob("*.sh")
    tree.mkdir(parents=True)
    (run / "tmp").mkdir()
    for src in sources:
        dst = tree / src.name
        dst.write_text(src.read_text().replace("/tmp/", f"{run}/tmp/"))
        dst.chmod(0o755)
    bin_dir = run / "bin"
    bin_dir.mkdir()
    shim = bin_dir / "python"
    shim.write_text(SHIM)
    shim.chmod(0o755)
    log = run / "calls.jsonl"
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}",
           "SHIM_LOG": str(log), **_tiny_env(case, str(run)),
           **(extra or {})}
    name = case.removesuffix("_data_only")
    proc = subprocess.run(["bash", str(tree / f"{name}.sh")], env=env,
                          capture_output=True, text=True, timeout=60)
    calls = _read_log(log) if log.exists() else []
    return proc, _normalized(calls, str(run), side)


def _normalized(calls, run: str, side: str):
    """Each call with its run's root as ``<R>``; the JAX side's script
    paths and module names as the port's."""
    out = []
    for c in calls:
        argv = [a.replace(run, "<R>") for a in c["argv"]]
        if side == "jax":
            if argv and re.fullmatch(r"scripts/\w+\.py", argv[0]):
                stem = Path(argv[0]).stem
                if stem != "merge_preprocessed_dirs":
                    argv = ["-m", f"lipsync_tpu_torch.tools.{stem}",
                            *argv[1:]]
            argv = [a.replace("lipsync_tpu.", "lipsync_tpu_torch.")
                    for a in argv]
        rec = {"argv": argv}
        if "stdin" in c:
            text = c["stdin"].replace(run, "<R>")
            if side == "jax":
                text = text.replace('sys.path.insert(0, "scripts")\n', "")
                text = text.replace(
                    "import eval_multiface",
                    "from lipsync_tpu_torch.tools import eval_multiface")
                text = text.replace("lipsync_tpu.", "lipsync_tpu_torch.")
            rec["stdin"] = text
            rec["env"] = {k: None if v is None else v.replace(run, "<R>")
                          for k, v in c["env"].items()}
        out.append(rec)
    return out


@pytest.mark.parametrize("case", CASES)
def test_launcher_runs_the_jax_command_sequence(tmp_path, case):
    j_proc, j_calls = _run_launcher(tmp_path, "jax", case)
    p_proc, p_calls = _run_launcher(tmp_path, "port", case)
    assert j_proc.returncode == 0, j_proc.stderr
    assert p_proc.returncode == 0, p_proc.stderr
    assert p_calls, "the port's launcher ran nothing"
    assert p_calls == j_calls
    ran = " ".join(" ".join(c["argv"]) + c.get("stdin", "")
                   for c in p_calls)
    assert not re.search(r"\blipsync_tpu\.", ran)


def test_the_launchers_chain_the_port(tmp_path):
    """smoke_interference drives train_interference_r4 (train with the
    device cache, finetune, merge, fit_calibrator, eval_multiface,
    eval_unseen_fakes, the in-line replay), all of the port."""
    _, calls = _run_launcher(tmp_path, "port", "smoke_interference")
    modules = [c["argv"][1] for c in calls if c["argv"][0] == "-m"]
    for name in ("training.train", "training.finetune",
                 "tools.fit_calibrator", "tools.eval_multiface",
                 "tools.eval_unseen_fakes",
                 "tools.precompute_training_tensors",
                 "tools.make_synthetic_dataset"):
        assert f"lipsync_tpu_torch.{name}" in modules, name
    train = next(c["argv"] for c in calls
                 if c["argv"][:2] == ["-m", "lipsync_tpu_torch.training.train"])
    assert "--device-cache" in train
    assert any(c["argv"][0] == "scripts/merge_preprocessed_dirs.py"
               for c in calls)
    replay = [c for c in calls if "stdin" in c]
    assert len(replay) == 1
    assert "from lipsync_tpu_torch.tools import eval_multiface" in (
        replay[0]["stdin"])
    assert "scripts" not in replay[0]["stdin"]
    assert replay[0]["env"]["PA"] == "0.5" and replay[0]["env"]["PB"] == "0.1"


def test_smoke_sizes_the_adaptation_recipe(tmp_path):
    """The port's smoke launcher passes its ``INTF_*`` knobs (the JAX one
    pins 20 / 8 clips and 3 epochs, which stay the defaults) on to
    ``train_interference_r4.sh``."""
    _, calls = _run_launcher(tmp_path, "port", "smoke_interference",
                             {"INTF_NPC": "3", "INTF_NPC_CAL": "2",
                              "INTF_EPOCHS": "1"})
    raw = next(c["argv"] for c in calls if "<R>/smoke/intf/raw" in c["argv"])
    assert raw[raw.index("--n-per-class") + 1] == "3"
    rawcal = next(c["argv"] for c in calls
                  if "<R>/smoke/intf/rawcal" in c["argv"])
    assert rawcal[rawcal.index("--n-per-class") + 1] == "2"
    ft = next(c["argv"] for c in calls
              if c["argv"][:2] == ["-m", "lipsync_tpu_torch.training.finetune"])
    assert ft[ft.index("--epochs") + 1] == "1"


# ── run_finetune_strict_venv ──────────────────────────────────────────────

sys.path.insert(0, str(SCRIPTS))
import run_finetune_strict_venv as j_strict  # noqa: E402

from lipsync_tpu_torch.tools import run_finetune_strict_venv as strict  # noqa: E402


def _repo(tmp_path: Path, side: str, venv=False, data=False) -> Path:
    """A scratch repo root for ``side`` with the launcher's module path
    under it; optionally a venv interpreter, the data and the weights."""
    root = tmp_path / side
    (root / "scripts").mkdir(parents=True)
    (root / "lipsync_tpu_torch" / "tools").mkdir(parents=True)
    if venv:
        py = root / "venv" / "bin" / "python"
        py.parent.mkdir(parents=True)
        py.write_text("#!/bin/sh\n")
        py.chmod(0o755)
    if data:
        (root / "data" / "AVLips12").mkdir(parents=True)
        (root / "weights").mkdir()
        (root / "weights" / "best_model_accuracy").write_text("ckpt")
    return root


def _run_strict(monkeypatch, capsys, tmp_path, side, argv, **kw):
    root = _repo(tmp_path, side, **kw)
    calls = {"execv": [], "run": []}
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "execv",
                        lambda path, args: calls["execv"].append(list(args)))
    monkeypatch.setattr(
        subprocess, "run",
        lambda cmd, **k: calls["run"].append(list(cmd))
        or subprocess.CompletedProcess(cmd, 0))
    if side == "jax":
        monkeypatch.setattr(
            j_strict, "__file__",
            str(root / "scripts" / "run_finetune_strict_venv.py"))
        monkeypatch.setattr(sys, "argv", ["run_finetune_strict_venv.py",
                                          *argv])
        rc = j_strict.main()
    else:
        monkeypatch.setattr(
            strict, "__file__",
            str(root / "lipsync_tpu_torch" / "tools"
                / "run_finetune_strict_venv.py"))
        rc = strict.main(argv)
    out = capsys.readouterr().out.replace(str(root), "<ROOT>")
    calls = {k: [[a.replace(str(root), "<ROOT>") for a in c] for c in v]
             for k, v in calls.items()}
    return rc, out, calls


@pytest.mark.parametrize("branch", ["missing_venv", "missing_data"])
def test_strict_venv_refuses_as_the_jax_script(monkeypatch, capsys,
                                               tmp_path, branch):
    kw = {"venv": branch == "missing_data"}
    argv = [strict.INTERNAL_FLAG] if branch == "missing_data" else []
    j_rc, j_out, _ = _run_strict(monkeypatch, capsys, tmp_path, "jax",
                                 argv, **kw)
    p_rc, p_out, p_calls = _run_strict(monkeypatch, capsys, tmp_path,
                                       "port", argv, **kw)
    assert j_rc == p_rc == 1
    assert p_out == j_out.replace("jax/flax/optax/orbax", "torch")
    assert p_calls == {"execv": [], "run": []}


def test_strict_venv_runs_the_pinned_finetune(monkeypatch, capsys, tmp_path):
    _, j_out, j_calls = _run_strict(monkeypatch, capsys, tmp_path, "jax",
                                    [], venv=True, data=True)
    rc, p_out, p_calls = _run_strict(monkeypatch, capsys, tmp_path, "port",
                                     [], venv=True, data=True)
    assert rc == 0
    venv = "<ROOT>/venv/bin/python"
    assert j_calls["execv"] == [[venv, "<ROOT>/scripts/"
                                 "run_finetune_strict_venv.py",
                                 j_strict.INTERNAL_FLAG]]
    assert p_calls["execv"] == [[venv, "-m", strict.MODULE,
                                 strict.INTERNAL_FLAG]]
    want = [[a.replace("lipsync_tpu.", "lipsync_tpu_torch.") for a in c]
            for c in j_calls["run"]]
    assert p_calls["run"] == want
    assert p_calls["run"][0][1:3] == ["-m",
                                      "lipsync_tpu_torch.training.finetune"]
    assert p_out == j_out.replace("lipsync_tpu.", "lipsync_tpu_torch.")


def test_strict_venv_flags_are_the_port_finetunes(tmp_path):
    """The pinned flags parse with the port's finetune."""
    from lipsync_tpu_torch.training import finetune

    args = finetune.build_argparser().parse_args([
        "--data-dir", "data/AVLips12", "--checkpoint",
        "weights/best_model_accuracy", "--epochs", "36", "--frozen-epochs",
        "8", "--batch-size", "8", "--lr-head", "2e-4", "--lr-encoder",
        "2e-5"])
    assert (args.epochs, args.frozen_epochs, args.batch_size) == (36, 8, 8)


# ── merge_preprocessed_dirs on the port's precompute output ──────────────

def test_merge_reads_back_through_the_port_dataset(tmp_path):
    from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
    from lipsync_tpu_torch.tools import precompute_training_tensors as pre
    from lipsync_tpu_torch.training.data import LipSyncDataset

    counts = []
    for i, seed in enumerate((3, 4)):
        raw, out = tmp_path / f"raw{i}", tmp_path / f"pre{i}"
        gen.main(["--output-dir", str(raw), "--n-per-class", str(1 + i),
                  "--seconds", "2.0", "--seed", str(seed)])
        got = pre.main(["--data-dir", str(raw), "--output-dir", str(out),
                        "--mode", "full_sequence", "--no-face-detection",
                        "--storage-format", "zarr", "--device", "cpu"])
        assert got["failed"] == 0
        counts.append(len(LipSyncDataset(preprocessed_dir=out)._manifest))
    merged = tmp_path / "merged"
    proc = subprocess.run(
        [sys.executable, str(SCRIPTS / "merge_preprocessed_dirs.py"),
         str(tmp_path / "pre0"), str(tmp_path / "pre1"), "--out",
         str(merged)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    ds = LipSyncDataset(preprocessed_dir=merged)
    assert counts == [2, 4]
    assert len(ds._manifest) == sum(counts)
    for rec in ds._manifest:
        visual, mel = ds._load_tensors(rec)[:2]
        assert visual.ndim == 4 and mel.shape[0] == 80
