"""End-to-end synthetic evaluation through the production pipeline.

    python -m lipsync_tpu_torch.tools.run_synthetic_eval --work-dir /tmp/synth \
        [--n-train 300 --n-calib 60 --n-test 100 --epochs 60]

The port's counterpart of the JAX package's ``scripts/run_synthetic_eval.py``,
with its flags, stages and ``summary.json``; each stage is the port's own
entry point, run as a subprocess:

  generate (``tools.make_synthetic_dataset``: jitter + hard negatives, three
  disjoint splits, seeds 1 / 7 / 13) -> precompute
  (``tools.precompute_training_tensors``: zarr, full_sequence) and
  ``tools.validate_preprocessed`` -> train (``training.train``: phased
  optimizers) -> fit a Platt calibrator on the held-out split
  (``tools.fit_calibrator``) -> ``tools.validate_pipeline`` on the test
  split, calibrated -> ``metrics.json``.

Faces are randomized per clip in position, scale, skin and lip colour and
noise, so the classifier cannot use pixel idiosyncrasies; half the fakes
use the same audio envelope shifted 0.25-0.8 s (correlated but misaligned
lip sync, the audio-swap manipulation). ``--device`` (cuda:0 by default)
goes to every stage that has device work.

Writes ``<work-dir>/summary.json`` and leaves the evaluation's outputs
(``metrics.json``, the plots where matplotlib imports,
``high_confidence_errors.csv``) in ``<work-dir>/eval_out``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.tools.common import add_device_argument

REPO = Path(__file__).resolve().parents[2]
TOOLS = "lipsync_tpu_torch.tools"


def run(cmd: list, log: Path, fatal: bool = True) -> str:
    """Run a stage, teeing output to a log file; raise on failure."""
    print(f"[run_synthetic_eval] $ {' '.join(map(str, cmd))}", flush=True)
    t0 = time.time()
    proc = subprocess.run(
        [str(c) for c in cmd], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text(proc.stdout)
    print(f"[run_synthetic_eval]   -> rc={proc.returncode} "
          f"({time.time() - t0:.0f}s), log: {log}", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], flush=True)
        if fatal:
            raise SystemExit(f"stage failed: {cmd[0]} (see {log})")
    return proc.stdout


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work-dir", type=Path, default=Path("/tmp/synth_r2"))
    p.add_argument("--n-train", type=int, default=300)
    p.add_argument("--n-calib", type=int, default=60)
    p.add_argument("--n-test", type=int, default=100)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--skip-generate", action="store_true")
    p.add_argument("--skip-precompute", action="store_true")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--phase3-start-epoch", type=int, default=None,
                   help="unfreeze everything at this epoch (reference "
                        "default 15 assumes 50K-clip epochs; small synthetic "
                        "runs want 0)")
    p.add_argument("--lr-encoder", type=float, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--device-augment", action="store_true",
                   help="augment on the device inside the train step "
                        "(uint8 host transfers)")
    p.add_argument("--style", choices=("envelope", "phoneme"),
                   default="envelope",
                   help="synthetic articulation style (phoneme = "
                        "vowel-shaped mouths + formant audio)")
    p.add_argument("--no-hard-negatives", action="store_true",
                   help="fakes all use independent envelopes (middle "
                        "difficulty: cross-clip sync learning without the "
                        "time-shifted same-envelope negatives)")
    p.add_argument("--no-jitter", action="store_true")
    p.add_argument("--device-cache", action="store_true",
                   help="cache the whole corpus in device memory and "
                        "gather windows there (training/device_cache.py)")
    add_device_argument(p)
    args = p.parse_args(argv)

    w = args.work_dir
    logs = w / "logs"
    py = sys.executable
    dev = ["--device", args.device]

    # ── 1. generate three disjoint splits ────────────────────────────────
    if not args.skip_generate:
        for split, n, seed in (("train", args.n_train, 1),
                               ("calib", args.n_calib, 7),
                               ("test", args.n_test, 13)):
            cmd = [py, "-m", f"{TOOLS}.make_synthetic_dataset",
                   "--output-dir", w / f"raw_{split}", "--n-per-class", n,
                   "--seconds", args.seconds, "--seed", seed,
                   "--style", args.style]
            if not args.no_jitter:
                cmd.append("--jitter")
            if not args.no_hard_negatives:
                cmd.append("--hard-negatives")
            run(cmd, logs / f"gen_{split}.log")

    # ── 2. precompute (zarr, full_sequence) ──────────────────────────────
    if not args.skip_precompute:
        for split in ("train", "calib", "test"):
            run([py, "-m", f"{TOOLS}.precompute_training_tensors",
                 "--data-dir", w / f"raw_{split}",
                 "--output-dir", w / f"pre_{split}",
                 "--mode", "full_sequence", "--storage-format", "zarr",
                 *dev],
                logs / f"pre_{split}.log")
            # Non-fatal: a handful of clips may yield too-short face
            # tracks under jitter; the training loader skips them.
            run([py, "-m", f"{TOOLS}.validate_preprocessed",
                 "--preprocessed-dir", w / f"pre_{split}"],
                logs / f"valpre_{split}.log", fatal=False)

    # ── 3. train ─────────────────────────────────────────────────────────
    weights = w / "weights"
    if not args.skip_train:
        cmd = [py, "-m", "lipsync_tpu_torch.training.train",
               "--preprocessed-dir", w / "pre_train",
               "--output-dir", weights,
               "--epochs", args.epochs, "--batch-size", args.batch_size,
               "--early-stopping-patience", 15]
        if args.phase3_start_epoch is not None:
            cmd += ["--phase2-start-epoch",
                    min(args.phase3_start_epoch, 5),
                    "--phase3-start-epoch", args.phase3_start_epoch]
        if args.lr_encoder is not None:
            cmd += ["--lr-encoder", args.lr_encoder]
        if args.lr is not None:
            cmd += ["--lr", args.lr]
        if args.device_augment:
            cmd.append("--device-augment")
        if args.device_cache:
            cmd.append("--device-cache")
        run(cmd + dev, logs / "train.log")
    best = weights / "best_model_accuracy"

    # ── 4. calibrate on the held-out calib split ─────────────────────────
    cal_out = run([py, "-m", f"{TOOLS}.fit_calibrator",
                   "--preprocessed-dir", w / "pre_calib",
                   "--model-path", best, "--method", "platt", *dev],
                  logs / "calibrate.log")
    pa = float(re.search(r"calibration_platt_a:\s*([-\d.]+)", cal_out)[1])
    pb = float(re.search(r"calibration_platt_b:\s*([-\d.]+)", cal_out)[1])

    # ── 5. evaluate the disjoint test split, calibrated ──────────────────
    run([py, "-m", f"{TOOLS}.validate_pipeline",
         "--preprocessed-dir", w / "pre_test", "--model-path", best,
         "--output-dir", w / "eval_out",
         "--calibration-method", "platt",
         "--calibration-platt-a", pa, "--calibration-platt-b", pb, *dev],
        logs / "eval.log")

    metrics = json.loads((w / "eval_out" / "metrics.json").read_text())
    summary = {
        "dataset": {
            "train_clips": 2 * args.n_train,
            "calib_clips": 2 * args.n_calib,
            "test_clips": 2 * args.n_test,
            "jitter": not args.no_jitter,
            "hard_negatives": not args.no_hard_negatives,
            "storage": "zarr/full_sequence",
        },
        "calibration": {"method": "platt", "a": pa, "b": pb},
        "test_metrics": metrics,
    }
    (w / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
