#!/usr/bin/env python3
"""Strict-venv finetune runner.

    python -m lipsync_tpu_torch.tools.run_finetune_strict_venv

The port's counterpart of the JAX package's script
``run_finetune_strict_venv``, with its checks, messages and pinned
configuration. It refuses to run outside the repo-local ``./venv``
interpreter (re-exec'ing itself into it when invoked from another Python),
validates the pinned data/checkpoint paths, then runs ONE fixed finetune
configuration of ``lipsync_tpu_torch.training.finetune`` (cuda:0) — the
reproducible "blessed" finetune recipe, as opposed to the env-overridable
``lipsync_tpu_torch/tools/run_finetune.sh`` wrapper.

Pinned configuration (the reference's launcher -> the port's CLI):
  --epochs 36 --freeze-epochs 8 --batch-size 8    -> same (``--frozen-epochs``)
  --lr 2e-4 --lr-encoder 2e-5                     -> ``--lr-head 2e-4 --lr-encoder 2e-5``
  --contrastive-weight 0.1                        -> LossConfig default
  --use-augmentation                              -> augmentation is default-on
  --early-stopping-patience 8 / --log-every 5     -> finetune logs every epoch and
                                                     keeps best-F1/best-acc
                                                     checkpoints instead of
                                                     stopping early
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

INTERNAL_FLAG = "--__inside-venv"
MODULE = "lipsync_tpu_torch.tools.run_finetune_strict_venv"


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    repo_root = Path(__file__).resolve().parents[2]
    venv_python = repo_root / "venv" / "bin" / "python"

    if not venv_python.is_file():
        print("ERROR: venv Python not found.")
        print(f"Expected: {venv_python}")
        print("Create it first (torch must be importable; on a")
        print("machine with the stack preinstalled, --system-site-packages")
        print("inherits it without any pip install):")
        print(f"  cd {repo_root}")
        print("  python3 -m venv --system-site-packages venv")
        return 1

    # Re-launch under the venv interpreter if we aren't already in it.
    if INTERNAL_FLAG not in argv:
        current_python = Path(sys.executable).resolve()
        if current_python != venv_python.resolve():
            os.chdir(repo_root)
            os.execv(
                str(venv_python),
                [str(venv_python), "-m", MODULE, INTERNAL_FLAG],
            )

    data_dir = repo_root / "data" / "AVLips12"
    pretrained = repo_root / "weights" / "best_model_accuracy"

    if not data_dir.is_dir():
        print(f"ERROR: data directory not found: {data_dir}")
        return 1
    if not pretrained.exists():
        print(f"ERROR: pretrained checkpoint not found: {pretrained}")
        return 1

    os.chdir(repo_root)

    cmd = [
        str(venv_python),
        "-m",
        "lipsync_tpu_torch.training.finetune",
        "--data-dir",
        "data/AVLips12",
        "--checkpoint",
        "weights/best_model_accuracy",
        "--epochs",
        "36",
        "--frozen-epochs",
        "8",
        "--batch-size",
        "8",
        "--lr-head",
        "2e-4",
        "--lr-encoder",
        "2e-5",
    ]

    print("=" * 70)
    print("Running strict-venv finetune command")
    print(f"Repo root: {repo_root}")
    print(f"Python: {venv_python}")
    print("Command:")
    print(" ".join(cmd))
    print("=" * 70)

    result = subprocess.run(cmd, env=os.environ.copy())
    return result.returncode


if __name__ == "__main__":
    raise SystemExit(main())
