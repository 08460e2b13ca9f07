"""Cross-tier transfer matrix: score one model on several test tiers.

    python -m lipsync_tpu_torch.tools.eval_cross_tier \
        --model-path /tmp/union_weights/best_model_accuracy \
        --test-dir hardened=/tmp/synth_r3_5k/pre_test \
        --test-dir phoneme=/tmp/synth_r3_ph/pre_test \
        --calibration-platt-a 0.79 --calibration-platt-b 0.29 \
        --output docs/eval/cross_tier_union.json

The port's counterpart of the JAX package's script ``eval_cross_tier``,
with its flags and its JSON. The synthetic benchmark has two articulation
tiers (envelope, phoneme: ``tools/make_synthetic_dataset.py``) whose fake
constructions differ; a model trained on one tier transfers weakly to the
other. This harness scores one model on N preprocessed test directories
through the production evaluation path (``tools/validate_pipeline.py`` in
preprocessed mode: the model, with K2, on ``--device``) and emits one JSON
row per tier.

Each tier is scored in a ``validate_pipeline`` subprocess (isolation), or,
with ``--in-process``, by one engine loaded once for every tier. A failure
in either route ends the run: the subprocess's exit status is checked, and
in process nothing is caught.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.device import get_device

REPO = Path(__file__).resolve().parents[2]
KEYS = ("roc_auc", "accuracy", "f1", "precision", "recall", "total")


def score_tier(model_path: str, pre_dir: str, out_dir: Path,
               platt_a: Optional[float], platt_b: Optional[float],
               limit: Optional[int], batch_size: int, engine=None,
               device: str = "cuda:0") -> dict:
    """Score one preprocessed directory: a ``validate_pipeline``
    subprocess by default, in process on ``engine`` when one is given (its
    calibrator is replaced by the tier's)."""
    if engine is not None:
        from lipsync_tpu_torch.inference.calibration import Calibrator
        from lipsync_tpu_torch.tools import validate_pipeline as vp

        if platt_a is not None:
            engine.calibrator = Calibrator.from_config(
                method="platt", platt_a=platt_a, platt_b=platt_b)
        else:
            engine.calibrator = Calibrator.from_config(method="none")
        ns = argparse.Namespace(
            preprocessed_dir=Path(pre_dir), output_dir=Path(out_dir),
            batch_size=batch_size, limit=limit, threshold=0.5, device=device)
        m = vp.run_preprocessed_mode(ns, engine=engine)
        return {k: m[k] for k in KEYS if k in m}
    cmd = [sys.executable, "-m", "lipsync_tpu_torch.tools.validate_pipeline",
           "--preprocessed-dir", pre_dir, "--model-path", str(model_path),
           "--output-dir", str(out_dir), "--batch-size", str(batch_size),
           "--device", device]
    if platt_a is not None:
        cmd += ["--calibration-method", "platt",
                "--calibration-platt-a", str(platt_a),
                "--calibration-platt-b", str(platt_b)]
    if limit:
        cmd += ["--limit", str(limit)]
    proc = subprocess.run(cmd, cwd=REPO, text=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], flush=True)
        raise SystemExit(f"validate_pipeline failed on {pre_dir}")
    m = json.loads((out_dir / "metrics.json").read_text())
    return {k: m[k] for k in KEYS if k in m}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Cross-tier transfer matrix: score one model on "
                    "several test tiers.")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-name", default=None,
                   help="row label in the output (default: model dir name)")
    p.add_argument("--test-dir", action="append", required=True,
                   metavar="NAME=DIR",
                   help="tier name and preprocessed dir; repeatable")
    p.add_argument("--calibration-platt-a", type=float, default=None)
    p.add_argument("--calibration-platt-b", type=float, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--in-process", action="store_true",
                   help="load the engine once and score all tiers "
                        "in-process (see score_tier)")
    p.add_argument("--output", type=Path, default=None)
    add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    get_device(args.device)  # raises here where CUDA is absent

    name = args.model_name or Path(args.model_path).parent.name
    result: dict = {"model": name, "model_path": args.model_path,
                    "tiers": {}}
    engine = None
    if args.in_process:
        from lipsync_tpu_torch.inference.engine import load_engine

        engine = load_engine(args.model_path, device=args.device)
    for spec in args.test_dir:
        tier, _, pre_dir = spec.partition("=")
        if not pre_dir:
            raise SystemExit(f"--test-dir wants NAME=DIR, got {spec!r}")
        with tempfile.TemporaryDirectory(prefix=f"xtier_{tier}_") as td:
            print(f"[cross_tier] scoring {name} on {tier} ({pre_dir})",
                  flush=True)
            result["tiers"][tier] = score_tier(
                args.model_path, pre_dir, Path(td),
                args.calibration_platt_a, args.calibration_platt_b,
                args.limit, args.batch_size, engine=engine,
                device=args.device)
            print(f"[cross_tier]   {tier}: "
                  f"{json.dumps(result['tiers'][tier])}", flush=True)

    out = json.dumps(result, indent=2)
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
