"""Generalization to UNSEEN fake constructions (and per-mode breakdown).

    python -m lipsync_tpu_torch.tools.eval_unseen_fakes \
        --model-path /tmp/union_weights/best_model_accuracy \
        --calibration-platt-a 0.6953 --calibration-platt-b -0.1814 \
        --work-dir /tmp/unseen_eval --n-per-class 150 \
        --output docs/eval/unseen_constructions.json

The port's counterpart of the JAX package's script ``eval_unseen_fakes``,
with its flags and its JSON. The trained models only ever saw three fake
constructions (phoneme tier: global time-shift, audio-swap,
vowel-scramble: ``tools/make_synthetic_dataset.py``'s training cycle).
Real deepfake detectors must generalize to fabrication methods absent from
training, so this harness builds one balanced test set PER construction,
six of them held out of training:

- ``warp``: a smooth local time-warp (peak 0.15-0.3 s) that drifts in and
  out of sync within the clip;
- ``splice``: a real clip whose middle third of audio is swapped
  (crossfaded), so two thirds of the windows are synced;
- ``freeze``: the visual articulation holds still for 0.5-1.0 s while the
  audio continues (the face-swap dropped-frames artifact);
- ``revoice``: video real, audio re-synthesized with scrambled vowels on
  the same timing, stress and voiced envelope;
- ``retime``: video uniformly time-stretched 0.85-0.93x / 1.08-1.18x, so
  the sync drift grows linearly;
- ``composite``: synced audio and video; the lip region carries face-swap
  blending artifacts only (blur, seam, 1 px shimmer);

and scores one model on each through the production evaluation path
(``tools/eval_cross_tier.py::score_tier`` over ``tools/validate_pipeline``),
emitting per-construction AUC and recall with the seen/unseen annotation.

Each construction is generated (``tools.make_synthetic_dataset``) and
precomputed on ``--device`` (``tools.precompute_training_tensors``: crops
and the log-mel, K1) in subprocesses of the port's own entry points; a
stage that fails ends the run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.tools.eval_cross_tier import REPO, score_tier
from lipsync_tpu_torch.utils.device import get_device

SEEN = ("shift", "swap", "scramble")
UNSEEN = ("warp", "splice", "freeze", "revoice", "retime", "composite")
TOOLS = "lipsync_tpu_torch.tools"


def run(cmd: list, log: Path) -> None:
    """Run one stage, its output into ``log``; a failure ends the run."""
    log.parent.mkdir(parents=True, exist_ok=True)
    cmd = [str(c) for c in cmd]
    proc = subprocess.run(cmd, cwd=REPO, text=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    log.write_text(proc.stdout)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], flush=True)
        raise SystemExit(f"step failed: {' '.join(cmd)}")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generalization to UNSEEN fake constructions (and "
                    "per-mode breakdown).")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-name", default=None)
    p.add_argument("--work-dir", type=Path, default=Path("/tmp/unseen_eval"))
    p.add_argument("--n-per-class", type=int, default=150)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed-base", type=int, default=101,
                   help="construction k uses seed seed-base+k; keep "
                        "disjoint from training seeds (1/7/13/33)")
    p.add_argument("--constructions", default=",".join(SEEN + UNSEEN))
    p.add_argument("--calibration-platt-a", type=float, default=None)
    p.add_argument("--calibration-platt-b", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--skip-generate", action="store_true")
    p.add_argument("--skip-precompute", action="store_true")
    p.add_argument("--in-process", action="store_true",
                   help="load the engine ONCE and score every "
                        "construction in this process")
    p.add_argument("--output", type=Path, default=None)
    add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    get_device(args.device)  # raises here where CUDA is absent

    w = args.work_dir
    logs = w / "logs"
    py = sys.executable
    constructions = [c.strip() for c in args.constructions.split(",")]

    for k, c in enumerate(constructions):
        if not args.skip_generate:
            run([py, "-m", f"{TOOLS}.make_synthetic_dataset",
                 "--output-dir", w / f"raw_{c}",
                 "--n-per-class", args.n_per_class,
                 "--seconds", args.seconds, "--seed", args.seed_base + k,
                 "--style", "phoneme", "--jitter", "--fake-modes", c],
                logs / f"gen_{c}.log")
        if not args.skip_precompute:
            run([py, "-m", f"{TOOLS}.precompute_training_tensors",
                 "--data-dir", w / f"raw_{c}",
                 "--output-dir", w / f"pre_{c}",
                 "--mode", "full_sequence", "--storage-format", "zarr",
                 "--device", args.device],
                logs / f"pre_{c}.log")

    name = args.model_name or Path(args.model_path).parent.name
    result: dict = {"model": name, "model_path": args.model_path,
                    "n_per_class": args.n_per_class,
                    "seen_in_training": list(SEEN),
                    "unseen_constructions": list(UNSEEN),
                    "constructions": {}}
    engine = None
    if args.in_process:
        from lipsync_tpu_torch.inference.engine import load_engine

        engine = load_engine(args.model_path, device=args.device)
    for c in constructions:
        out_dir = w / f"eval_{c}"
        m = score_tier(args.model_path, str(w / f"pre_{c}"), out_dir,
                       args.calibration_platt_a, args.calibration_platt_b,
                       None, args.batch_size, engine=engine,
                       device=args.device)
        m["unseen"] = c in UNSEEN
        result["constructions"][c] = m
        print(f"[{c}{' UNSEEN' if m['unseen'] else ''}] "
              f"auc={m.get('roc_auc')} recall={m.get('recall')}",
              flush=True)

    out = json.dumps(result, indent=2)
    print(out)
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
