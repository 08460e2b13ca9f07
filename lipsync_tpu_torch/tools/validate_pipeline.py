"""Batch evaluation harness: the system's integration test.

    python -m lipsync_tpu_torch.tools.validate_pipeline --data-dir data/val \
        --model-path weights/best_model_accuracy --output-dir eval_out

The port's counterpart of the JAX package's ``scripts/validate_pipeline.py``,
with its flags and outputs:

* ``video`` mode replays the production entry point (``Predictor.predict``:
  decode, detection and tracking on the host, crops, the log-mel (K1) and
  the model (K2) on ``--device``) per file over a labelled ``real/`` +
  ``fake/`` tree. A file whose decode fails is written as an ``error`` row;
  any other failure ends the run (``tools/common.py``).
* ``preprocessed`` mode runs batched model-only inference over a
  precomputed tensor directory through ``ScoringEngine.score_probs`` (K2;
  with ``--quantized-int8`` the int8 lowering, K4 then K3), one padded
  forward per chunk of files, calibrated as the service calibrates.
* Outputs: ``predictions.csv``, ``metrics.json`` (accuracy, P, R, F1, FPR,
  FNR, ROC-AUC, the best-F1 threshold), ``high_confidence_errors.csv``,
  and the confusion-matrix and ROC plots where matplotlib imports;
  ``--resume`` / ``--save-every`` checkpoint video mode.
"""

from __future__ import annotations

import argparse
import csv
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import (
    add_device_argument,
    host_stage_failed,
)
from lipsync_tpu_torch.training.data import discover_video_samples
from lipsync_tpu_torch.utils.logger import get_logger
from lipsync_tpu_torch.utils.metrics import (
    compute_metrics_at_threshold,
    find_best_threshold,
)

logger = get_logger("validate_pipeline")


def roc_auc(fake_probs: np.ndarray, true_fake: np.ndarray) -> float:
    """ROC AUC of P(FAKE) against the labels: the Mann-Whitney statistic
    on average ranks, so tied scores count half (what sklearn's
    ``roc_auc_score`` computes); 0.5 when a class is absent."""
    fake_probs = np.asarray(fake_probs, np.float64)
    pos = np.asarray(true_fake).astype(bool)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    _, inverse, counts = np.unique(fake_probs, return_inverse=True,
                                   return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inverse]
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def write_plots(out_dir: Path, fake_probs, true_fake, threshold: float):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    m = compute_metrics_at_threshold(fake_probs, true_fake, threshold)
    fig, ax = plt.subplots(figsize=(4, 4))
    cm = np.array([[m["tn"], m["fp"]], [m["fn"], m["tp"]]])
    ax.imshow(cm, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    ax.set_xticks([0, 1], ["pred real", "pred fake"])
    ax.set_yticks([0, 1], ["true real", "true fake"])
    ax.set_title("Confusion matrix")
    fig.tight_layout()
    fig.savefig(out_dir / "confusion_matrix.png", dpi=120)
    plt.close(fig)

    thresholds = np.linspace(0, 1, 101)
    tpr, fpr = [], []
    pos = true_fake.astype(bool)
    for t in thresholds:
        pred = fake_probs >= t
        tp = np.sum(pred & pos)
        fp = np.sum(pred & ~pos)
        tpr.append(tp / max(1, pos.sum()))
        fpr.append(fp / max(1, (~pos).sum()))
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(fpr, tpr)
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_title(f"ROC (AUC={roc_auc(fake_probs, true_fake):.3f})")
    fig.tight_layout()
    fig.savefig(out_dir / "roc_curve.png", dpi=120)
    plt.close(fig)


def run_video_mode(args, predictor=None) -> Dict:
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )

    if predictor is None:
        predictor = Predictor(
            model_path=args.model_path, config=PredictorConfig(),
            device=args.device,
        )
    samples = discover_video_samples(args.data_dir)
    if args.limit:
        samples = samples[: args.limit]
    logger.info("Evaluating %d videos", len(samples))

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pred_csv = out_dir / "predictions.csv"

    done: Dict[str, Dict] = {}
    if args.resume and pred_csv.exists():
        with pred_csv.open() as f:
            for row in csv.DictReader(f):
                done[row["path"]] = row
        logger.info("Resuming: %d predictions already done", len(done))

    rows: List[Dict] = list(done.values())
    new_rows: List[Dict] = []
    for path, label in samples:
        if str(path) in done:
            continue
        t0 = time.perf_counter()
        try:
            result = predictor.predict(path)
        except Exception as e:
            if not host_stage_failed(e):
                raise
            logger.warning("Failed %s: %s", path, e)
            row = {
                "path": str(path), "true_label": label, "verdict": "error",
                "confidence": "0.5", "is_fake": 0,
                "inference_time": f"{time.perf_counter() - t0:.3f}",
                "error": str(e)[:200],
            }
        else:
            row = {
                "path": str(path),
                "true_label": label,  # 1 = REAL
                "verdict": result["verdict"],
                "confidence": f"{result['confidence']:.6f}",
                "is_fake": int(result["is_fake"]),
                "inference_time": f"{time.perf_counter() - t0:.3f}",
                "error": "",
            }
        rows.append(row)
        new_rows.append(row)
        if args.save_every and len(new_rows) % args.save_every == 0:
            _write_csv(pred_csv, rows)
            logger.info("Checkpoint: %d/%d", len(rows), len(samples))

    _write_csv(pred_csv, rows)
    return finalize_metrics(rows, out_dir, args.threshold)


def _write_csv(path: Path, rows: List[Dict]) -> None:
    if not rows:
        return
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def finalize_metrics(rows: List[Dict], out_dir: Path, threshold: float) -> Dict:
    """``metrics.json``, the plots and ``high_confidence_errors.csv`` from
    the prediction rows (error rows counted, not scored)."""
    ok = [r for r in rows if r["verdict"] != "error"]
    if not ok:
        logger.warning("No successful predictions")
        return {}
    fake_probs = np.array([1.0 - float(r["confidence"]) for r in ok])
    true_fake = np.array([int(r["true_label"]) == 0 for r in ok])
    m = compute_metrics_at_threshold(fake_probs, true_fake, threshold)
    m["fpr"] = m["fp"] / max(1, m["fp"] + m["tn"])
    m["fnr"] = m["fn"] / max(1, m["fn"] + m["tp"])
    m["roc_auc"] = roc_auc(fake_probs, true_fake)
    best_t, best_m = find_best_threshold(fake_probs, true_fake)
    m["best_threshold"] = best_t
    m["best_threshold_f1"] = best_m["f1"]
    m["errors"] = len(rows) - len(ok)
    (out_dir / "metrics.json").write_text(json.dumps(m, indent=2))
    write_plots(out_dir, fake_probs, true_fake, threshold)

    hc = []
    for r, fp_prob, tf in zip(ok, fake_probs, true_fake):
        pred_fake = fp_prob >= threshold
        if pred_fake != tf and abs(fp_prob - 0.5) > 0.3:
            hc.append(r)
    if hc:
        _write_csv(out_dir / "high_confidence_errors.csv", hc)
    logger.info(
        "Metrics: acc=%.4f P=%.4f R=%.4f F1=%.4f AUC=%.4f (errors=%d)",
        m["accuracy"], m["precision"], m["recall"], m["f1"], m["roc_auc"],
        m["errors"],
    )
    return m


def run_preprocessed_mode(args, engine=None) -> Dict:
    """Batched model-only inference: the windows of each chunk of
    ``--batch-size`` files scored as one padded batch."""
    from lipsync_tpu_torch.inference.engine import load_engine
    from lipsync_tpu_torch.training.data import LipSyncDataset

    if engine is None:
        engine = load_engine(
            args.model_path,
            quantized_int8=getattr(args, "quantized_int8", False),
            device=args.device,
        )
        if getattr(args, "calibration_method", "none") != "none":
            # The production calibrator, with the service's knobs (fit by
            # tools/fit_calibrator.py).
            from lipsync_tpu_torch.inference.calibration import Calibrator

            engine.calibrator = Calibrator.from_config(
                method=args.calibration_method,
                temperature=args.calibration_temperature,
                platt_a=args.calibration_platt_a,
                platt_b=args.calibration_platt_b,
                isotonic_path=args.calibration_isotonic_path,
            )
    ds = LipSyncDataset(
        preprocessed_dir=args.preprocessed_dir,
        video_frames=engine.config.video_frames,
        audio_frames=engine.config.audio_frames,
    )
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    batch_v, batch_a, batch_meta = [], [], []

    def flush():
        nonlocal batch_v, batch_a, batch_meta
        if not batch_v:
            return
        probs = engine.score_probs(
            np.stack(batch_v), np.stack(batch_a)
        )
        for (path, label), p in zip(batch_meta, probs):
            rows.append({
                "path": str(path), "true_label": label,
                "verdict": "real" if p >= args.threshold else "fake",
                "confidence": f"{float(p):.6f}",
                "is_fake": int(p < args.threshold),
                "inference_time": "0", "error": "",
            })
        batch_v, batch_a, batch_meta = [], [], []

    n = len(ds) if not args.limit else min(args.limit, len(ds))
    for i in range(n):
        sample = ds.get_item(i, train_mode_override=False)
        if sample is None:
            continue
        v, a, label = sample
        batch_v.append(v)
        batch_a.append(a)
        batch_meta.append((ds.samples[i][0], int(label)))
        if len(batch_v) >= args.batch_size:
            flush()
    flush()
    _write_csv(out_dir / "predictions.csv", rows)
    return finalize_metrics(rows, out_dir, args.threshold)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch evaluation harness")
    p.add_argument("--data-dir", type=Path, default=None,
                   help="Labelled real/+fake/ video tree (video mode)")
    p.add_argument("--preprocessed-dir", type=Path, default=None,
                   help="Precomputed tensor dir (preprocessed mode)")
    p.add_argument("--model-path", type=Path, required=False)
    p.add_argument("--output-dir", type=Path, default=Path("eval_out"))
    p.add_argument("--threshold", type=float, default=0.5,
                   help="P(FAKE) decision threshold")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-every", type=int, default=25)
    # Calibration knobs (same names/defaults as the serving Settings).
    p.add_argument("--quantized-int8", action="store_true",
                   help="Serve through the int8 convolution lowering "
                        "(Settings.quantized_int8; models/layers.py::"
                        "int8_conv, K4 then K3)")
    p.add_argument("--calibration-method", default="none",
                   choices=["none", "temperature", "platt", "isotonic"])
    p.add_argument("--calibration-temperature", type=float, default=1.0)
    p.add_argument("--calibration-platt-a", type=float, default=1.0)
    p.add_argument("--calibration-platt-b", type=float, default=0.0)
    p.add_argument("--calibration-isotonic-path", type=str, default=None)
    add_device_argument(p)
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_argparser().parse_args(argv)
    if args.preprocessed_dir is not None:
        return run_preprocessed_mode(args)
    if args.data_dir is not None:
        return run_video_mode(args)
    raise SystemExit("Provide --data-dir or --preprocessed-dir")


if __name__ == "__main__":
    main()
