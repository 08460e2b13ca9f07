"""Diagnose whether the audio-visual sync signal survives preprocessing.

    python -m lipsync_tpu_torch.tools.diagnose_sync_signal \
        --preprocessed-dir /tmp/x/pre_train [--limit N] [--json-out r.json]

The port's counterpart of the JAX package's
script ``diagnose_sync_signal``, with its flags and its report. Before
scaling training data, measure the ORACLE discriminability of a
preprocessed dataset: if a hand-computed sync statistic on the stored
tensors separates real from fake clips, the data is learnable in principle;
if it does not, the generator (or the crop pipeline) destroys the signal.

The statistic (the physics of the speaking-activity score): per-frame
mouth-openness proxies from the stored crops, correlated against the
audio amplitude envelope recovered from the stored log-mel. REAL clips
should correlate, FAKE clips should not. Reports per-class correlation
distributions and the single-statistic ROC-AUC. The stored tensors are read
through ``training/data.py::LipSyncDataset`` in preprocessed mode, on the
host: the tool has no device work, and a record the store cannot return is
skipped, as the dataset skips it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.training.data import LipSyncDataset


def audio_envelope_at_frames(mel_db: np.ndarray, n_frames: int,
                             mel_hz: float = 100.0,
                             fps: float = 15.0) -> np.ndarray:
    """Recover the amplitude envelope from stored log-mel and resample it
    to the video frame rate by bin-averaging."""
    power = np.power(10.0, mel_db / 10.0)  # undo dB
    env = np.sqrt(np.maximum(power.mean(axis=0), 0.0))  # (T_mel,)
    t_mel = env.shape[0]
    out = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        lo = int(i * mel_hz / fps)
        hi = max(lo + 1, int((i + 1) * mel_hz / fps))
        out[i] = env[min(lo, t_mel - 1): min(hi, t_mel)].mean() \
            if lo < t_mel else env[-1]
    return out


def openness_proxies(visual: np.ndarray) -> dict:
    """Per-frame mouth-openness proxies from (T,H,W,3) uint8/float crops.

    * ``dark_frac``: fraction of dark (lip-colored) pixels in the center
      half of the crop — tracks how OPEN the mouth is.
    * ``motion``: mean |frame difference| — tracks mouth movement rate.
    """
    v = visual.astype(np.float32)
    if v.max() <= 1.5:
        v = v * 255.0
    t, h, w, _ = v.shape
    center = v[:, h // 4: 3 * h // 4, w // 4: 3 * w // 4, :]
    gray = center.mean(axis=-1)  # (T, h/2, w/2)
    # Per-clip adaptive darkness threshold (jittered colors).
    thresh = np.percentile(gray, 25)
    dark_frac = (gray < thresh).mean(axis=(1, 2))
    motion = np.abs(np.diff(v.mean(axis=-1), axis=0)).mean(axis=(1, 2))
    motion = np.concatenate([[motion[0]], motion])
    return {"dark_frac": dark_frac.astype(np.float32),
            "motion": motion.astype(np.float32)}


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 1e-9 else 0.0


def clip_sync_score(visual: np.ndarray, mel_db: np.ndarray) -> dict:
    n = visual.shape[0]
    env = audio_envelope_at_frames(mel_db, n)
    prox = openness_proxies(visual)
    denv = np.abs(np.diff(env, prepend=env[0]))
    return {
        "corr_open_env": _corr(prox["dark_frac"], env),
        "corr_motion_denv": _corr(prox["motion"], denv),
    }


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUC of score ranking for the positive (label 1) class."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    greater = (pos[:, None] > neg[None, :]).sum()
    ties = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * ties) / (len(pos) * len(neg)))


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(
        description="Diagnose whether the audio-visual sync signal "
                    "survives preprocessing.")
    p.add_argument("--preprocessed-dir", type=Path, required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--json-out", type=Path, default=None)
    args = p.parse_args(argv)

    ds = LipSyncDataset(preprocessed_dir=args.preprocessed_dir)
    rows = []
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    for i in range(n):
        rec = ds._manifest[i]
        try:
            visual, mel = ds._load_tensors(rec)
        except Exception as e:  # noqa: BLE001 -- a store read, no kernel
            print(f"skip {rec.get('key')}: {e}")
            continue
        mel = np.asarray(mel)
        if mel.ndim == 3:
            mel = mel[0]
        s = clip_sync_score(np.asarray(visual), mel)
        s["label"] = int(rec["label"])  # 1=REAL, 0=FAKE
        rows.append(s)

    labels = np.array([r["label"] for r in rows])
    report = {"n_clips": len(rows),
              "n_real": int((labels == 1).sum()),
              "n_fake": int((labels == 0).sum())}
    for key in ("corr_open_env", "corr_motion_denv"):
        scores = np.array([r[key] for r in rows])
        report[key] = {
            "real_mean": float(scores[labels == 1].mean()),
            "real_std": float(scores[labels == 1].std()),
            "fake_mean": float(scores[labels == 0].mean()),
            "fake_std": float(scores[labels == 0].std()),
            "auc_real_positive": roc_auc(scores, labels),
        }
    print(json.dumps(report, indent=2))
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
