"""Measure speaker/listener articulation-ratio bands on scene families.

    python -m lipsync_tpu_torch.tools.measure_articulation_bands \
        --data-dir original=/tmp/mf_scenes_2f \
        --data-dir fresh=/tmp/mf_fresh_2f \
        --data-dir low_gain=/tmp/mf_gain06_2f \
        --out docs/eval/articulation_bands_r5.json

The port's counterpart of the JAX package's
script ``measure_articulation_bands``, with its flags and its JSON. The
articulation speaking-score constants (``policy.speaking_articulation_score``:
logistic midpoint 0.10, scale 0.03) were calibrated on tracks of one
synthetic scene family. This tool re-runs that measurement on any
multiface scene directories (``tools/make_synthetic_dataset.py --style
multiface``: fresh seeds, the ``--articulation-gain`` variant), so that the
constants' separation margin is on record.

Tracks are recovered through the production host path
(``preprocessing/video.py::detect_and_crop_tracks``: detection and the
streaming tracker on the host, the crops on ``--device``), matched to the
ground-truth faces by the sidecar's cell geometry, and the pre-logistic
ratio (``policy.articulation_ratio``) is pooled by role.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.inference.policy import articulation_ratio
from lipsync_tpu_torch.preprocessing import ingest
from lipsync_tpu_torch.preprocessing.video import detect_and_crop_tracks
from lipsync_tpu_torch.tools.common import add_device_argument
from lipsync_tpu_torch.utils.device import get_device


def measure_family(data_dir: Path, limit: int = None, backend=None,
                   device="cuda:0") -> dict:
    clips = sorted(data_dir.glob("*.avi"))
    if limit:
        clips = clips[:limit]
    ratios = {"speaker": [], "listener": []}
    n_clips = 0
    for clip in clips:
        sidecar = clip.with_suffix(".json")
        if not sidecar.exists():
            continue
        truth = json.loads(sidecar.read_text())
        frames = ingest.read_video(clip, truth.get("fps", 15.0))
        tracks = detect_and_crop_tracks(frames, backend=backend,
                                        device=device)
        n_clips += 1
        cell_w = truth["frame_width"] / truth["n_faces"]
        # Primary (most-hits) track per slot, matched by mean-box center x.
        primary = {}
        for tr in tracks:
            cx = (tr.mean_bbox[0] + tr.mean_bbox[2]) / 2.0
            best_slot, best_d = None, cell_w / 3.0
            for f in truth["faces"]:
                d = abs(cx - float(f["cx"]))
                if d < best_d:
                    best_slot, best_d = int(f["slot"]), d
            if best_slot is None:
                continue
            cur = primary.get(best_slot)
            if cur is None or tr.hits > cur.hits:
                primary[best_slot] = tr
        for f in truth["faces"]:
            tr = primary.get(int(f["slot"]))
            if tr is None:
                continue
            r = articulation_ratio(tr.crops)
            if r is None:
                continue
            role = "listener" if f["role"] == "listener" else "speaker"
            ratios[role].append(r)

    def band(v):
        if not v:
            return None
        a = np.asarray(v)
        return {
            "n": len(v),
            "min": round(float(a.min()), 4),
            "p10": round(float(np.percentile(a, 10)), 4),
            "median": round(float(np.median(a)), 4),
            "p90": round(float(np.percentile(a, 90)), 4),
            "max": round(float(a.max()), 4),
        }

    out = {
        "clips": n_clips,
        "speaker_band": band(ratios["speaker"]),
        "listener_band": band(ratios["listener"]),
    }
    if ratios["speaker"] and ratios["listener"]:
        sp, li = np.asarray(ratios["speaker"]), np.asarray(ratios["listener"])
        out["separation_min_speaker_minus_max_listener"] = round(
            float(sp.min() - li.max()), 4
        )
        # Fraction each side lands on the correct side of the 0.10 midpoint.
        out["speaker_above_midpoint_frac"] = round(
            float((sp > 0.10).mean()), 4
        )
        out["listener_below_midpoint_frac"] = round(
            float((li < 0.10).mean()), 4
        )
    return out


def main(argv: Optional[List[str]] = None, backend=None) -> int:
    """``backend``: the detector (default: the cascade ladder)."""
    p = argparse.ArgumentParser(
        description="Measure speaker/listener articulation-ratio bands on "
                    "scene families.")
    p.add_argument("--data-dir", action="append", required=True,
                   metavar="NAME=DIR")
    p.add_argument("--limit", type=int, default=None,
                   help="max clips per family")
    p.add_argument("--out", type=Path, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)
    get_device(args.device)  # raises here where CUDA is absent

    result = {"midpoint_constant": 0.10, "scale_constant": 0.03,
              "families": {}}
    for spec in args.data_dir:
        name, _, d = spec.partition("=")
        if not d:
            raise SystemExit(f"--data-dir wants NAME=DIR, got {spec!r}")
        print(f"[bands] measuring {name} ({d}) ...", flush=True)
        result["families"][name] = measure_family(
            Path(d), args.limit, backend=backend, device=args.device)
        print(f"[bands]   {json.dumps(result['families'][name])}",
              flush=True)

    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
