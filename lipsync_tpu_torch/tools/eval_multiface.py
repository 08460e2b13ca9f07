"""Multi-face production-replay eval: per-track verdicts, speaker cases,
policy verdicts, and timeline attribution on ground-truth scenes.

    python -m lipsync_tpu_torch.tools.make_synthetic_dataset --style multiface \
        --output-dir /tmp/mf_scenes --n-per-class 20 --seconds 7
    python -m lipsync_tpu_torch.tools.eval_multiface --data-dir /tmp/mf_scenes \
        --model-path /tmp/union_weights/best_model_accuracy \
        --output docs/eval/multiface_r4.json

The port's counterpart of the JAX package's script ``eval_multiface``,
with its flags and its JSON. It drives multi-face tracking, the speaker
timeline and the per-track verdicts END TO END (detection, the tracker,
crops and the log-mel (K1) and the model (K2) on ``--device``) over
synthetic 2-3-face scenes whose per-face roles are known
(``tools/make_synthetic_dataset.py --style multiface`` writes a sidecar
JSON per clip: synced speaker / dubbed speaker / silent listener, nominal
face centers, speaking spans). Measured:

* **track recovery**: every ground-truth face attributable to >= 1
  recovered track (matched on the track's mean mouth-box center x);
* **per-track verdict accuracy** on speaker faces (predicted ``is_fake``
  of the face's primary track vs role == dubbed);
* **speaker-case classification**: predicted ``speaker_case`` vs the case
  implied by the roles (all_speaking_real / all_speaking_fake /
  mixed_real_and_fake);
* **the four policy verdicts** vs role-derived ground truth;
* **timeline attribution** (turn-taking scenes): the fraction of window
  winners whose selected track belongs to the face speaking at the
  window's mid-time;
* clip-level verdict accuracy and uncertain rate.

``--stub-engine`` scores with a brightness stub instead of a model
(``tools/common.py::StubEngine``): the detection, tracking and attribution
metrics without weights.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import StubEngine, add_device_argument
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger("eval_multiface")


# ── Ground-truth derivations ──────────────────────────────────────────────


def expected_case(truth: Dict[str, Any]) -> str:
    """Speaker case implied by the roles (policy.speaker_policies naming)."""
    speakers = [f for f in truth["faces"] if f["role"] != "listener"]
    dubbed = sum(1 for f in speakers if f["role"] == "speaker_dubbed")
    if dubbed == 0:
        return "all_speaking_real"
    if dubbed == len(speakers):
        return "all_speaking_fake"
    return "mixed_real_and_fake"


def expected_policy_verdicts(truth: Dict[str, Any]) -> Dict[str, Any]:
    """Role-derived ground truth for the four speaking-track policies.

    ``active`` is only well-defined when one speaker dominates the speaking
    time (all_real / all_fake scenes); simultaneous and symmetric
    turn-taking scenes record None and are excluded from that accuracy.
    """
    speakers = [f for f in truth["faces"] if f["role"] != "listener"]
    dubbed = sum(1 for f in speakers if f["role"] == "speaker_dubbed")
    real = len(speakers) - dubbed
    active: Optional[bool] = None
    if len(speakers) == 1:
        active = speakers[0]["role"] == "speaker_dubbed"
    return {
        "active_speaker_policy_is_fake": active,
        "any_speaking_fake_policy_is_fake": dubbed > 0,
        "all_speaking_fake_policy_is_fake": dubbed == len(speakers) > 0,
        "majority_speaking_fake_policy_is_fake": dubbed > real,
    }


def speaking_face_at(truth: Dict[str, Any], t: float) -> Optional[int]:
    """Slot of the face whose speaking span contains time ``t`` (None if
    nobody or more than one is speaking — only unambiguous windows count
    toward timeline attribution)."""
    active = [
        f["slot"]
        for f in truth["faces"]
        for (t0, t1) in f["speaking"]
        if t0 <= t < t1
    ]
    return active[0] if len(active) == 1 else None


# ── Track <-> face matching ───────────────────────────────────────────────


def match_tracks_to_faces(
    tracks: List[Dict[str, Any]], truth: Dict[str, Any]
) -> Dict[int, Optional[int]]:
    """track_id -> face slot by nearest mean mouth-box center x (a face
    owns the middle of its horizontal cell; anything farther than a third
    of a cell from every face center is spurious -> None — recovered
    centers land within a few px of truth, so the buffer only excludes
    genuine junk)."""
    cell_w = truth["frame_width"] / truth["n_faces"]
    assignment: Dict[int, Optional[int]] = {}
    for tr in tracks or []:
        bbox = tr.get("bbox") or (0, 0, 0, 0)
        cx = (float(bbox[0]) + float(bbox[2])) / 2.0
        best_slot, best_d = None, cell_w / 3.0
        for f in truth["faces"]:
            d = abs(cx - float(f["cx"]))
            if d < best_d:
                best_slot, best_d = int(f["slot"]), d
        assignment[int(tr["track_id"])] = best_slot
    return assignment


def primary_track_per_face(
    tracks: List[Dict[str, Any]], assignment: Dict[int, Optional[int]]
) -> Dict[int, Dict[str, Any]]:
    """slot -> the matched track with the most hits (detection dropouts can
    fragment one subject into several tracks; the longest carries the
    subject's verdict, mirroring how the reference's stability weighting
    privileges long tracks, predictor.py:1423-1425)."""
    primary: Dict[int, Dict[str, Any]] = {}
    for tr in tracks or []:
        slot = assignment.get(int(tr["track_id"]))
        if slot is None:
            continue
        cur = primary.get(slot)
        if cur is None or int(tr.get("hits", 0)) > int(cur.get("hits", 0)):
            primary[slot] = tr
    return primary


# ── Per-clip evaluation ───────────────────────────────────────────────────


def evaluate_clip(
    predictor, clip_path: Path, truth: Dict[str, Any]
) -> Dict[str, Any]:
    t0 = time.perf_counter()
    res = predictor.predict(clip_path)
    elapsed = time.perf_counter() - t0

    tracks = res.get("tracks") or []
    assignment = match_tracks_to_faces(tracks, truth)
    primary = primary_track_per_face(tracks, assignment)
    speakers = [f for f in truth["faces"] if f["role"] != "listener"]
    listeners = [f for f in truth["faces"] if f["role"] == "listener"]

    # Per-track verdict correctness on speaker faces.
    speaker_rows = []
    for f in speakers:
        tr = primary.get(f["slot"])
        if tr is None:
            speaker_rows.append({"slot": f["slot"], "matched": False})
            continue
        gt_fake = f["role"] == "speaker_dubbed"
        speaker_rows.append({
            "slot": f["slot"],
            "matched": True,
            "gt_fake": gt_fake,
            "pred_fake": bool(tr["is_fake"]),
            "correct": bool(tr["is_fake"]) == gt_fake,
            "confidence": float(tr["confidence"]),
            "speaking_activity": float(tr.get("speaking_activity", 0.5)),
            "stability": float(tr.get("stability", 0.0)),
        })

    listener_rows = [
        {
            "slot": f["slot"],
            "matched": f["slot"] in primary,
            "speaking_activity": float(
                primary[f["slot"]].get("speaking_activity", 0.5)
            ) if f["slot"] in primary else None,
        }
        for f in listeners
    ]

    # Timeline attribution: window winners vs who is actually speaking.
    slot_of_track = {
        tid: slot for tid, slot in assignment.items() if slot is not None
    }
    fps = float(truth.get("fps", 15.0))
    timeline_total = timeline_correct = 0
    for w in res.get("window_results") or []:
        mid_t = w.get("time_start_sec")
        if mid_t is None:
            mid_t = w["frame_start"] / fps
        mid_t = (mid_t + (w.get("time_end_sec")
                          or (w["frame_end"] / fps))) / 2.0
        gt_slot = speaking_face_at(truth, mid_t)
        if gt_slot is None:
            continue
        timeline_total += 1
        if slot_of_track.get(int(w["selected_track_id"])) == gt_slot:
            timeline_correct += 1

    gt_policies = expected_policy_verdicts(truth)
    pred_policies = res.get("verdicts") or {}
    policy_rows = {
        k: (None if gt is None or k not in pred_policies
            else bool(pred_policies[k]) == gt)
        for k, gt in gt_policies.items()
    }

    verdict = res.get("verdict")
    return {
        "clip": clip_path.name,
        "scene": truth["scene"],
        "n_tracks": len(tracks),
        "faces_recovered": sum(
            1 for f in truth["faces"] if f["slot"] in primary
        ),
        "n_faces": truth["n_faces"],
        "spurious_tracks": sum(
            1 for s in assignment.values() if s is None
        ),
        "speaker_rows": speaker_rows,
        "listener_rows": listener_rows,
        "clip_gt_fake": bool(truth["clip_is_fake"]),
        "clip_verdict": verdict,
        "clip_verdict_correct": (
            None if verdict == "uncertain"
            else (verdict == "fake") == bool(truth["clip_is_fake"])
        ),
        "speaker_case_pred": res.get("speaker_case"),
        "speaker_case_gt": expected_case(truth),
        "speaking_tracks_count": res.get("speaking_tracks_count"),
        "gt_speaker_count": len(speakers),
        "policy_correct": policy_rows,
        "timeline_total": timeline_total,
        "timeline_correct": timeline_correct,
        "turn_taking_detected": bool(res.get("turn_taking_detected")),
        "elapsed_sec": round(elapsed, 2),
    }


# ── Aggregation ───────────────────────────────────────────────────────────


def _rate(num: int, den: int) -> Optional[float]:
    return round(num / den, 4) if den else None


def aggregate(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    by_scene: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    for r in rows:
        by_scene[r["scene"]].append(r)

    def agg(group: List[Dict[str, Any]]) -> Dict[str, Any]:
        sp = [s for r in group for s in r["speaker_rows"]]
        sp_matched = [s for s in sp if s["matched"]]
        li = [l for r in group for l in r["listener_rows"]]
        verdict_known = [
            r for r in group if r["clip_verdict_correct"] is not None
        ]
        pol: Dict[str, Any] = {}
        for k in (
            "active_speaker_policy_is_fake",
            "any_speaking_fake_policy_is_fake",
            "all_speaking_fake_policy_is_fake",
            "majority_speaking_fake_policy_is_fake",
        ):
            vals = [
                r["policy_correct"][k] for r in group
                if r["policy_correct"].get(k) is not None
            ]
            pol[k] = _rate(sum(vals), len(vals))
        t_tot = sum(r["timeline_total"] for r in group)
        t_cor = sum(r["timeline_correct"] for r in group)
        return {
            "clips": len(group),
            "face_recovery": _rate(
                sum(r["faces_recovered"] for r in group),
                sum(r["n_faces"] for r in group),
            ),
            "spurious_tracks_per_clip": round(
                float(np.mean([r["spurious_tracks"] for r in group])), 2
            ),
            "speaker_track_match_rate": _rate(len(sp_matched), len(sp)),
            "speaker_verdict_accuracy": _rate(
                sum(1 for s in sp_matched if s["correct"]), len(sp_matched)
            ),
            "clip_verdict_accuracy": _rate(
                sum(1 for r in verdict_known if r["clip_verdict_correct"]),
                len(verdict_known),
            ),
            "clip_uncertain_rate": _rate(
                sum(1 for r in group if r["clip_verdict"] == "uncertain"),
                len(group),
            ),
            "speaker_case_accuracy": _rate(
                sum(
                    1 for r in group
                    if r["speaker_case_pred"] == r["speaker_case_gt"]
                ),
                len(group),
            ),
            "policy_accuracy": pol,
            "timeline_attribution": _rate(t_cor, t_tot),
            "timeline_windows": t_tot,
            "listener_mean_speaking_activity": (
                round(float(np.mean([
                    l["speaking_activity"] for l in li
                    if l["speaking_activity"] is not None
                ])), 3)
                if any(l["speaking_activity"] is not None for l in li)
                else None
            ),
            "speaker_mean_speaking_activity": (
                round(float(np.mean(
                    [s["speaking_activity"] for s in sp_matched]
                )), 3) if sp_matched else None
            ),
            "mean_elapsed_sec": round(
                float(np.mean([r["elapsed_sec"] for r in group])), 2
            ),
        }

    out = {"overall": agg(rows)}
    for scene in sorted(by_scene):
        out[scene] = agg(by_scene[scene])
    return out


def main(argv: Optional[List[str]] = None, engine=None,
         detector_backend=None) -> int:
    """``engine``: reuse an already-loaded ScoringEngine across replay
    configurations (the Predictor re-binds its calibrator per call);
    ``detector_backend``: the predictor's detector (default: the cascade
    ladder)."""
    p = argparse.ArgumentParser(
        description="Multi-face production-replay eval: per-track verdicts, "
                    "speaker cases, policy verdicts, and timeline "
                    "attribution on ground-truth scenes.")
    p.add_argument("--data-dir", type=Path, required=True,
                   help="Flat dir of multiface .avi + sidecar .json "
                        "(make_synthetic_dataset --style multiface)")
    p.add_argument("--model-path", type=Path, default=None)
    p.add_argument("--stub-engine", action="store_true",
                   help="score with a brightness stub instead of a model: "
                        "validates detection/tracking/attribution metrics "
                        "(face recovery, spurious tracks, timeline "
                        "plumbing) without weights")
    p.add_argument("--output", type=Path,
                   default=Path("docs/eval/multiface.json"))
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--calibration-method", default="none",
                   choices=["none", "temperature", "platt"])
    p.add_argument("--calibration-temperature", type=float, default=1.0)
    p.add_argument("--calibration-platt-a", type=float, default=1.0)
    p.add_argument("--calibration-platt-b", type=float, default=0.0)
    p.add_argument("--speaking-score-mode", default="alignment",
                   choices=["alignment", "articulation"],
                   help="alignment = reference-parity motion<->audio "
                        "correlation; articulation = audio-independent "
                        "mouth-motion gate (policy.speaking_score)")
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )

    cfg = PredictorConfig(
        calibration_method=args.calibration_method,
        calibration_temperature=args.calibration_temperature,
        calibration_platt_a=args.calibration_platt_a,
        calibration_platt_b=args.calibration_platt_b,
        speaking_score_mode=args.speaking_score_mode,
    )
    common = dict(config=cfg, detector_backend=detector_backend,
                  device=args.device)
    if args.stub_engine:
        predictor = Predictor(engine=StubEngine(), **common)
    elif engine is not None:
        predictor = Predictor(engine=engine, **common)
    elif args.model_path is None:
        p.error("--model-path or --stub-engine required")
    else:
        predictor = Predictor(model_path=args.model_path, **common)

    clips = sorted(args.data_dir.glob("*.avi"))
    if args.limit:
        clips = clips[: args.limit]
    rows: List[Dict[str, Any]] = []
    for i, clip in enumerate(clips):
        sidecar = clip.with_suffix(".json")
        if not sidecar.exists():
            logger.warning("No sidecar for %s; skipping", clip.name)
            continue
        truth = json.loads(sidecar.read_text())
        row = evaluate_clip(predictor, clip, truth)
        rows.append(row)
        logger.info(
            "[%d/%d] %s: tracks=%d verdict=%s (gt_fake=%s) case=%s/%s "
            "%.1fs",
            i + 1, len(clips), clip.name, row["n_tracks"],
            row["clip_verdict"], row["clip_gt_fake"],
            row["speaker_case_pred"], row["speaker_case_gt"],
            row["elapsed_sec"],
        )

    summary = aggregate(rows)
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(
        {"summary": summary, "clips": rows}, indent=1
    ))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
