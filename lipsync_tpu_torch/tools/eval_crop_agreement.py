"""Mouth-crop agreement eval: heuristic vs lip-refined vs landmark analog.

    python -m lipsync_tpu_torch.tools.eval_crop_agreement [--n 200] \
        [--out report.json] [--stride | --stress]

The port's counterpart of the JAX package's script ``eval_crop_agreement``,
with its flags and its report. Without the mediapipe wheel the landmark
tier (21 lip landmarks +-20 px) is dead code, and every crop comes from the
face-box heuristic. This tool renders synthetic faces with KNOWN lip
geometry across position, scale, skin tone, openness and noise sweeps and
reports the IoU of each tier's box against the landmark-analog box (the
ground-truth lips +-20 px, what FaceMesh would emit):

* ``heuristic``: face box -> (0.18-0.82 w, 0.52-0.96 h);
* ``refined``: the heuristic box through ``refine_mouth_box`` (the
  image-evidence refiner);
* ``learned``: the heuristic box through the lip-localizer CNN
  (``preprocessing/lip_localizer.py`` with ``weights/lip_localizer.npz``,
  trained on a separate face renderer by ``tools/train_lip_localizer.py``),
  with per-frame host latency for each tier.

``--stress`` runs a held-out family (tilt, occlusion, lighting ramp,
motion blur); ``--stride`` the detection-stride trajectory simulation. The
whole measurement runs on the host (numpy): it has no device work.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.preprocessing.face_detection import (
    bbox_iou,
    face_bbox_to_mouth_bbox,
    refine_mouth_box,
)


def render_face(
    h: int,
    w: int,
    cx: int,
    cy: int,
    face_w: int,
    skin,
    lip_color,
    openness: float,
    noise: float,
    rng: np.random.RandomState,
):
    """Synthetic face with known lip geometry.

    Returns (frame, face_box, gt_mouth_box). The lip region is an ellipse
    pair (upper/lower lip around a dark mouth line), proportions from
    facial-anthropometry rules of thumb (mouth width ≈ 0.38 face width,
    mouth center ≈ 0.30 face height below center).
    """
    face_h = int(face_w * 1.35)
    frame = rng.randint(0, 40, size=(h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]

    face = (((yy - cy) / (face_h / 2)) ** 2
            + ((xx - cx) / (face_w / 2)) ** 2) < 1
    frame[face] = skin
    # Eyes.
    for ex in (cx - face_w // 4, cx + face_w // 4):
        eye = ((yy - (cy - face_h // 5)) ** 2 + (xx - ex) ** 2) < (
            face_w * 0.06
        ) ** 2
        frame[eye] = (40, 30, 30)
    # Nose shadow (a distractor edge above the mouth).
    nose = (np.abs(xx - cx) < face_w * 0.05) & (
        np.abs(yy - (cy + face_h * 0.05)) < face_h * 0.08
    )
    frame[nose] = np.asarray(skin, np.float32) * 0.85

    # Lips: two ellipses around the mouth line.
    mcy = cy + int(0.30 * face_h)
    mhw = int(0.19 * face_w)  # half width
    gap = max(1, int(face_h * 0.015 * (0.3 + openness)))
    lip_h = max(2, int(face_h * 0.035))
    upper = (
        ((yy - (mcy - gap - lip_h // 2)) / max(1, lip_h / 2)) ** 2
        + ((xx - cx) / mhw) ** 2
    ) < 1
    lower = (
        ((yy - (mcy + gap + lip_h // 2)) / max(1, lip_h / 1.6)) ** 2
        + ((xx - cx) / mhw) ** 2
    ) < 1
    mouth_line = (np.abs(yy - mcy) < gap) & (np.abs(xx - cx) < mhw * 0.92)
    frame[upper | lower] = lip_color
    frame[mouth_line] = (45, 15, 15)

    if noise > 0:
        frame = frame + rng.randn(h, w, 3) * noise
    frame = np.clip(frame, 0, 255).astype(np.uint8)

    lip_mask = upper | lower | mouth_line
    ys, xs = np.where(lip_mask)
    gt = (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)
    face_box = (
        max(0, cx - face_w // 2),
        max(0, cy - face_h // 2),
        min(w, cx + face_w // 2),
        min(h, cy + face_h // 2),
    )
    return frame, face_box, gt


def render_stress_face(
    h: int, w: int, rng: np.random.RandomState,
):
    """Third, held-out stress family: pose tilt,
    partial mouth occlusion, lighting gradient, motion blur — none of
    which the localizer's training renderer or the standard eval family
    above produce. Returns (frame, face_box, gt_mouth_box) where gt is
    the PRE-occlusion lip extent (the landmark tier estimates occluded
    lips too)."""
    face_w = int(rng.uniform(60, 140))
    face_h = int(face_w * 1.35)
    cx = int(rng.uniform(face_w, w - face_w))
    cy = int(rng.uniform(face_w, h - face_w * 0.8))
    skin = np.asarray((205, 170, 150)) * rng.uniform(0.55, 1.15)
    lip_color = np.asarray((150, 70, 70)) * rng.uniform(0.7, 1.2)
    openness = rng.uniform(0, 1)

    # Pose tilt: evaluate all shape masks in coordinates rotated about
    # the face center.
    theta = np.deg2rad(rng.uniform(-25, 25))
    yy, xx = np.mgrid[0:h, 0:w]
    dxr = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
    dyr = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)

    frame = rng.randint(0, 40, size=(h, w, 3)).astype(np.float32)
    face = (dyr / (face_h / 2)) ** 2 + (dxr / (face_w / 2)) ** 2 < 1
    frame[face] = skin
    for exo in (-face_w // 4, face_w // 4):
        eye = ((dyr + face_h // 5) ** 2 + (dxr - exo) ** 2) < (
            face_w * 0.06
        ) ** 2
        frame[eye] = (40, 30, 30)

    mdy = 0.30 * face_h  # mouth center offset below face center (rotated)
    mhw = int(0.19 * face_w)
    gap = max(1, int(face_h * 0.015 * (0.3 + openness)))
    lip_h = max(2, int(face_h * 0.035))
    upper = (
        ((dyr - (mdy - gap - lip_h // 2)) / max(1, lip_h / 2)) ** 2
        + (dxr / mhw) ** 2
    ) < 1
    lower = (
        ((dyr - (mdy + gap + lip_h // 2)) / max(1, lip_h / 1.6)) ** 2
        + (dxr / mhw) ** 2
    ) < 1
    mouth_line = (np.abs(dyr - mdy) < gap) & (np.abs(dxr) < mhw * 0.92)
    frame[upper | lower] = lip_color
    frame[mouth_line] = (45, 15, 15)

    lip_mask = upper | lower | mouth_line
    ys, xs = np.where(lip_mask)
    if len(xs) == 0:
        return None
    gt = (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)

    # Partial occlusion: a skin-ish or dark bar clipping one side of the
    # mouth (microphone / hand caricature), covering up to ~35% of it.
    if rng.rand() < 0.6:
        occ_w = int((gt[2] - gt[0]) * rng.uniform(0.15, 0.35))
        occ_h = int((gt[3] - gt[1]) * rng.uniform(0.6, 1.6))
        side = rng.choice([0, 1])
        ox1 = gt[0] - occ_w // 3 if side == 0 else gt[2] - 2 * occ_w // 3
        oy1 = int(gt[1] + (gt[3] - gt[1]) * rng.uniform(-0.3, 0.5))
        col = (
            skin * rng.uniform(0.8, 1.1) if rng.rand() < 0.5
            else np.asarray((35.0, 35.0, 40.0))
        )
        frame[max(0, oy1): oy1 + occ_h, max(0, ox1): ox1 + occ_w] = col

    # Lighting gradient: linear ramp across a random direction.
    ang = rng.uniform(0, 2 * np.pi)
    ramp = (xx * np.cos(ang) + yy * np.sin(ang)).astype(np.float32)
    ramp = (ramp - ramp.min()) / max(1e-6, ramp.max() - ramp.min())
    lo, hi = rng.uniform(0.45, 0.8), rng.uniform(1.0, 1.35)
    frame = frame * (lo + (hi - lo) * ramp)[..., None]

    # Motion blur: horizontal box filter, k in {5..15} px.
    if rng.rand() < 0.7:
        k = int(rng.uniform(5, 15))
        csum = np.cumsum(
            np.pad(frame, ((0, 0), (k, 0), (0, 0))), axis=1
        )
        frame = (csum[:, k:] - csum[:, :-k]) / k

    frame = frame + rng.randn(h, w, 3) * rng.uniform(0, 10)
    frame = np.clip(frame, 0, 255).astype(np.uint8)

    fys, fxs = np.where(face)
    face_box = (
        int(fxs.min()), int(fys.min()), int(fxs.max()) + 1, int(fys.max()) + 1
    )
    return frame, face_box, gt


def run_stress(n: int = 200, seed: int = 0, weights: Path = None) -> dict:
    """IoU of each tier on the stress family + the localizer's
    fallback-fire rate (refine() returning the input box — patch too
    small or the sanity check rejecting the prediction)."""
    import time

    from lipsync_tpu_torch.preprocessing import lip_localizer as ll

    localizer = None
    if weights is not None and Path(weights).exists():
        localizer = ll.LipLocalizer.load(Path(weights))
    elif ll.DEFAULT_WEIGHTS.exists():
        localizer = ll.LipLocalizer.load()

    rng = np.random.RandomState(seed)
    h, w = 240, 320
    ious_heur, ious_ref, ious_lrn = [], [], []
    fallback_fires = 0
    t_lrn = 0.0
    done = 0
    while done < n:
        r = render_stress_face(h, w, rng)
        if r is None:
            continue
        frame, face_box, gt = r
        done += 1
        target = landmark_analog(gt, h, w)
        fx1, fy1, fx2, fy2 = face_box
        heur = face_bbox_to_mouth_bbox(fx1, fy1, fx2 - fx1, fy2 - fy1, w, h)
        ious_heur.append(bbox_iou(heur, target))
        ious_ref.append(bbox_iou(refine_mouth_box(frame, heur), target))
        if localizer is not None:
            t0 = time.perf_counter()
            learned = localizer.refine(frame, heur)
            t_lrn += time.perf_counter() - t0
            if learned == heur:
                fallback_fires += 1
            ious_lrn.append(bbox_iou(learned, target))

    def stats(v):
        a = np.asarray(v)
        return {
            "mean": round(float(a.mean()), 4),
            "median": round(float(np.median(a)), 4),
            "p10": round(float(np.percentile(a, 10)), 4),
        }

    out = {
        "n_faces": n,
        "family": "stress (tilt ±25°, occlusion, lighting ramp, motion blur)",
        "iou_vs_landmark_analog": {
            "heuristic": stats(ious_heur),
            "lip_refined": stats(ious_ref),
        },
    }
    if localizer is not None:
        out["iou_vs_landmark_analog"]["learned"] = stats(ious_lrn)
        out["fallback_fire_rate"] = round(fallback_fires / n, 4)
        out["learned_ms_per_frame"] = round(t_lrn / n * 1e3, 3)
    return out


def landmark_analog(gt, h, w, pad: int = 20):
    """What the FaceMesh tier would emit: lip extremes ±20 px."""
    return (
        max(0, gt[0] - pad), max(0, gt[1] - pad),
        min(w, gt[2] + pad), min(h, gt[3] + pad),
    )


def run(n: int = 200, seed: int = 0, weights: Path = None) -> dict:
    import time

    from lipsync_tpu_torch.preprocessing import lip_localizer as ll

    localizer = None
    if weights is not None and Path(weights).exists():
        localizer = ll.LipLocalizer.load(Path(weights))
    elif ll.DEFAULT_WEIGHTS.exists():
        localizer = ll.LipLocalizer.load()

    rng = np.random.RandomState(seed)
    h, w = 240, 320
    ious_heur, ious_ref, ious_lrn = [], [], []
    ious_heur_gt, ious_ref_gt, ious_lrn_gt = [], [], []
    t_ref = t_lrn = 0.0
    refined_changed = 0
    for _ in range(n):
        face_w = int(rng.uniform(60, 140))
        cx = int(rng.uniform(face_w, w - face_w))
        cy = int(rng.uniform(face_w, h - face_w * 0.8))
        skin = tuple(
            float(c)
            for c in np.asarray((205, 170, 150)) * rng.uniform(0.55, 1.15)
        )
        lip = tuple(
            float(c)
            for c in np.asarray((150, 70, 70)) * rng.uniform(0.7, 1.2)
        )
        frame, face_box, gt = render_face(
            h, w, cx, cy, face_w, skin, lip,
            openness=rng.uniform(0, 1), noise=rng.uniform(0, 12), rng=rng,
        )
        target = landmark_analog(gt, h, w)
        fx1, fy1, fx2, fy2 = face_box
        heur = face_bbox_to_mouth_bbox(
            fx1, fy1, fx2 - fx1, fy2 - fy1, w, h
        )
        t0 = time.perf_counter()
        refined = refine_mouth_box(frame, heur)
        t_ref += time.perf_counter() - t0
        if refined != heur:
            refined_changed += 1
        ious_heur.append(bbox_iou(heur, target))
        ious_ref.append(bbox_iou(refined, target))
        ious_heur_gt.append(bbox_iou(heur, gt))
        ious_ref_gt.append(bbox_iou(refined, gt))
        if localizer is not None:
            t0 = time.perf_counter()
            learned = localizer.refine(frame, heur)
            t_lrn += time.perf_counter() - t0
            ious_lrn.append(bbox_iou(learned, target))
            ious_lrn_gt.append(bbox_iou(learned, gt))

    def stats(v):
        a = np.asarray(v)
        return {
            "mean": round(float(a.mean()), 4),
            "median": round(float(np.median(a)), 4),
            "p10": round(float(np.percentile(a, 10)), 4),
        }

    out = {
        "n_faces": n,
        "iou_vs_landmark_analog": {
            "heuristic": stats(ious_heur),
            "lip_refined": stats(ious_ref),
        },
        "iou_vs_raw_lips": {
            "heuristic": stats(ious_heur_gt),
            "lip_refined": stats(ious_ref_gt),
        },
        "refined_changed_frac": round(refined_changed / n, 3),
        "refine_ms_per_frame": round(t_ref / n * 1e3, 3),
    }
    if localizer is not None:
        out["iou_vs_landmark_analog"]["learned"] = stats(ious_lrn)
        out["iou_vs_raw_lips"]["learned"] = stats(ious_lrn_gt)
        out["learned_ms_per_frame"] = round(t_lrn / n * 1e3, 3)
    return out


def run_stride_sim(
    n_tracks: int = 100, n_frames: int = 60, seed: int = 0
) -> dict:
    """Detection-stride quality: simulated head-motion trajectories are
    tracked once per stride in {1, 2, 3, 5}; the coasted tracker's per-slot
    boxes are scored as IoU against the true trajectory. Quantifies the
    crop cost of `PredictorConfig.detection_stride` (the host-detection
    speedup is 1/stride by construction)."""
    from lipsync_tpu_torch.preprocessing.face_detection import Detection
    from lipsync_tpu_torch.preprocessing.tracker import StreamingTracker

    rng = np.random.RandomState(seed)
    h, w = 240, 320
    strides = (1, 2, 3, 5)
    ious = {s: [] for s in strides}
    for _ in range(n_tracks):
        # Smooth random walk: sinusoidal drift + jerk noise, face-scale
        # wobble — a caricature of conversational head motion at 15 fps.
        bw = rng.uniform(50, 90)
        cx = rng.uniform(bw, w - bw)
        cy = rng.uniform(bw, h - bw * 0.7)
        fx = rng.uniform(0.02, 0.12)  # motion frequency (cycles/frame)
        fy = rng.uniform(0.02, 0.12)
        ax = rng.uniform(2, 25)  # amplitude px
        ay = rng.uniform(2, 15)
        ph = rng.uniform(0, 6.28, size=2)
        jitter = rng.randn(n_frames, 2) * rng.uniform(0.2, 1.5)
        boxes = []
        for t in range(n_frames):
            x = cx + ax * np.sin(2 * np.pi * fx * t + ph[0]) + jitter[t, 0]
            y = cy + ay * np.sin(2 * np.pi * fy * t + ph[1]) + jitter[t, 1]
            s = bw * (1 + 0.08 * np.sin(2 * np.pi * 0.03 * t))
            boxes.append((
                int(x - s / 2), int(y - s / 2),
                int(x + s / 2), int(y + s / 2),
            ))
        for s in strides:
            st = StreamingTracker(h, w, detection_stride=s)
            for t, b in enumerate(boxes):
                if t % s == 0:
                    st.update([Detection(bbox=b)])
                else:
                    st.coast()
            # Score EVERY kept track against its own span of the truth
            # (fast motion can break the track; slot i of a re-acquired
            # track maps to absolute frame track_start_frame + i).
            for tr in st.finalize():
                for i, b in enumerate(tr.boxes):
                    t_abs = tr.track_start_frame + i
                    if t_abs < n_frames:
                        ious[s].append(bbox_iou(b, boxes[t_abs]))

    def stats(v):
        a = np.asarray(v)
        return {
            "mean": round(float(a.mean()), 4),
            "median": round(float(np.median(a)), 4),
            "p10": round(float(np.percentile(a, 10)), 4),
        }

    return {
        "n_tracks": n_tracks,
        "n_frames": n_frames,
        "tracked_box_iou_vs_truth_by_stride": {
            str(s): stats(v) for s, v in ious.items()
        },
    }


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(
        description="Mouth-crop agreement eval: heuristic vs lip-refined vs "
                    "landmark analog.")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--weights", type=Path, default=None,
                   help="lip-localizer npz (default: shipped weights)")
    p.add_argument(
        "--stride", action="store_true",
        help="run the detection-stride trajectory simulation instead",
    )
    p.add_argument(
        "--stress", action="store_true",
        help="run the held-out stress family (tilt/occlusion/lighting/blur)",
    )
    args = p.parse_args(argv)
    if args.stride:
        report = run_stride_sim(seed=args.seed)
    elif args.stress:
        report = run_stress(args.n, args.seed, weights=args.weights)
    else:
        report = run(args.n, args.seed, weights=args.weights)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        args.out.write_text(text)
    return report


if __name__ == "__main__":
    main()
