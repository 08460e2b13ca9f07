"""Micro-benchmark of the native Haar detection tier.

    python -m lipsync_tpu_torch.tools.bench_haar [--height 360] \
        [--width 640] [--iters 20]

The port's counterpart of the JAX package's script ``bench_haar``, with
its flags and printed lines, on the port's ``preprocessing/
face_detection.py::CascadeDetector`` (the native cascade evaluator). It
is host only: no device work. Prints per-call ms for the full-frame scan
and the ROI-tracked steady state at a production-like frame size; ``main``
also returns them with the number of faces found.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def make_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Noise background + skin-tone oval + mouth bar (the synthetic face
    pattern at production size)."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(30, 90, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * 0.5, w * 0.5
    face = ((yy - cy) / (h * 0.3)) ** 2 + ((xx - cx) / (w * 0.22)) ** 2 < 1
    frame[face] = (205, 170, 150)
    # eyes + mouth darken so the cascade has plausible structure
    for ey, ex in ((cy - h * 0.12, cx - w * 0.07), (cy - h * 0.12, cx + w * 0.07)):
        eye = ((yy - ey) ** 2 + (xx - ex) ** 2) < (h * 0.02) ** 2
        frame[eye] = (40, 30, 30)
    mouth = (np.abs(yy - (cy + h * 0.15)) < h * 0.02) & (
        np.abs(xx - cx) < w * 0.06
    )
    frame[mouth] = (120, 50, 50)
    return frame


def main(argv: Optional[List[str]] = None) -> dict:
    from lipsync_tpu_torch.preprocessing.face_detection import (
        CascadeDetector,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    frame = make_frame(args.height, args.width)
    det = CascadeDetector()

    det.detect(frame)  # warm (loads cascades, first full scan)

    det.reset()
    t_full = []
    for _ in range(args.iters):
        det.reset()  # force full-frame scan every call
        t0 = time.perf_counter()
        out = det.detect(frame)
        t_full.append(time.perf_counter() - t0)

    det.reset()
    det.detect(frame)  # seed ROI state
    t_roi = []
    roi_faces = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        roi_faces.append(len(det.detect(frame)))
        t_roi.append(time.perf_counter() - t0)

    print(
        f"frame {args.width}x{args.height}  faces={len(out)}\n"
        f"full-frame scan: p50 {np.median(t_full) * 1e3:7.2f} ms\n"
        f"ROI steady state: p50 {np.median(t_roi) * 1e3:7.2f} ms"
    )
    return {"faces": len(out), "roi_faces": roi_faces,
            "full_p50_ms": float(np.median(t_full) * 1e3),
            "roi_p50_ms": float(np.median(t_roi) * 1e3)}


if __name__ == "__main__":
    main()
