"""Learned lip localizer: a tiny regression CNN above the heuristic tier.

Counterpart of ``preprocessing/lip_localizer.py`` in the JAX package, for
inference only (its training branch comes with the training slice). A
~30k-parameter CNN regresses the raw lip extent inside the heuristic mouth
box; the reference's landmark tier pad of +-20 px is applied afterwards in
frame pixels. Inference is pure numpy (im2col convolutions as three small
matmuls), on the host detection path, with no device round-trip. Degenerate
predictions return the input box. The weights are the committed
``weights/lip_localizer.npz``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from lipsync_tpu_torch.preprocessing.face_detection import Detection
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

Box = Tuple[int, int, int, int]

PATCH = 32  # model input resolution
LANDMARK_PAD = 20  # the reference landmark tier's +-20 px
DEFAULT_WEIGHTS = (
    Path(__file__).resolve().parent.parent.parent
    / "weights" / "lip_localizer.npz"
)

# (name, cin, cout) for the three stride-2 3x3 conv stages: 32->16->8->4.
_CONV_STAGES = (("conv1", 3, 8), ("conv2", 8, 16), ("conv3", 16, 32))


def _conv3x3_s2(x, w, b):
    """3x3 stride-2 conv, explicit (1,1) zero padding, as one matmul.

    x: (N, H, W, Cin) with H, W even -> (N, H//2, W//2, Cout).
    w: (9*Cin, Cout) — tap-major layout (dy, dx, cin) flattened.
    """
    n, h, wd, c = x.shape
    ho, wo = h // 2, wd // 2
    xpad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    taps = [
        xpad[:, dy: dy + 2 * ho: 2, dx: dx + 2 * wo: 2, :]
        for dy in range(3)
        for dx in range(3)
    ]
    stacked = np.concatenate(taps, axis=-1)  # (N, Ho, Wo, 9*Cin)
    y = stacked.reshape(n * ho * wo, 9 * c) @ w + b
    return y.reshape(n, ho, wo, -1)


def forward(params: dict, patches: np.ndarray) -> np.ndarray:
    """(N, PATCH, PATCH, 3) float32 in [0,1] -> (N, 4) normalized boxes."""
    x = patches
    for name, _, _ in _CONV_STAGES:
        x = _conv3x3_s2(x, params[f"{name}_w"], params[f"{name}_b"])
        x = np.maximum(x, 0.0)
    x = x.reshape(x.shape[0], -1)
    x = np.maximum(x @ params["dense1_w"] + params["dense1_b"], 0.0)
    return x @ params["dense2_w"] + params["dense2_b"]


def _bilinear_resize(region: np.ndarray, size: int) -> np.ndarray:
    """(h, w, 3) float32 -> (size, size, 3) bilinear (host, numpy-only)."""
    h, w = region.shape[:2]
    ys = (np.arange(size) + 0.5) * (h / size) - 0.5
    xs = (np.arange(size) + 0.5) * (w / size) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = region
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def extract_patch(frame: np.ndarray, box: Box) -> Optional[np.ndarray]:
    """Resize the (heuristic mouth) box region to the model input.

    Returns (PATCH, PATCH, 3) float32 in [0,1], or None if the box is too
    small to carry evidence (caller falls back to the input box)."""
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box
    x1, y1 = max(0, int(x1)), max(0, int(y1))
    x2, y2 = min(w, int(x2)), min(h, int(y2))
    if x2 - x1 < 8 or y2 - y1 < 6:
        return None
    region = frame[y1:y2, x1:x2].astype(np.float32) / 255.0
    return _bilinear_resize(region, PATCH).astype(np.float32)


def norm_box_to_frame(norm: np.ndarray, box: Box, frame_h: int,
                      frame_w: int, pad: int = LANDMARK_PAD) -> Box:
    """Normalized patch-coords lip box -> padded frame-pixel mouth box
    (the ±20 px landmark analog, applied in FRAME pixels like the
    reference)."""
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    nx1, ny1, nx2, ny2 = [float(v) for v in norm]
    return (
        max(0, int(round(x1 + nx1 * bw)) - pad),
        max(0, int(round(y1 + ny1 * bh)) - pad),
        min(frame_w, int(round(x1 + nx2 * bw)) + pad),
        min(frame_h, int(round(y1 + ny2 * bh)) + pad),
    )


class LipLocalizer:
    """Numpy-inference wrapper around a trained parameter set."""

    def __init__(self, params: dict):
        self.params = {k: np.asarray(v, np.float32)
                       for k, v in params.items()}

    @classmethod
    def load(cls, path: Path = DEFAULT_WEIGHTS) -> "LipLocalizer":
        with np.load(path) as z:
            return cls({k: z[k] for k in z.files})

    def refine(self, frame: np.ndarray, box: Box) -> Box:
        """Heuristic mouth box -> landmark-analog mouth box (or the input
        box when evidence/prediction is weak)."""
        patch = extract_patch(frame, box)
        if patch is None:
            return box
        norm = forward(self.params, patch[None])[0]
        # Sanity: a plausible lip box is ordered, inside a loose patch
        # margin, and not degenerate. Anything else -> degradation ladder.
        nx1, ny1, nx2, ny2 = [float(v) for v in norm]
        if not (
            -0.25 <= nx1 < nx2 <= 1.25
            and -0.25 <= ny1 < ny2 <= 1.25
            and (nx2 - nx1) >= 0.08
            and (ny2 - ny1) >= 0.04
        ):
            return box
        return norm_box_to_frame(norm, box, frame.shape[0], frame.shape[1])


class LearnedLipBackend:
    """Detector-chain tier: inner detections' boxes re-localized by the
    CNN — the learned analog of :class:`LipRefinerBackend` (which it
    replaces in the default chain when weights are available)."""

    def __init__(self, inner, localizer: LipLocalizer):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "localizer", localizer)
        object.__setattr__(self, "name", f"{inner.name}+lipnet")

    def __getattr__(self, attr):  # pass through min_neighbors etc.
        return getattr(self.inner, attr)

    def __setattr__(self, attr, value):
        if attr in ("inner", "localizer", "name"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self.inner, attr, value)

    def reset(self) -> None:
        if hasattr(self.inner, "reset"):
            self.inner.reset()

    def detect(self, frame: np.ndarray) -> List[Detection]:
        out = []
        for d in self.inner.detect(frame):
            out.append(
                Detection(
                    bbox=self.localizer.refine(frame, d.bbox),
                    detector=f"{d.detector}+lipnet",
                    score=d.score,
                )
            )
        return out


def load_default_localizer() -> Optional[LipLocalizer]:
    """The shipped weights, or None (missing file / env-disabled)."""
    if os.environ.get("LIPSYNC_LIP_LOCALIZER", "1") == "0":
        return None
    if not DEFAULT_WEIGHTS.exists():
        return None
    try:
        return LipLocalizer.load(DEFAULT_WEIGHTS)
    except Exception as e:  # corrupt file must not kill detection
        logger.warning("lip localizer weights unusable: %s", e)
        return None
