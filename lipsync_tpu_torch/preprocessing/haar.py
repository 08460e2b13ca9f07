"""Haar cascade XML parsing and the ctypes binding of the native detector.

Counterpart of ``preprocessing/haar.py`` in the JAX package. OpenCV 5
dropped ``CascadeClassifier``, but the cascade data files still ship under
``/usr/share/opencv4/haarcascades``. This module parses the new-format
cascade XML (stageType BOOST, featureType HAAR) into flat numpy arrays and
runs the same native evaluator (``native/haar.cc``), compiled into
``build/lipsync_tpu_torch_native/`` with the Makefile's ``-mavx512f`` probe
(``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.utils import native

CASCADE_SEARCH_DIRS = [
    "/usr/share/opencv4/haarcascades",
    "/usr/share/opencv4/lbpcascades",
]


@dataclasses.dataclass
class HaarCascadeData:
    """Flat-array representation consumed by the native evaluator."""

    win_w: int
    win_h: int
    stage_thresholds: np.ndarray  # (S,) f32
    stage_first_weak: np.ndarray  # (S,) i32
    stage_nweak: np.ndarray  # (S,) i32
    weak_first_node: np.ndarray  # (W,) i32
    weak_first_leaf: np.ndarray  # (W,) i32
    node_left: np.ndarray  # (N,) i32  (negative = ~leaf index)
    node_right: np.ndarray  # (N,) i32
    node_feature: np.ndarray  # (N,) i32
    node_threshold: np.ndarray  # (N,) f32
    leaves: np.ndarray  # (L,) f32
    feat_nrects: np.ndarray  # (F,) i32
    feat_rects: np.ndarray  # (F, 3, 5) f32: x, y, w, h, weight


def find_cascade_file(name: str) -> Optional[Path]:
    for d in CASCADE_SEARCH_DIRS:
        p = Path(d) / name
        if p.exists():
            return p
    return None


def parse_cascade_xml(path: Path) -> HaarCascadeData:
    root = ET.parse(path).getroot()
    cascade = root.find("cascade")
    if cascade is None:
        raise ValueError(f"{path}: not a new-format cascade file")
    if cascade.findtext("featureType", "").strip() != "HAAR":
        raise ValueError(f"{path}: only HAAR cascades are supported")
    win_w = int(cascade.findtext("width"))
    win_h = int(cascade.findtext("height"))

    stage_thresholds: List[float] = []
    stage_first_weak: List[int] = []
    stage_nweak: List[int] = []
    weak_first_node: List[int] = []
    weak_first_leaf: List[int] = []
    node_left: List[int] = []
    node_right: List[int] = []
    node_feature: List[int] = []
    node_threshold: List[float] = []
    leaves: List[float] = []

    for stage in cascade.find("stages"):
        stage_thresholds.append(float(stage.findtext("stageThreshold")))
        stage_first_weak.append(len(weak_first_node))
        weaks = stage.find("weakClassifiers")
        stage_nweak.append(len(weaks))
        for weak in weaks:
            internal = [
                float(v)
                for v in weak.findtext("internalNodes").split()
            ]
            leaf_vals = [
                float(v) for v in weak.findtext("leafValues").split()
            ]
            n_nodes = len(internal) // 4
            weak_first_node.append(len(node_left))
            weak_first_leaf.append(len(leaves))
            for i in range(n_nodes):
                left, right, feat, thr = internal[4 * i : 4 * i + 4]
                node_left.append(int(left))
                node_right.append(int(right))
                node_feature.append(int(feat))
                node_threshold.append(thr)
            leaves.extend(leaf_vals)

    features = cascade.find("features")
    n_feat = len(features)
    feat_nrects = np.zeros(n_feat, np.int32)
    feat_rects = np.zeros((n_feat, 3, 5), np.float32)
    for fi, feat in enumerate(features):
        rects = feat.find("rects")
        feat_nrects[fi] = len(rects)
        for ri, r in enumerate(rects):
            vals = [float(v) for v in r.text.split()]
            feat_rects[fi, ri] = vals  # x y w h weight

    return HaarCascadeData(
        win_w=win_w,
        win_h=win_h,
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
        stage_first_weak=np.asarray(stage_first_weak, np.int32),
        stage_nweak=np.asarray(stage_nweak, np.int32),
        weak_first_node=np.asarray(weak_first_node, np.int32),
        weak_first_leaf=np.asarray(weak_first_leaf, np.int32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_feature=np.asarray(node_feature, np.int32),
        node_threshold=np.asarray(node_threshold, np.float32),
        leaves=np.asarray(leaves, np.float32),
        feat_nrects=feat_nrects,
        feat_rects=feat_rects,
    )


_lib = None


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = native.library("haar")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.haar_detect.argtypes = [
        u8, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f32, i32, i32, i32, i32, i32, i32, i32, f32, f32, i32, f32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32, ctypes.c_int64,
    ]
    lib.haar_detect.restype = ctypes.c_int64
    _lib = lib
    return lib


class HaarCascade:
    """A loaded cascade, callable on grayscale frames."""

    def __init__(self, xml_path: Path):
        self.data = parse_cascade_xml(xml_path)
        self.path = xml_path

    def detect(
        self,
        gray: np.ndarray,
        scale_factor: float = 1.08,
        min_neighbors: int = 3,
        min_size: int = 20,
        step: int = 2,
        max_out: int = 64,
    ) -> np.ndarray:
        """Detect on a (H, W) uint8 image -> (N, 4) int32 [x, y, w, h]."""
        lib = _get_lib()
        d = self.data
        gray = np.ascontiguousarray(gray, np.uint8)
        out = np.zeros((max_out, 4), np.int32)
        n = lib.haar_detect(
            gray, gray.shape[0], gray.shape[1],
            d.win_w, d.win_h, len(d.stage_thresholds),
            d.stage_thresholds, d.stage_first_weak, d.stage_nweak,
            d.weak_first_node, d.weak_first_leaf,
            d.node_left, d.node_right, d.node_feature, d.node_threshold,
            d.leaves, d.feat_nrects,
            np.ascontiguousarray(d.feat_rects.reshape(-1)),
            float(scale_factor), int(min_neighbors), int(min_size), int(step),
            out.reshape(-1), max_out,
        )
        return out[: max(0, int(n))]
