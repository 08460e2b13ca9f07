"""What the operational tools share: the ``--device`` flag, the line
between a file that a host stage could not use, which a tool records and
skips, and every other failure, which ends the run; and a stub engine for
the harnesses that can check their host stages without a model.

The JAX package's scripts catch every exception per file. Copied as they
are, a kernel that fails to build or launch on the card would read as "0
clips precomputed" or as an evaluation full of error rows: the kernel
wrappers raise ``RuntimeError`` and ``ValueError``, as ingest does for a
file it cannot decode. So the tools skip a file only when the failure
came out of a host stage (:func:`host_stage_failed`, which lives in
``preprocessing/ingest.py`` so that the raw-video dataset draws the same
line).
"""

from __future__ import annotations

import argparse

import numpy as np

from lipsync_tpu_torch.preprocessing.ingest import (  # noqa: F401
    HostStageError,
    host_stage_failed,
)


def add_device_argument(p: argparse.ArgumentParser) -> None:
    """``--device``, ``cuda:0`` by default (raises where CUDA is absent):
    where the crops, the log-mel and the model run."""
    p.add_argument("--device", default="cuda:0",
                   help="torch device for the device work (default: cuda:0; "
                        "'cpu' runs the kernels' plain twins on the CPU)")


class StubEngine:
    """A deterministic scorer in place of the model, for checking the
    host stages (detection, tracking, attribution) without weights: P(REAL)
    from a per-call script, else from the window's mean pixel value. The
    same stub as the JAX package's predictor tests."""

    def __init__(self, script=None):
        from lipsync_tpu_torch.inference.calibration import Calibrator
        from lipsync_tpu_torch.models import ModelConfig

        self.script = list(script) if script else None
        self.calls = []
        self.calibrator = Calibrator()
        self.config = ModelConfig(video_frames=8, crop_size=32, mel_bins=80,
                                  audio_frames=32)

    def score_probs(self, visual, audio):
        n = visual.shape[0]
        self.calls.append(n)
        if self.script is not None:
            out = [
                self.script.pop(0) if self.script else 0.5 for _ in range(n)
            ]
            return np.asarray(out, np.float32)
        base = visual.reshape(n, -1).mean(axis=1)
        return np.clip(0.2 + base, 0.0, 1.0).astype(np.float32)

    def score_logits(self, visual, audio):
        p = self.score_probs(visual, audio)
        return np.log(p / (1 - p))
