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


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def median_call_s(fn, device, iters: int = 10) -> float:
    """Median seconds per call of ``fn()`` after one warm call: each call
    between two CUDA events on the card (the device's time from the first
    launch to the last, host gaps included), on the host clock on the
    CPU."""
    import time

    import torch

    fn()
    sync(device)
    ts = []
    for _ in range(iters):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def forward_ab(cfg, arms, state_dict, batch: int, iters: int, device,
               dtype) -> dict:
    """The A/B of the benchmark tools: ``LipSyncModel`` forwards of one
    random batch (``np.random.RandomState(0)``: pixels in [0, 1), log-mel in
    [-80, 0) dB, as the JAX scripts draw them) under each arm's config
    (``arms``: ``(name, ModelConfig)`` pairs), on ``state_dict``. Each arm
    is warmed once, then timed ``iters`` times from the call to the logits
    read back to the host; returns per arm ``p50_s`` and its P(REAL) in
    float64."""
    import time

    import torch

    from lipsync_tpu_torch.models import LipSyncModel

    rng = np.random.RandomState(0)
    v = rng.rand(batch, cfg.video_frames, cfg.crop_size, cfg.crop_size,
                 3).astype(np.float32)
    a = (rng.rand(batch, cfg.mel_bins, cfg.audio_frames, 1) * 80
         - 80).astype(np.float32)
    vd = torch.from_numpy(v).to(device)
    ad = torch.from_numpy(a).to(device)
    out = {}
    for name, arm_cfg in arms:
        model = LipSyncModel(arm_cfg, dtype=dtype)
        model.load_state_dict(state_dict, strict=True)
        model.to(device).eval()

        def fwd():
            with torch.inference_mode():
                return model(vd, ad).float().cpu().numpy()

        fwd()  # warm: kernel builds, allocator, cuDNN plans
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            logits = fwd()
            times.append(time.perf_counter() - t0)
        out[name] = {"p50_s": float(np.median(times)),
                     "prob": 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))}
        del model
    return out


def model_weights(cfg, model_path=None, variables=None):
    """The weights of a benchmark tool: ``variables`` as given (a port
    ``state_dict`` or a JAX-layout tree), else those of ``model_path``
    (through ``load_engine`` on the CPU), else ``seeded_state_dict(0)``
    (the JAX scripts draw a random init); as a port ``state_dict``."""
    from lipsync_tpu_torch.inference.engine import _as_state_dict, load_engine
    from lipsync_tpu_torch.models import LipSyncModel, seeded_state_dict

    if variables is not None:
        return _as_state_dict(variables)
    if model_path is not None:
        return load_engine(model_path, config=cfg, use_bfloat16=False,
                           device="cpu").variables
    return seeded_state_dict(LipSyncModel(cfg), 0)
