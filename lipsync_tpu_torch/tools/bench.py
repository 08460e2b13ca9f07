"""Benchmark driver: windows/s on the flagship model, on one card.

    python -m lipsync_tpu_torch.tools.bench [--device cpu]

The port's counterpart of the repo's root ``bench.py`` (which drives the
JAX package). It prints ONE JSON line on stdout, with the root driver's
keys in the same meanings, and its progress on stderr:

1. **Model path** (the headline ``value``): the served ``LipSyncModel``
   forward at the engine's placement (``inference/engine.py``: bf16 on
   the card, where the port places it: visual layers 3-4 and the artifact
   branch's convolutions; fp32 on the CPU) on device-resident inputs, one
   window and a batch of ``model_batch``.
2. **Engine path**: ``ScoringEngine.score_logits`` from host numpy (uint8
   windows in, fp32 logits out) under the pinned payload of the root
   driver's ENGINE PROBE CONTRACT: exactly 4 groups x 128 windows of
   (32, 96, 96, 3) uint8 + (80, 128) float32, ~474 MB a call. Do not
   resize it. Each timed call follows an upload of one group's bytes (the
   interleaved probe); ``engine_link_utilization`` is the median ratio of
   the engine's windows/s to the ceiling that probe gives.
3. **Track-gather path**: ``score_track_logits`` over one track's uint8
   crops (32 windows at stride 8), without and with shared visual encoding.
4. **Train step**: the production step (phase-3 optimizer, lr 1e-4 for the
   head and the encoders; on-device augmentation, ``AugmentConfig()``) at
   batch 32, on a device-resident uint8 batch and with the batch uploaded
   on every step. The port's step runs in fp32 with TF32 off, and it
   updates its state in place, where the JAX step is functional and the
   JAX driver times the same state on every call: here each timed call
   steps on from the last. The time per step is what is measured either
   way.

Every input is drawn from one ``np.random.RandomState(0)`` in the order the
root driver draws them, so each path gets the same arrays as there; the
audio is ``(B, 80, 128, 1)`` where that file adds ``[..., None]``. Weights
are ``models/bridge.py::seeded_state_dict(0)`` (the repo holds no trained
checkpoint). Each timed call is forced to finish by reading its result
back to the host, as the root driver forces it with ``np.asarray``; a time
is the median of the calls after one warm call.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call (one row
of the forward, times the batch; one whole train step), with K2 counted
as the convolutions its plain twin computes (``tools/profile_forward.py::
twins_for_counting``), so a kernel in a chain's place does not change the
count. It stands in for XLA's cost analysis, and counts convolutions,
matrix products and attention only. ``mfu`` and ``engine_mfu`` divide by
the card's bf16 tensor-core peak, ``train_mfu`` by its fp32 SIMT peak
(``utils/device.py::card_peaks``); the CPU has no published peak here, so
its MFUs read 0.0, as the root driver's placeholder peak gives there.

Numbers are printed unrounded (the root driver rounds them). Not ported:
the root driver's fall-back to the CPU when its accelerator is
unreachable (and the ``note`` it then prints): ``--device`` names the
device, and cuda:0 without CUDA raises; and JAX's persistent compilation
cache: the kernels build once per checkout (``ops/kernels/build.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import add_device_argument, sync

_T0 = time.perf_counter()


def _progress(msg: str) -> None:
    """Phase markers on stderr (stdout carries only the one JSON line)."""
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


class Sizes(NamedTuple):
    """The batches of a run and its repetitions (``iters`` for the model
    path; the engine, track and train paths take max(3, iters // 4),
    max(3, iters // 2) and max(5, iters // 2), as the root driver's)."""

    model_batch: int
    engine_batch: int
    iters: int
    train_batch: int


# The root driver's sizes on its accelerator and on the CPU. On the card
# the model batch is 1024, as there (PERF.md section 4 gives the forward's
# peak memory at that batch).
CARD = Sizes(model_batch=1024, engine_batch=128, iters=20, train_batch=32)
CPU = Sizes(model_batch=2, engine_batch=2, iters=3, train_batch=2)

TARGET = 100.0  # BASELINE.json north star, windows/s/chip


def _host(out) -> np.ndarray:
    """A call's result on the host (a device tensor read back)."""
    if isinstance(out, torch.Tensor):
        return out.float().cpu().numpy()
    return np.asarray(out)


def _measure(fn: Callable, *args, iters: int = 20) -> float:
    """Median seconds per call after one warm call; each call forced to
    finish by reading its result back to the host."""
    _host(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _host(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _counted_flops(fn: Callable, *args) -> float:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them, with K2's
    twin in its wrapper's place."""
    from torch.utils.flop_counter import FlopCounterMode

    from lipsync_tpu_torch.tools.profile_forward import twins_for_counting

    counter = FlopCounterMode(display=False)
    with twins_for_counting(), counter:
        _host(fn(*args))
    return float(counter.get_total_flops())


def _probe_host_link(device: torch.device) -> float:
    """MB/s of a 64 MB pageable uint8 host -> device upload."""
    buf = np.zeros((64 * 1024 * 1024,), np.uint8)
    torch.from_numpy(buf[:1024]).to(device)  # warm path
    sync(device)
    t0 = time.perf_counter()
    torch.from_numpy(buf).to(device)
    sync(device)
    return 64.0 / (time.perf_counter() - t0)


def run(cfg, device, sizes: Sizes,
        progress: Callable[[str], None] = _progress) -> dict:
    """Every path at ``sizes`` on ``device``; returns the JSON line's
    fields. ``progress`` gets the name of each path as it starts."""
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models import LipSyncModel, seeded_state_dict
    from lipsync_tpu_torch.ops.augment import AugmentConfig
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
    from lipsync_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )
    from lipsync_tpu_torch.utils.device import (
        device_peaks,
        disable_tf32,
        get_device,
    )

    device = get_device(device)
    disable_tf32()
    on_card = device.type == "cuda"
    card = device_peaks(device)
    peak = card.bf16 if card is not None else 0.0
    train_peak = card.fp32 if card is not None else 0.0
    if card is not None:
        progress(f"peaks: bf16 {peak:.4g} FLOP/s (mfu, engine_mfu), "
                 f"fp32 SIMT {train_peak:.4g} FLOP/s (train_mfu)")
    else:
        progress("no published peak for the CPU: the MFUs read 0.0")
    dtype = torch.bfloat16 if on_card else torch.float32
    rng = np.random.RandomState(0)

    def host_inputs(batch):
        v = rng.rand(batch, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3)
        a = rng.rand(batch, cfg.mel_bins, cfg.audio_frames) * 80.0 - 80.0
        return v.astype(np.float32), a.astype(np.float32)[..., None]

    def on_device(*arrays):
        return [torch.from_numpy(x).to(device) for x in arrays]

    v1h, a1h = host_inputs(1)
    progress("seeded weights")
    weights = seeded_state_dict(LipSyncModel(cfg), 0)
    model = LipSyncModel(cfg, dtype=dtype)
    model.load_state_dict(weights, strict=True)
    model.to(device).eval()

    def fwd(v, a):
        with torch.inference_mode():
            return model(v, a)

    # ---- model path (device-resident inputs) ----------------------------
    progress("single-window path")
    v1, a1 = on_device(v1h, a1h)
    p50_single = _measure(fwd, v1, a1, iters=sizes.iters)
    vbh, abh = host_inputs(sizes.model_batch)
    progress("batch path")
    vb, ab = on_device(vbh, abh)
    del vbh, abh
    p50_batch = _measure(fwd, vb, ab, iters=sizes.iters)
    model_wps = sizes.model_batch / p50_batch
    del vb, ab

    progress("flop count")
    flops_per_window = _counted_flops(fwd, v1, a1)
    mfu = flops_per_window * model_wps / peak if peak else 0.0

    progress("host link probe")
    link_mbps = _probe_host_link(device) if on_card else 0.0

    # ---- engine path (host numpy in, host numpy out) --------------------
    # 4 max_batch groups, so that the engine's streaming (groups kept in
    # flight, engine.max_in_flight) has something to overlap.
    progress("engine path")
    engine = ScoringEngine(weights, cfg, max_batch=sizes.engine_batch,
                           device=device)
    engine_windows = 4 * sizes.engine_batch
    veh, aeh = host_inputs(engine_windows)
    veh = (veh * 255.0).astype(np.uint8)
    engine_mb_per_call = veh.nbytes / 1e6 + aeh.nbytes / 1e6
    _host(engine.score_logits(veh, aeh))  # warm
    group = (veh[: sizes.engine_batch], aeh[: sizes.engine_batch])
    group_mb = sum(x.nbytes for x in group) / 1e6
    eng_times, eng_utils, eng_rates = [], [], []
    for _ in range(max(3, sizes.iters // 4)):
        rate = 0.0
        if on_card:  # one engine group's bytes, uploaded as the engine does
            sync(device)
            t0 = time.perf_counter()
            on_device(*group)
            sync(device)
            rate = group_mb / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        _host(engine.score_logits(veh, aeh))
        dt = time.perf_counter() - t0
        eng_times.append(dt)
        if rate > 0:
            # The path's floor per call on the link just measured is the
            # upload alone; a utilization near 1 says the link is full.
            ceil_wps = engine_windows / (engine_mb_per_call / rate)
            eng_utils.append((engine_windows / dt) / ceil_wps)
            eng_rates.append(rate)
    p50_engine = float(np.median(eng_times))
    engine_wps = engine_windows / p50_engine
    engine_mfu = flops_per_window * engine_wps / peak if peak else 0.0
    link_mbps_eng = float(np.median(eng_rates)) if eng_rates else 0.0
    engine_link_ceiling_wps = (
        engine_windows / (engine_mb_per_call / link_mbps_eng)
        if link_mbps_eng > 0 else 0.0)
    engine_link_utilization = (float(np.median(eng_utils)) if eng_utils
                               else 0.0)
    del veh, aeh, group

    # ---- track path (uint8 single upload + on-device gather) ------------
    n_windows = 32
    stride = 8  # the long-video window stride
    n_frames = (n_windows - 1) * stride + cfg.video_frames
    crops = (rng.rand(n_frames, cfg.crop_size, cfg.crop_size, 3) * 255
             ).astype(np.uint8)
    starts = [i * stride for i in range(n_windows)]
    audio_w = (rng.rand(n_windows, cfg.mel_bins, cfg.audio_frames) * 80 - 80
               ).astype(np.float32)
    progress("track gather path")
    track_iters = max(3, sizes.iters // 2)
    p50_track = _measure(engine.score_track_logits, crops, starts, audio_w,
                         iters=track_iters)
    track_wps = n_windows / p50_track

    progress("track shared-encoding path")
    engine_shared = ScoringEngine(weights, cfg, max_batch=sizes.engine_batch,
                                  shared_visual_encoding=True, device=device)
    p50_track_shared = _measure(engine_shared.score_track_logits, crops,
                                starts, audio_w, iters=track_iters)
    track_shared_wps = n_windows / p50_track_shared
    del engine, engine_shared, model

    # ---- train step ------------------------------------------------------
    progress("train step")
    train_model = LipSyncModel(cfg)
    train_model.load_state_dict(weights, strict=True)
    train_model.to(device)
    optimizer = PhaseOptimizer(train_model.named_parameters(), 3,
                               lr_head=1e-4, lr_encoder=1e-4)
    t_state = create_train_state(train_model, optimizer, seed=7)
    train_step = make_train_step(augment_cfg=AugmentConfig())
    vth, ath = host_inputs(sizes.train_batch)
    vt_u8 = (vth * 255.0).astype(np.uint8)
    labels_h = (rng.rand(sizes.train_batch) > 0.5).astype(np.float32)
    visual, audio, label = on_device(vt_u8, ath, labels_h)
    batch_dev = {"visual": visual, "audio": audio, "label": label}

    def step_device(state):
        return train_step(state, batch_dev)["loss"]

    def step_hostfed(state):
        visual, audio, label = on_device(vt_u8, ath, labels_h)
        return train_step(state, {"visual": visual, "audio": audio,
                                  "label": label})["loss"]

    train_iters = max(5, sizes.iters // 2)
    p50_train = _measure(step_device, t_state, iters=train_iters)
    p50_train_hostfed = _measure(step_hostfed, t_state, iters=train_iters)
    train_cps = sizes.train_batch / p50_train
    train_flops = _counted_flops(step_device, t_state)
    train_mfu = train_flops / p50_train / train_peak if train_peak else 0.0
    progress("done")

    return {
        "metric": "windows_per_sec_per_chip",
        "value": model_wps,
        "unit": "2s-windows/sec",
        "vs_baseline": model_wps / TARGET,
        "mfu": mfu,
        "flops_per_window": round(flops_per_window),
        # The primary engine metric: the utilization of the same-minute
        # link ceiling (absolute windows/s hold only against that rate).
        "engine_link_utilization": engine_link_utilization,
        "engine_windows_per_sec": engine_wps,
        "engine_mfu": engine_mfu,
        "engine_transfer_mb_per_call": engine_mb_per_call,
        "engine_probe_contract":
            "4x128 windows (32,96,96,3)u8+(80,128)f32, pinned r3",
        "host_link_mbps": link_mbps,
        "engine_link_mbps_interleaved": link_mbps_eng,
        "engine_link_ceiling_wps": engine_link_ceiling_wps,
        "engine_transfer_bound": bool(
            on_card and link_mbps_eng > 0
            and p50_engine > 0.5 * (engine_mb_per_call / link_mbps_eng)),
        "track_gather_windows_per_sec": track_wps,
        "track_shared_windows_per_sec": track_shared_wps,
        "train_step_ms": p50_train * 1e3,
        "train_clips_per_sec": train_cps,
        "train_mfu": train_mfu,
        "train_step_hostfed_ms": p50_train_hostfed * 1e3,
        "train_hostfed_clips_per_sec":
            sizes.train_batch / p50_train_hostfed,
        "train_batch": sizes.train_batch,
        "p50_single_window_ms": p50_single * 1e3,
        "p50_model_batch_ms": p50_batch * 1e3,
        "p50_engine_batch_ms": p50_engine * 1e3,
        "model_batch": sizes.model_batch,
        "engine_batch": sizes.engine_batch,
        "dtype": str(dtype).removeprefix("torch."),
        "platform": device.type,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.utils.device import get_device

    device = get_device(args.device)
    out = run(ModelConfig(), device,
              CARD if device.type == "cuda" else CPU)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
