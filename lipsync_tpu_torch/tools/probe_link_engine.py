"""Interleaved link-vs-engine utilization probe.

    python -m lipsync_tpu_torch.tools.probe_link_engine [--batch 128] \
        [--groups 4] [--iters 3]

The port's counterpart of the JAX package's script ``probe_link_engine``,
with its flags and printed lines. The host-to-device link's rate drifts
between measurements, so an engine throughput divided by a link rate taken
at another moment can be skewed by the drift. This probe alternates, back
to back per iteration:

  1. a raw copy of the engine payload's visual bytes (flat uint8) from the
     host into a buffer on ``--device``, then ``torch.cuda.synchronize``
     (the link alone, no model), and
  2. ``ScoringEngine.score_logits`` on the same payload (pad, upload,
     forward with K2, read back, in groups of ``--batch`` with
     ``max_in_flight`` groups enqueued),

so each iteration's utilization compares the engine against the link rate
measured just before. The model is ``ModelConfig()`` on
``models/bridge.py::seeded_state_dict(0)`` in the served bf16 placement
(fp32 on the CPU, where the "link" is a host copy).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import add_device_argument


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def raw_upload(flat: np.ndarray, device: torch.device) -> float:
    """Seconds to copy ``flat`` (uint8) into a fresh buffer on ``device``
    and wait for it."""
    t0 = time.perf_counter()
    buf = torch.empty(flat.shape, dtype=torch.uint8, device=device)
    buf.copy_(torch.from_numpy(flat))
    _sync(device)
    return time.perf_counter() - t0


def main(argv: Optional[List[str]] = None) -> dict:
    """Prints the JAX script's lines; returns each iteration's link MB/s,
    engine windows/s and utilization, and their median utilization."""
    p = argparse.ArgumentParser(
        description="Interleaved link-vs-engine utilization probe.")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--groups", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models import (
        LipSyncModel,
        ModelConfig,
        seeded_state_dict,
    )
    from lipsync_tpu_torch.utils.device import get_device

    device = get_device(args.device)
    cfg = ModelConfig()
    rng = np.random.RandomState(0)
    engine = ScoringEngine(seeded_state_dict(LipSyncModel(cfg), 0), cfg,
                           max_batch=args.batch, device=device)

    n = args.groups * args.batch
    veh = (rng.rand(n, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3)
           * 255).astype(np.uint8)
    aeh = (rng.rand(n, cfg.mel_bins, cfg.audio_frames) * 80 - 80
           ).astype(np.float32)
    mb = veh.nbytes / 1e6 + aeh.nbytes / 1e6
    print(f"payload {mb:.0f} MB ({n} windows, platform "
          f"{device.type})", flush=True)

    t0 = time.perf_counter()
    engine.score_logits(veh[: args.batch], aeh[: args.batch])
    print(f"engine warm (compile) {time.perf_counter() - t0:.1f}s",
          flush=True)
    flat = veh.reshape(-1)
    raw_upload(flat, device)

    utils, iters = [], []
    for it in range(args.iters):
        t_raw = raw_upload(flat, device)
        t0 = time.perf_counter()
        engine.score_logits(veh, aeh)
        t_eng = time.perf_counter() - t0
        rate = veh.nbytes / 1e6 / t_raw
        ceil = n / (mb / rate)
        util = (n / t_eng) / ceil
        utils.append(util)
        iters.append({"link_mb_per_s": rate,
                      "engine_windows_per_s": n / t_eng,
                      "ceiling_windows_per_s": ceil, "utilization": util})
        print(f"iter {it}: raw {t_raw:6.2f}s ({rate:6.1f} MB/s) | "
              f"engine {t_eng:6.2f}s ({n / t_eng:6.1f} w/s) | "
              f"ceiling {ceil:6.1f} w/s | util {util:.3f}", flush=True)
    median = float(np.median(utils))
    print(f"median interleaved utilization: {median:.3f}")
    return {"iters": iters, "median_utilization": median}


if __name__ == "__main__":
    main()
