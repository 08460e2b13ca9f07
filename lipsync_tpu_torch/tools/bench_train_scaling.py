"""Train-step batch-scaling curve: step ms / clips/s / MFU vs batch size.

    python -m lipsync_tpu_torch.tools.bench_train_scaling \
        [--batches 32,64,128,256,512] [--iters 12] [--out FILE] \
        [--device cuda:0]

The port's counterpart of the JAX package's script ``bench_train_scaling``,
with its flags and row keys (its ``--cpu`` is ``--device cpu`` here). It
measures the production train step — the phase-3 optimizer (every
parameter group, lr 1e-4), on-device augmentation (``AugmentConfig()``),
a device-resident uint8 batch: the ``--device-cache`` steady state — at
each batch size, with a FRESH model and optimizer per size (from the same
``models/bridge.py::seeded_state_dict(0)`` weights), so the knee can be
read off for the launchers' ``BATCH``.

The port's trainer trains in fp32 with TF32 off (``utils/device.py::
disable_tf32``); there is no bf16 step, so the report says ``float32`` and
MFU is against the card's fp32 (non-tensor-core) peak
(``utils/device.py::card_peaks``; null on the CPU, which has no published
peak here). ``flops_per_step`` is ``torch.utils.flop_counter.
FlopCounterMode`` over one whole step (forward, the sync loss's second
forward, backward): convolutions, matrix products and attention only.
``hbm_bytes_per_step`` and ``hbm_util`` read null: they were XLA's
"bytes accessed" estimate, which has no PyTorch counterpart.

A batch that does not fit in the card's memory (``torch.cuda.
OutOfMemoryError``) becomes a row with its ``error``, the cache is freed
and the sweep goes on; any other failure ends the run. ``first_call_s`` is
the first step (cuDNN plans, allocations); ``step_ms`` the median of
``--iters`` steps after a second, counted one, each read back (its loss)
on the host. The pixels are drawn as uint8 directly (the JAX script
scales a float64 draw: seconds of host time at batch 1024).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import add_device_argument, sync


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="32,64,128,256,512")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--out", type=Path, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)

    from torch.utils.flop_counter import FlopCounterMode

    from lipsync_tpu_torch.models import (
        LipSyncModel,
        ModelConfig,
        seeded_state_dict,
    )
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

    device = get_device(args.device)
    disable_tf32()
    cfg = ModelConfig()
    card = device_peaks(device)
    peak = card.fp32 if card is not None else 0.0

    weights = seeded_state_dict(LipSyncModel(cfg), 0)
    train_step = make_train_step(augment_cfg=AugmentConfig())
    rng = np.random.RandomState(0)

    rows = []
    for batch in [int(b) for b in args.batches.split(",")]:
        print(f"[scaling] batch {batch}: staging ...",
              file=sys.stderr, flush=True)
        v = rng.randint(0, 256, size=(batch, cfg.video_frames, cfg.crop_size,
                                      cfg.crop_size, 3), dtype=np.uint8)
        a = (rng.rand(batch, cfg.mel_bins, cfg.audio_frames, 1) * 80.0
             - 80.0).astype(np.float32)
        lab = (rng.rand(batch) > 0.5).astype(np.float32)
        state = batch_dev = model = optimizer = None
        failed = None
        try:
            batch_dev = {
                "visual": torch.from_numpy(v).to(device),
                "audio": torch.from_numpy(a).to(device),
                "label": torch.from_numpy(lab).to(device),
            }
            model = LipSyncModel(cfg)
            model.load_state_dict(weights, strict=True)
            model.to(device)
            optimizer = PhaseOptimizer(model.named_parameters(), 3,
                                       lr_head=1e-4, lr_encoder=1e-4)
            state = create_train_state(model, optimizer, seed=7)

            t0 = time.perf_counter()
            float(train_step(state, batch_dev)["loss"])
            compile_s = time.perf_counter() - t0
            counter = FlopCounterMode(display=False)
            with counter:
                float(train_step(state, batch_dev)["loss"])
            flops = float(counter.get_total_flops())
            times = []
            for _ in range(args.iters):
                sync(device)
                t0 = time.perf_counter()
                float(train_step(state, batch_dev)["loss"])
                times.append(time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            failed = str(e).splitlines()[0][:200]
        if failed is not None:
            # Freed here, outside the handler, whose traceback still holds
            # the failed step's tensors.
            print(f"[scaling] batch {batch}: FAILED ({failed})",
                  file=sys.stderr, flush=True)
            rows.append({"batch": batch, "error": failed})
            state = batch_dev = model = optimizer = None
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        p50 = float(np.median(times))
        row = {
            "batch": batch,
            "step_ms": p50 * 1e3,
            "clips_per_sec": batch / p50,
            "mfu": flops / p50 / peak if peak and flops else None,
            "flops_per_step": round(flops) if flops else None,
            "hbm_bytes_per_step": None,
            "hbm_util": None,
            "first_call_s": compile_s,
        }
        print(f"[scaling] {row}", file=sys.stderr, flush=True)
        rows.append(row)
        state = batch_dev = model = optimizer = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    out = {"platform": device.type, "dtype": "float32", "rows": rows}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        args.out.write_text(text)
    return out


if __name__ == "__main__":
    main()
