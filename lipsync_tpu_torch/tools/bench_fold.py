"""A/B of the HF-stem Laplacian fold (``ModelConfig.hf_stem_fold``).

    python -m lipsync_tpu_torch.tools.bench_fold [--batch 256] \
        [--iters 10] [--model-path FILE] [--tiny] [--device cuda:0]

The port's counterpart of the JAX package's script ``bench_fold``, with
its flags and report keys (its ``--cpu`` is ``--device cpu`` here). The
artifact branch's high-frequency detector runs a fixed per-frame
Laplacian then a 3->32 Conv3d. Unfolded ("sequential"), eval mode runs
the pair with BatchNorm and ReLU as one launch of K2; folded,
``models/artifact.py::compose_spatial`` composes the pair into ONE (3, 5,
5) Conv3d and no K2 runs. This measures what that buys end to end —
full-model forward p50 both ways at a serving batch — plus the numeric
deviation max / mean |dprob| between the lowerings on the same batch (the
fold's border rows and columns see a different implicit padding).

On the card both arms run the served bf16 placement; on the CPU both are
fp32 with K2's twin. ``--model-path`` runs the A/B on trained weights (a
``.pth`` state dict, a port checkpoint directory or a JAX-layout ``.npz``,
as ``load_engine`` reads them); the default is
``models/bridge.py::seeded_state_dict(0)`` (the JAX script draws a random
init). Each time is the median over ``--iters`` calls, from the call to
the logits read back on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import (
    add_device_argument,
    forward_ab,
    model_weights,
)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--model-path", type=Path, default=None,
                    help="trained weights (.pth, a port checkpoint "
                         "directory or a JAX-layout .npz); default: "
                         "seeded random weights")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.utils.device import disable_tf32, get_device

    device = get_device(args.device)
    disable_tf32()
    cfg = ModelConfig()
    if args.tiny:
        cfg = dataclasses.replace(
            cfg, video_frames=8, crop_size=32, audio_frames=32
        )
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    weights = model_weights(cfg, model_path=args.model_path)

    res = forward_ab(
        cfg, [(name, dataclasses.replace(cfg, hf_stem_fold=fold))
              for name, fold in (("sequential", False), ("folded", True))],
        weights, args.batch, args.iters, device, dtype)
    out = {"batch": args.batch, "platform": device.type,
           "dtype": str(dtype).removeprefix("torch."),
           "weights": str(args.model_path) if args.model_path else "random"}
    for name, r in res.items():
        out[f"{name}_p50_ms"] = r["p50_s"] * 1e3
        out[f"{name}_windows_per_sec"] = args.batch / r["p50_s"]
    out["speedup"] = (out["folded_windows_per_sec"]
                      / out["sequential_windows_per_sec"])
    dp = np.abs(res["sequential"]["prob"] - res["folded"]["prob"])
    out["max_dprob"] = float(dp.max())
    out["mean_dprob"] = float(dp.mean())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
