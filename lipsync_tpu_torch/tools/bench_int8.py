"""A/B throughput of the served (default) vs int8-conv model forward.

    python -m lipsync_tpu_torch.tools.bench_int8 [--batch 512] [--iters 10] \
        [--tiny] [--device cuda:0]

The port's counterpart of the JAX package's script ``bench_int8``, with
its flags and report keys. It times the flagship forward at a fixed batch
under both conv lowerings (``ModelConfig.conv_lowering``: ``conv`` and
``int8``), plus max |dprob| between them on the same random batch. On the
card both arms run the served bf16 placement (``LipSyncModel(dtype=
bfloat16)``), and the int8 arm runs K4 (the per-tensor quantize) then K3
(the int8 convolution with its dequantizing epilogue) at each of the 24
encoder convolutions; attention and MLP stages are unchanged. On the CPU
(``--device cpu``) both arms are fp32 and the kernels' twins run.
``--tiny`` swaps in the test-sized config (8 frames, 32 px, 32 mel
frames).

The weights are ``models/bridge.py::seeded_state_dict(0)`` (the JAX script
draws a random init); ``main(..., variables=)`` takes others. Each time is
the median over ``--iters`` calls, from the call to the logits read back
on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import (
    add_device_argument,
    forward_ab,
    model_weights,
)


def main(argv: Optional[List[str]] = None, variables=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tiny", action="store_true")
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
    weights = model_weights(cfg, variables=variables)

    res = forward_ab(
        cfg, [(lowering, dataclasses.replace(cfg, conv_lowering=lowering))
              for lowering in ("conv", "int8")],
        weights, args.batch, args.iters, device, dtype)
    out = {"batch": args.batch, "platform": device.type,
           "dtype": str(dtype).removeprefix("torch.")}
    for lowering, r in res.items():
        out[f"{lowering}_p50_ms"] = r["p50_s"] * 1e3
        out[f"{lowering}_windows_per_sec"] = args.batch / r["p50_s"]
    out["speedup"] = (out["int8_windows_per_sec"]
                      / out["conv_windows_per_sec"])
    out["max_dprob"] = float(
        np.abs(res["conv"]["prob"] - res["int8"]["prob"]).max())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
