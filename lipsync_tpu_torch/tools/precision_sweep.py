"""Where bf16 or fp16 may run in the model: each placement's largest and
mean |P(REAL) - fp32 P(REAL)|, and its forward time at batch 128, on one
card.

    python -m lipsync_tpu_torch.tools.precision_sweep

Inputs are the windows of the R2 and R3 requests that
``tests/test_torch_engine_card.py`` serves (``utils/synthetic.py``, seed 0). Weights come from the seed
(``seeded_state_dict``), as they are and with every BatchNorm calibrated
on R2's windows (``bn_calibrated_state_dict``); seeded logits barely vary,
calibrated ones spread. A placement runs the named submodules under
``torch.autocast`` in its dtype, each handing back fp32, and the rest in
fp32; ``served_bf16`` is ``LipSyncModel(dtype=torch.bfloat16)`` itself,
the engine's served path. TF32 is off throughout. Prints one JSON line per
set of weights, one of forward times, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from lipsync_tpu_torch.models import (
    LipSyncModel,
    ModelConfig,
    bn_calibrated_state_dict,
    seeded_state_dict,
)
from lipsync_tpu_torch.utils import synthetic
from lipsync_tpu_torch.utils.device import get_device

SEED = 0
VISUAL = "visual_encoder"
ARTIFACT_CONVS = ["artifact_detector.temporal_detector",
                  "artifact_detector.high_freq_detector"]
PIXEL_CONVS = [VISUAL] + ARTIFACT_CONVS

PLACEMENTS: Dict[str, Tuple[torch.dtype, List[str]]] = {
    "bf16_whole_model": (torch.bfloat16, [""]),
    "bf16_pixel_convs": (torch.bfloat16, PIXEL_CONVS),
    "bf16_visual_stem_only": (torch.bfloat16, [f"{VISUAL}.stem"]),
    "bf16_visual_layers1-4_artifact": (
        torch.bfloat16, [f"{VISUAL}.layer{i}" for i in (1, 2, 3, 4)]
        + ARTIFACT_CONVS),
    "bf16_visual_layers2-4_artifact": (
        torch.bfloat16, [f"{VISUAL}.layer{i}" for i in (2, 3, 4)]
        + ARTIFACT_CONVS),
    "fp16_pixel_convs": (torch.float16, PIXEL_CONVS),
}


def _autocast(module: nn.Module, dtype: torch.dtype) -> None:
    """Run ``module`` under autocast in ``dtype``, handing back fp32."""
    forward = module.forward

    def wrapped(*args, **kwargs):
        with torch.autocast("cuda", dtype=dtype):
            out = forward(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o.float() if torch.is_tensor(o) else o for o in out)
        return out.float()

    module.forward = wrapped


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = get_device(None)
    cfg = ModelConfig()
    reqs = synthetic.requests(SEED)
    r2 = synthetic.track_windows(reqs["R2"], device=dev)
    r3 = synthetic.track_windows(reqs["R3"], device=dev)
    visual, audio = (torch.cat(pair) for pair in zip(r2, r3))
    seeded = seeded_state_dict(LipSyncModel(cfg), SEED)
    weight_sets = {"bn_calibrated": bn_calibrated_state_dict(cfg, seeded, *r2),
                   "seeded": seeded}

    def model(weights, placement=None):
        dtype = torch.float32
        if placement == "served_bf16":
            dtype = torch.bfloat16
        m = LipSyncModel(cfg, dtype=dtype)
        m.load_state_dict(weights, strict=True)
        m.to(dev).eval()
        if placement in PLACEMENTS:
            low, paths = PLACEMENTS[placement]
            for path in paths:
                _autocast(m.get_submodule(path), low)
        return m

    def logits(m, batch=32):
        with torch.inference_mode():
            return torch.cat([m(visual[i : i + batch], audio[i : i + batch])
                              .float() for i in range(0, len(visual), batch)])

    names = ["served_bf16", *PLACEMENTS]
    for wname, weights in weight_sets.items():
        ref = logits(model(weights))
        p_ref = torch.sigmoid(ref)
        row = {"windows": len(ref), "logit_std_fp32": float(ref.std())}
        for name in names:
            d = (torch.sigmoid(logits(model(weights, name))) - p_ref).abs()
            row[name] = {"max_abs_dprob": float(d.max()),
                         "mean_abs_dprob": float(d.mean())}
        print(json.dumps({"weights": wname, **row}), flush=True)

    idx = torch.arange(128, device=dev) % len(visual)
    v128, a128 = visual[idx], audio[idx]

    def forward_ms(m, iters=5):
        with torch.inference_mode():
            for _ in range(2):
                m(v128, a128)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                m(v128, a128)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / iters

    calibrated = weight_sets["bn_calibrated"]
    times = {name: forward_ms(model(calibrated, name))
             for name in ["fp32", *names]}
    print(json.dumps({"forward_ms_batch128": times}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
