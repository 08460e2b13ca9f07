"""Per-submodule timing of the flagship forward.

    python -m lipsync_tpu_torch.tools.profile_forward [--batch 512] \
        [--iters 10] [--artifact-detail] [--device cuda:0]

The port's counterpart of the JAX package's script ``profile_forward``,
with its flags and report keys. It times each stage of ``ModelConfig()``
standalone at the production batch and precision (visual encoder, audio
encoder, projection, cross-modal attention, temporal transformer, artifact
branch, classifier head), compares their sum against the whole forward,
and reports each stage's MFU. ``--artifact-detail`` adds the artifact
branch's sub-stages: the temporal detector, the high-frequency detector
(K2 in eval mode), the Laplacian and the two high-frequency convolutions.
Writes one JSON report to stdout.

On the card the stages run in the port's bf16 placement (the served
``LipSyncModel(dtype=bfloat16)``): visual layers 3-4 and the artifact
branch's convolutions in bf16, everything else in fp32 with fp32
parameters; the full forward is the served one. On the CPU (``--device
cpu``) everything is fp32 at batch 2, as the JAX script runs there.

Every stage is in eval mode, with PyTorch's default initialisation after
``torch.manual_seed(0)``. Its inputs are drawn as the JAX script draws
them, in the same order from ``np.random.RandomState(0)`` and with the
same shapes (the projection's inputs are ``(B, D, T)``; its Linear layers
take the last axis, as flax's ``Dense`` infers it: the same operations as
the served ``(B, T, D)``, since ``T * D = D * T``).

Numbers are printed unrounded (the JAX script rounds them). Timing: one
warm call, then ``--iters`` calls, each between two CUDA events
(host clock on the CPU); the median. ``rtt_floor_ms`` is one trivial
launch plus ``torch.cuda.synchronize``, timed on the host clock: the floor
of a timed call. ``gflops`` is ``torch.utils.flop_counter.FlopCounterMode``
over one call on the stage's first row, times the batch (every stage is
per-sample): it counts convolutions, matrix products and attention only
(no elementwise work, normalisation or softmax), with K2 counted through
its plain twin, which computes the same function with convolutions. MFU is
FLOPs over time over the card's bf16 tensor-core peak
(``utils/device.py::card_peaks``); the CPU has no published peak here, so
there it reads null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import (
    add_device_argument,
    median_call_s,
    sync,
)


def rtt_floor(x: torch.Tensor, iters: int = 10) -> float:
    """Median seconds of one trivial launch plus a synchronize."""
    ts = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        x[:1, :1, :1, :1] * 1.0
        sync(x.device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:]))


@contextlib.contextmanager
def twins_for_counting():
    """K2's plain twin in its wrapper's place while FLOPs are counted (a
    ctypes launch is invisible to the counter); its launch counter does
    not move."""
    from lipsync_tpu_torch.models import artifact as artifact_mod
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2

    saved = artifact_mod.hf_stem
    artifact_mod.hf_stem = k2.hf_stem_plain
    try:
        yield
    finally:
        artifact_mod.hf_stem = saved


def flops_per_call(fn, batch: int) -> float:
    """FLOPs of ``fn(rows=1)`` (convolutions, matrix products, attention)
    times ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with twins_for_counting(), counter:
        fn(1)
    return float(counter.get_total_flops()) * batch


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--artifact-detail", action="store_true",
                   help="additionally profile the artifact branch's "
                        "sub-stages (temporal detector, the high-frequency "
                        "detector with K2, the Laplacian conv, HF "
                        "conv1/conv2)")
    add_device_argument(p)
    args = p.parse_args(argv)

    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.models.artifact import (
        ArtifactDetector,
        HighFrequencyDetector,
        TemporalInconsistencyDetector,
        _laplacian_kernel_3ch,
    )
    from lipsync_tpu_torch.models.audio_encoder import AudioEncoder
    from lipsync_tpu_torch.models.classifier import ClassificationHead
    from lipsync_tpu_torch.models.fusion import (
        CrossModalAttention,
        FeatureProjection,
    )
    from lipsync_tpu_torch.models.layers import ConvBNAct, compute_in
    from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel
    from lipsync_tpu_torch.models.temporal import TemporalTransformer
    from lipsync_tpu_torch.models.visual_encoder import VisualEncoder
    from lipsync_tpu_torch.utils.device import (
        device_peaks,
        disable_tf32,
        get_device,
    )

    device = get_device(args.device)
    disable_tf32()
    cfg = ModelConfig()
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    card = device_peaks(device)
    peak = card.bf16 if card is not None else 0.0
    b = args.batch if on_card else 2
    rng = np.random.RandomState(0)
    torch.manual_seed(0)

    def put(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    visual = put(rng.rand(b, cfg.video_frames, cfg.crop_size,
                          cfg.crop_size, 3))
    audio = put(rng.rand(b, cfg.mel_bins, cfg.audio_frames, 1) * 80 - 80)
    t_tokens = cfg.video_frames
    tokens = put(rng.rand(b, t_tokens, cfg.embed_dim))
    v_feat = put(rng.rand(b, cfg.visual_feature_dim, t_tokens))
    a_feat = put(rng.rand(b, cfg.audio_feature_dim, t_tokens))
    v_map = put(rng.rand(b, t_tokens, 3, 3, cfg.visual_feature_dim), dtype)
    cls_vec = put(rng.rand(b, cfg.embed_dim))
    combined = put(rng.rand(b, cfg.embed_dim + 128))
    vid = visual.to(dtype)

    stages = {}

    def add(name, module, call, *inputs):
        """Times ``call(module, *inputs)`` and counts its FLOPs on one row
        of each input."""
        print(f"[profile] {name}...", file=sys.stderr, flush=True)
        module = module.to(device).eval()

        def run(rows=None):
            with torch.inference_mode():
                return call(module, *(x if rows is None else x[:rows]
                                      for x in inputs))

        t = median_call_s(run, device, iters=args.iters)
        f = flops_per_call(run, b)
        stages[name] = {
            "ms": t * 1e3,
            "gflops": f / 1e9,
            "mfu": f / t / peak if peak and f else None,
        }
        print(f"[profile] {name}: {json.dumps(stages[name])}",
              file=sys.stderr, flush=True)

    add("visual_encoder", VisualEncoder(cfg.visual_feature_dim),
        lambda m, v: m(v, return_map=True, dtype=dtype), visual)
    add("audio_encoder",
        AudioEncoder(cfg.audio_feature_dim,
                     preserve_audio_temporal=True), lambda m, a: m(a), audio)
    add("projection",
        FeatureProjection(t_tokens, t_tokens, cfg.embed_dim),
        lambda m, v, a: m(v, a), v_feat, a_feat)
    add("cross_modal",
        CrossModalAttention(cfg.embed_dim, cfg.cross_modal_heads),
        lambda m, x, y: m(x, y), tokens, tokens)
    add("temporal",
        TemporalTransformer(cfg.embed_dim, cfg.temporal_heads,
                            cfg.temporal_layers),
        lambda m, x: m(x), tokens)
    add("artifact",
        ArtifactDetector(cfg.visual_feature_dim, cfg.embed_dim),
        lambda m, vm, c, raw: m(vm, c, raw_video=raw), v_map, cls_vec, vid)
    add("classifier", ClassificationHead(cfg.embed_dim + 128, 128),
        lambda m, x: m(x), combined)

    if args.artifact_detail:
        def in_dtype(m, x):
            with compute_in(x):
                return m(x)

        def frames_conv(m, v):
            frames = v.reshape(-1, cfg.crop_size, cfg.crop_size, 3)
            return in_dtype(m, frames.permute(0, 3, 1, 2))

        laplacian = torch.nn.Conv2d(3, 3, 3, padding=1, bias=False)
        with torch.no_grad():
            laplacian.weight.copy_(_laplacian_kernel_3ch())
        add("artifact/temporal_detector",
            TemporalInconsistencyDetector(cfg.visual_feature_dim),
            lambda m, x: m(x), v_map)
        add("artifact/high_freq", HighFrequencyDetector(64),
            lambda m, x: m(x), vid)
        add("artifact/hf_laplacian", laplacian, frames_conv, vid)
        add("artifact/hf_conv1",
            ConvBNAct(3, 32, (3, 3, 3), (1, 2, 2), (1, 1, 1), bias=True),
            lambda m, x: in_dtype(m, x.permute(0, 4, 1, 2, 3)), vid)
        hf1 = put(rng.rand(b, cfg.video_frames, cfg.crop_size // 2,
                           cfg.crop_size // 2, 32), dtype)
        add("artifact/hf_conv2",
            ConvBNAct(32, 64, (3, 3, 3), (1, 2, 2), (1, 1, 1), bias=True),
            lambda m, x: in_dtype(m, x.permute(0, 4, 1, 2, 3)), hf1)

    model = LipSyncModel(cfg, dtype=dtype).to(device).eval()

    def full(rows=None):
        with torch.inference_mode():
            if rows is None:
                return model(visual, audio)
            return model(visual[:rows], audio[:rows])

    t_full = median_call_s(full, device, iters=args.iters)
    f_full = flops_per_call(full, b)
    floor = rtt_floor(visual, iters=args.iters)

    total_stage_ms = sum(s["ms"] for s in stages.values())
    report = {
        "batch": b,
        "platform": device.type,
        "dtype": str(dtype).removeprefix("torch."),
        "rtt_floor_ms": floor * 1e3,
        "stages": stages,
        "full_forward_ms": t_full * 1e3,
        "full_gflops": f_full / 1e9,
        "full_mfu": f_full / t_full / peak if peak and f_full else None,
        "sum_of_stages_ms": total_stage_ms,
        "fusion_gain_ms": total_stage_ms - t_full * 1e3,
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
