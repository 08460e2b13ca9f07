"""Bulk scoring of precomputed Auto-AVSR inputs: a closed loop, one caller.

Each call is ``ScoringEngine.score_logits`` on 1,024 windows of the
configuration's model (Auto-AVSR's audio-visual conformer with a detection
head), each a uint8 grey ``(96, 96, 96)`` mouth crop stack (96 frames,
3.84 s at 25 fps) with its 61,440 fp32 PCM samples at 16 kHz: four groups
of the engine's ``max_batch`` 256, two of them in flight. The windows of a
call are a block of 1,024 consecutive windows of a pool of 2,048 (1.8 GB
of crops and 0.5 GB of PCM) made in set-up, at an offset drawn from the
seed, as in ``bulk_windows``. The PCM is seeded speech-like noise: noise
coloured by a short smoothing filter, under a syllable-rate envelope, at a
level of its own per window. This is what evaluation harnesses and archive
re-scans send when they score sentence-length audio-visual segments in
bulk with a detector built on an AVSR conformer: no host stage of
``predict``.

``correct``: once the window has closed the engine is freed and the plain
reference (``benchmark/reference/auto_avsr.py``) scores two of the
window's groups of 256, drawn from the seed, at the precision the
configuration states, in blocks of 64 windows (a group of 256 at 96
frames would hold ~45 GB of fp32 intermediates at once; at the
configuration's bf16 the block changes nothing, and for the control an
int8 activation scale is a block's); the widest gap between a window's
logit from the engine and the reference's is compared with the
configuration's limit.
"""

from __future__ import annotations

import gc
import math
from typing import List

import numpy as np
import torch

from benchmark.reference import auto_avsr as ref
from benchmark.reference.model import lower
from benchmark.traffic import bulk_windows as bulk

PRECISION = bulk.PRECISION
SPANS = bulk.SPANS
POOL, CALL, GROUP = bulk.POOL, bulk.CALL, bulk.GROUP
CALIBRATION_WINDOWS = 32
REF_BLOCK = 64
SAMPLE_RATE = 16000

window = bulk.window
end_to_end = bulk.end_to_end


def speechish(gen, k: int, samples: int, dev) -> torch.Tensor:
    """``(k, 1, samples)`` fp32: white noise through a 16-tap smoothing
    filter (most of its power under ~2 kHz), under an envelope that rises
    and falls at 2-6 Hz (syllables) with a floor of 0.1, at a level drawn
    per window in [0.02, 0.3]."""
    noise = torch.randn(k, 1, samples + 15, generator=gen, device=dev)
    taps = torch.hann_window(16, periodic=False, device=dev)
    voiced = torch.nn.functional.conv1d(noise, (taps / taps.sum()).view(
        1, 1, 16))
    t = torch.arange(samples, device=dev) / SAMPLE_RATE
    rate = 2 + 4 * torch.rand(k, 1, 1, generator=gen, device=dev)
    phase = 2 * math.pi * torch.rand(k, 1, 1, generator=gen, device=dev)
    envelope = 0.1 + 0.9 * torch.sin(2 * math.pi * rate * t + phase).abs()
    level = 0.02 + 0.28 * torch.rand(k, 1, 1, generator=gen, device=dev)
    out = voiced * envelope
    return out * (level / out.pow(2).mean(dim=-1, keepdim=True).sqrt())


def make_pool(ctx, n: int):
    """``n`` windows on the host, made on the device from the seed: grey
    uint8 pixels (uniform noise darkened per window by a factor in
    [1/4, 1]) and speech-like PCM (:func:`speechish`)."""
    g = ref.geometry(ctx.config["model"])
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.subseed("pool"))
    shape = (g["frames"], g["crop"], g["crop"])
    visual = torch.empty((n,) + shape, dtype=torch.uint8)
    pcm = torch.empty((n, 1, g["samples"]), dtype=torch.float32)
    step = 256
    for lo in range(0, n, step):
        k = min(step, n - lo)
        noise = torch.randint(0, 256, (k,) + shape, generator=gen,
                              device=dev, dtype=torch.int16)
        level = torch.randint(64, 257, (k, 1, 1, 1), generator=gen,
                              device=dev, dtype=torch.int16)
        visual[lo:lo + k] = (noise * level // 256).to(torch.uint8).cpu()
        pcm[lo:lo + k] = speechish(gen, k, g["samples"], dev).cpu()
    return visual.numpy(), pcm.numpy()


def setup(ctx):
    # A program without the model fails here, before any work.
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models.auto_avsr import AutoAVSRConfig

    cfg = ctx.config
    pool, call, group = bulk._sizes(ctx)
    visual, pcm = make_pool(ctx, pool)
    ctx.note("pool")
    weights = ref.make_weights(cfg["model"], ctx.subseed("weights"),
                               ctx.device)
    k = min(CALIBRATION_WINDOWS, pool)
    ref.calibrate(weights, cfg["model"],
                  torch.from_numpy(visual[:k]).to(ctx.device).float() / 255,
                  torch.from_numpy(pcm[:k]).to(ctx.device))
    ctx.note("weights")
    eng = cfg["engine"]
    engine = ScoringEngine(
        weights, AutoAVSRConfig(**cfg["model"]),
        use_bfloat16=eng["use_bfloat16"], max_batch=group,
        max_in_flight=eng["max_in_flight"], device=ctx.device)
    if "altered_answer" in ctx.faults:  # a logit altered where it is made
        inner = engine.dispatch_logits

        def altered(v, a):
            out = inner(v, a)
            return torch.cat([out[:1] + 1.0, out[1:]])

        engine.dispatch_logits = altered
    ctx.note("engine")
    for i in range(2):  # every shape of the window: groups of `group`
        engine.score_logits(visual[:call], pcm[:call])
        ctx.note(f"warm-up call {i}")
    ctx.spans.wrap(engine, "dispatch_logits", "dispatch_logits")
    # "mel": the key under which bulk_windows' window reads the audio.
    return {"engine": engine, "weights": weights, "visual": visual,
            "mel": pcm, "rng": np.random.RandomState(
                ctx.subseed("offsets") % 2 ** 32)}


def _reference(state, ctx, precision) -> List[np.ndarray]:
    _, _, group = bulk._sizes(ctx)
    out = []
    for c, g in state["picks"]:
        off = state["calls"][c][0] + g * group
        v = torch.from_numpy(state["visual"][off:off + group]).to(ctx.device)
        a = torch.from_numpy(state["mel"][off:off + group]).to(ctx.device)
        out.append(ref.logits_in_blocks(state["weights"], ctx.config["model"],
                                        v, a, precision,
                                        min(REF_BLOCK, group))
                   .cpu().numpy())
    return out


def check(state, ctx):
    """Frees the engine, then the widest logit gap over the sample."""
    state.pop("engine", None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    _, _, group = bulk._sizes(ctx)
    state["picks"] = bulk._sample(state, ctx)
    state["ref"] = _reference(state, ctx, ctx.config[PRECISION])
    gaps = []
    for (c, g), r in zip(state["picks"], state["ref"]):
        got = state["calls"][c][1][g * group:(g + 1) * group]
        gaps.append(float(np.max(np.abs(got - r))))
    return [("logit_gap", max(gaps), ctx.config["limits"]["logit_gap"])]


def control(state, ctx, precision=None):
    """The same comparison with the reference at one precision step below
    the configuration's (or at ``precision``) in the engine's place (after
    :func:`check`)."""
    low = _reference(state, ctx, precision or lower(ctx.config[PRECISION]))
    gap = max(float(np.max(np.abs(lo - r)))
              for lo, r in zip(low, state["ref"]))
    return [("logit_gap", gap, ctx.config["limits"]["logit_gap"])]
