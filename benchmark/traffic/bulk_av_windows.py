"""Bulk scoring of precomputed AV-HuBERT inputs: a closed loop, one caller.

Each call is ``ScoringEngine.score_logits`` on 1,024 windows of the
configuration's model (AV-HuBERT LARGE with a detection head), each a uint8
grey ``(32, 96, 96)`` mouth crop with an fp32 ``(26, 128)`` log-mel in dB:
four groups of the engine's ``max_batch`` 256, two of them in flight. The
windows of a call are a block of 1,024 consecutive windows of a pool of
2,048 (about 0.6 GB of crops) made in set-up, at an offset drawn from the
seed, as in ``bulk_windows``. This is what evaluation harnesses and archive
re-scans send when they score AV-HuBERT-style inputs (grey mouth ROIs and
filterbanks) in bulk: no host stage of ``predict``.

``correct``: once the window has closed the engine is freed and the plain
reference (``benchmark/reference/avhubert.py``) scores two of the window's
groups of 256, drawn from the seed, at the precision the configuration
states; the widest gap between a window's logit from the engine and the
reference's is compared with the configuration's limit.
"""

from __future__ import annotations

import gc
from typing import List

import numpy as np
import torch

from benchmark.reference import avhubert as ref
from benchmark.reference.model import lower
from benchmark.traffic import bulk_windows as bulk

PRECISION = bulk.PRECISION
SPANS = bulk.SPANS
POOL, CALL, GROUP = bulk.POOL, bulk.CALL, bulk.GROUP
CALIBRATION_WINDOWS = 32

window = bulk.window
end_to_end = bulk.end_to_end


def make_pool(ctx, n: int):
    """``n`` windows on the host, made on the device from the seed: grey
    uint8 pixels (uniform noise darkened per window by a factor in
    [1/4, 1]) and dB log-mel (uniform in [-80, 0], scaled per window)."""
    g = ref.geometry(ctx.config["model"])
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.subseed("pool"))
    shape = (g["frames"], g["crop"], g["crop"])
    visual = torch.empty((n,) + shape, dtype=torch.uint8)
    step = 256
    for lo in range(0, n, step):
        k = min(step, n - lo)
        noise = torch.randint(0, 256, (k,) + shape, generator=gen,
                              device=dev, dtype=torch.int16)
        level = torch.randint(64, 257, (k, 1, 1, 1), generator=gen,
                              device=dev, dtype=torch.int16)
        visual[lo:lo + k] = (noise * level // 256).to(torch.uint8).cpu()
    level = 0.3 + 0.7 * torch.rand(n, 1, 1, generator=gen, device=dev)
    mel = -80.0 * (torch.rand(n, g["mels"], g["audio_frames"], generator=gen,
                              device=dev) * level)
    return visual.numpy(), mel.cpu().numpy()


def setup(ctx):
    # A program without the model fails here, before any work.
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models.avhubert import AVHubertConfig

    cfg = ctx.config
    pool, call, group = bulk._sizes(ctx)
    visual, mel = make_pool(ctx, pool)
    ctx.note("pool")
    weights = ref.make_weights(cfg["model"], ctx.subseed("weights"),
                               ctx.device)
    k = min(CALIBRATION_WINDOWS, pool)
    ref.calibrate(weights, cfg["model"],
                  torch.from_numpy(visual[:k]).to(ctx.device).float() / 255,
                  torch.from_numpy(mel[:k]).to(ctx.device))
    ctx.note("weights")
    eng = cfg["engine"]
    engine = ScoringEngine(
        weights, AVHubertConfig(**cfg["model"]),
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
        engine.score_logits(visual[:call], mel[:call])
        ctx.note(f"warm-up call {i}")
    ctx.spans.wrap(engine, "dispatch_logits", "dispatch_logits")
    return {"engine": engine, "weights": weights, "visual": visual,
            "mel": mel, "rng": np.random.RandomState(
                ctx.subseed("offsets") % 2 ** 32)}


def _reference(state, ctx, precision) -> List[np.ndarray]:
    _, _, group = bulk._sizes(ctx)
    out = []
    for c, g in state["picks"]:
        off = state["calls"][c][0] + g * group
        v = torch.from_numpy(state["visual"][off:off + group]).to(ctx.device)
        a = torch.from_numpy(state["mel"][off:off + group]).to(ctx.device)
        out.append(ref.logits_in_blocks(state["weights"], ctx.config["model"],
                                        v, a, precision, group)
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
