"""Bulk scoring of precomputed windows: a closed loop, one caller.

Each call is ``ScoringEngine.score_logits`` on 1,024 windows, each a uint8
``(32, 96, 96, 3)`` mouth crop with an fp32 ``(80, 128)`` log-mel: four
groups of the engine's ``max_batch`` 256, two of them in flight. The
windows of a call are a block of 1,024 consecutive windows of a pool of
2,048 made in set-up, at an offset drawn from the seed, so every seed
sends the same sizes. This is what the evaluation harnesses and archive
re-scans send: crops and mel precomputed, no host stage of ``predict``.

``correct``: once the window has closed the engine is freed and the plain
reference scores two of the window's groups of 256 (drawn from the seed;
each group is one batch, as the engine ran it, so an int8 activation scale
is the same group's), at the precision the configuration states; the
widest gap between a window's logit from the engine and the reference's is
compared with the configuration's limit.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model as ref

PRECISION = "precision"  # the configuration's key for what this mix runs
SPANS = ("score_logits", "dispatch_logits")
POOL, CALL, GROUP = 2048, 1024, 256
CHECK_GROUPS = 2


def _sizes(ctx):
    s = ctx.scale
    return (s.get("pool", POOL), s.get("call", CALL), s.get("group", GROUP))


def make_pool(ctx, n: int):
    """``n`` windows on the host, made on the device from the seed: uint8
    pixels (uniform noise darkened per window by a factor in [1/4, 1]) and
    dB log-mel (uniform in [-80, 0], scaled per window), so that windows
    differ in level as well as in detail."""
    g = ref.geometry(ctx.config["model"])
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.subseed("pool"))
    shape = (g["frames"], g["crop"], g["crop"], 3)
    visual = torch.empty((n,) + shape, dtype=torch.uint8)
    step = 256
    for lo in range(0, n, step):
        k = min(step, n - lo)
        noise = torch.randint(0, 256, (k,) + shape, generator=gen,
                              device=dev, dtype=torch.int16)
        level = torch.randint(64, 257, (k, 1, 1, 1, 1), generator=gen,
                              device=dev, dtype=torch.int16)
        visual[lo:lo + k] = (noise * level // 256).to(torch.uint8).cpu()
    level = 0.3 + 0.7 * torch.rand(n, 1, 1, generator=gen, device=dev)
    mel = -80.0 * (torch.rand(n, g["mels"], g["audio_frames"], generator=gen,
                              device=dev) * level)
    return visual.numpy(), mel.cpu().numpy()


def setup(ctx):
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models.lip_sync_model import ModelConfig

    cfg = ctx.config
    pool, call, group = _sizes(ctx)
    visual, mel = make_pool(ctx, pool)
    ctx.note("pool")
    weights = ref.make_weights(cfg["model"], ctx.subseed("weights"),
                               ctx.device)
    k = min(32, pool)
    ref.calibrate(weights, cfg["model"],
                  torch.from_numpy(visual[:k]).to(ctx.device).float() / 255,
                  torch.from_numpy(mel[:k, ..., None]).to(ctx.device))
    ctx.note("weights")
    eng = cfg["engine"]
    engine = ScoringEngine(
        weights, ModelConfig(**cfg["model"]),
        use_bfloat16=eng["use_bfloat16"], max_batch=group,
        max_in_flight=eng["max_in_flight"],
        quantized_int8=eng["quantized_int8"], device=ctx.device)
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
    _note_kernels(ctx)
    return {"engine": engine, "weights": weights, "visual": visual,
            "mel": mel, "rng": np.random.RandomState(
                ctx.subseed("offsets") % 2 ** 32)}


def _note_kernels(ctx) -> None:
    """In a traced run, record the shapes given to K2 and K3 (for their
    rooflines)."""
    from lipsync_tpu_torch.models import artifact, layers

    ctx.spans.wrap(artifact, "hf_stem", "k2_hf_stem",
                   lambda video, *a, **k: (tuple(video.shape),
                                           video.element_size()))

    def k3(x, w, scale, bias, out_dtype, stride, padding):
        return (tuple(x.shape), tuple(w.shape), tuple(stride),
                tuple(padding), torch.empty((), dtype=out_dtype)
                .element_size())

    def k3_int32(x, w, stride, padding):
        return (tuple(x.shape), tuple(w.shape), tuple(stride),
                tuple(padding), 4)

    ctx.spans.wrap(layers, "int8_conv_dequant", "k3_int8_conv", k3)
    ctx.spans.wrap(layers, "int8_conv_int32", "k3_int8_conv", k3_int32)


def window(state, ctx) -> Dict:
    engine, visual, mel, rng = (state["engine"], state["visual"],
                                state["mel"], state["rng"])
    pool, call, _ = _sizes(ctx)
    calls: List = []
    ends = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        off = int(rng.randint(0, pool - call + 1))
        with ctx.spans.span("score_logits"):
            logits = engine.score_logits(visual[off:off + call],
                                         mel[off:off + call])
        calls.append((off, logits))
        ends.append(time.perf_counter())
    elapsed = time.perf_counter() - t0
    per_call = np.diff([t0] + ends)
    ctx.note(f"window: {len(calls)} calls, seconds a call min "
             f"{per_call.min():.4f} median {np.median(per_call):.4f} max "
             f"{per_call.max():.4f}")
    state["calls"] = calls
    n = call * len(calls)
    return {"attempted": n, "failed": 0, "windows": n, "elapsed": elapsed}


def end_to_end(result) -> Dict[str, float]:
    return {"windows_per_s": result["windows"] / result["elapsed"]}


def _sample(state, ctx):
    """The groups compared: ``CHECK_GROUPS`` (call, group) pairs drawn from
    the seed among the window's, as row ranges of the pool."""
    _, call, group = _sizes(ctx)
    rng = np.random.RandomState(ctx.subseed("check") % 2 ** 32)
    calls = state["calls"]
    picks = []
    for _ in range(CHECK_GROUPS):
        c = int(rng.randint(len(calls)))
        g = int(rng.randint(call // group))
        picks.append((c, g))
    return picks


def _reference(state, ctx, precision) -> List[np.ndarray]:
    _, _, group = _sizes(ctx)
    out = []
    for c, g in state["picks"]:
        off = state["calls"][c][0] + g * group
        v = torch.from_numpy(state["visual"][off:off + group]).to(ctx.device)
        a = torch.from_numpy(state["mel"][off:off + group, ..., None]).to(
            ctx.device)
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
    _, _, group = _sizes(ctx)
    state["picks"] = _sample(state, ctx)
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
    low = _reference(state, ctx,
                     precision or ref.lower(ctx.config[PRECISION]))
    gap = max(float(np.max(np.abs(lo - r)))
              for lo, r in zip(low, state["ref"]))
    return [("logit_gap", gap, ctx.config["limits"]["logit_gap"])]
