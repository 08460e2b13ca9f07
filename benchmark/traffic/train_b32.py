"""Training steps at batch 32: a closed loop of the production step.

The step is ``training/steps.py::make_train_step`` with on-device
augmentation (``AugmentConfig()``) and the phase-3 ``PhaseOptimizer``
(Adam, lr 1e-4 for the head and the encoders), in fp32 with TF32 off. Its
batches come from ``training/device_cache.py::DeviceDatasetCache`` over a
pool of 1,024 clips of 48 frames (uint8 96x96 crops, fp32 log-mel at
100 Hz, labels half real), gathered on the device at a start drawn per
clip, in shuffled epochs: the feed of a trainer run with ``--device-cache``.
This is the cost the model's owners pay to (re)train the flagship; no
serving layer runs.

Set-up builds the step, the model and the optimizer once and warms them
up with three steps of the window's own call and feed. It then puts that
same object back to the seed's state in place: the weights and BatchNorm
statistics, the optimizer's moments and step counts, the step count and
the augmentation, shift and dropout generators. So the window's first
three steps are the first three from the seed; the window records their
batches, their losses, the first moment after the first and the
parameters after the third, and steps on, reading each step's loss one
step late.

``correct``: after the window the plain reference follows those three
steps of the window from the same weights, batches and seeds
(augmentation, shift and dropout draws), and three numbers are compared:
each step's loss, the first gradient (the optimizer's first moment after
one step, over ``1 - beta1``) and the parameters' change over the three
steps, the last two as the worst leaf's gap of norms (see ``leaf_gaps``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

PRECISION = "train_precision"  # the configuration's key for what this mix runs
SPANS = ("feed", "train_step", "read_loss")
CLIPS, FRAMES, BATCH, LR, STEPS_CHECKED, WARM_STEPS = 1024, 48, 32, 1e-4, 3, 3
FPS, MEL_HZ = 15.0, 100.0


class _Pool:
    """The clip pool as a preprocessed dataset of full-sequence records,
    the interface ``DeviceDatasetCache`` reads."""

    use_preprocessed = True

    def __init__(self, visual, mel, labels, video_frames, audio_frames):
        self.visual, self.mel = visual, mel
        self.video_frames, self.audio_frames = video_frames, audio_frames
        self._manifest = [
            {"precompute_mode": "full_sequence", "label": float(y),
             "target_fps": FPS, "mel_hz": MEL_HZ, "row": i}
            for i, y in enumerate(labels)]

    def _load_tensors(self, rec):
        return self.visual[rec["row"]], self.mel[rec["row"]]


def _sizes(ctx):
    s = ctx.scale
    return s.get("clips", CLIPS), s.get("frames", FRAMES), \
        s.get("batch", BATCH)


def make_pool(ctx):
    """Clips made on the device from the seed: uint8 noise crops darkened
    per clip, dB log-mel (uniform in [-80, 0] scaled per clip), labels
    drawn half and half."""
    g = ref.geometry(ctx.config["model"])
    clips, frames, _ = _sizes(ctx)
    mel_len = int(round(frames / FPS * MEL_HZ))
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.subseed("pool"))
    shape = (frames, g["crop"], g["crop"], 3)
    visual = torch.empty((clips,) + shape, dtype=torch.uint8)
    for lo in range(0, clips, 128):
        k = min(128, clips - lo)
        noise = torch.randint(0, 256, (k,) + shape, generator=gen,
                              device=dev, dtype=torch.int16)
        level = torch.randint(64, 257, (k, 1, 1, 1, 1), generator=gen,
                              device=dev, dtype=torch.int16)
        visual[lo:lo + k] = (noise * level // 256).to(torch.uint8).cpu()
    level = 0.3 + 0.7 * torch.rand(clips, 1, 1, generator=gen, device=dev)
    mel = -80.0 * (torch.rand(clips, g["mels"], mel_len, generator=gen,
                              device=dev) * level)
    labels = (torch.randperm(clips, generator=gen, device=dev)
              < clips // 2).float()
    return visual.numpy(), mel.cpu().numpy(), labels.cpu().numpy()


def setup(ctx):
    from lipsync_tpu_torch.models.lip_sync_model import (
        LipSyncModel,
        ModelConfig,
    )
    from lipsync_tpu_torch.ops.augment import AugmentConfig
    from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
    from lipsync_tpu_torch.training.steps import (
        create_train_state,
        make_train_step,
    )
    from lipsync_tpu_torch.utils.device import disable_tf32

    cfg = ctx.config
    mcfg = ModelConfig(**cfg["model"])
    disable_tf32()
    clips, _, batch = _sizes(ctx)
    visual, mel, labels = make_pool(ctx)
    ctx.note("pool")
    cache = DeviceDatasetCache(_Pool(visual, mel, labels, mcfg.video_frames,
                                     mcfg.audio_frames), device=ctx.device)
    weights = ref.make_weights(cfg["model"], ctx.subseed("weights"),
                               ctx.device)
    ctx.note("device cache, weights")
    model = LipSyncModel(mcfg)
    model.load_state_dict(weights, strict=True)
    model.to(ctx.device)
    optimizer = PhaseOptimizer(model.named_parameters(), 3, lr_head=LR,
                               lr_encoder=LR)
    state = create_train_state(model, optimizer, seed=ctx.subseed("augment"))
    step = make_train_step(augment_cfg=AugmentConfig())
    if "unchanged_state" in ctx.faults:  # the step leaves the state as it is
        optimizer.step = lambda: None
    if "half_batch" in ctx.faults:  # half the batch left out of the step
        inner_step = step

        def step(st, b):
            half = {k: v[: v.shape[0] // 2] for k, v in b.items()}
            return inner_step(st, half)

    batches: List = []
    inner_gather = cache.gather

    def gather(idx, starts, mask):
        batches.append((np.array(idx), np.array(starts)))
        return inner_gather(idx, starts, mask)

    cache.gather = gather
    rng = np.random.RandomState(ctx.subseed("feed") % 2 ** 32)

    def feed():
        while True:
            yield from cache.batches(range(clips), batch, rng=rng,
                                     train_mode=True)

    it = feed()
    for i in range(WARM_STEPS):  # every shape of the window
        float(step(state, next(it))["loss"])
        ctx.note(f"warm-up step {i + 1}")
    _to_seed(ctx, model, optimizer, state, weights)
    ctx.spans.wrap(cache, "gather", "feed")
    return {"model": model, "optimizer": optimizer, "train": state,
            "step": step, "feed": it, "cache": cache,
            "weights": weights, "visual": visual, "mel": mel,
            "labels": labels, "batches": batches,
            "names": {id(p): n for n, p in model.named_parameters()}}


@torch.no_grad()
def _to_seed(ctx, model, optimizer, state, weights) -> None:
    """The same model, optimizer and train state, back in place to the
    seed's state after the warm-up: weights and BatchNorm statistics,
    Adam's moments and step counts (zeros, as Adam starts from), the step
    count and every generator a step draws from."""
    model.load_state_dict(weights, strict=True)
    for slot in optimizer.optimizer.state.values():
        for v in slot.values():
            v.zero_()
    state.step = 0
    state.generator.manual_seed(ctx.subseed("augment"))
    state.aug_generator.manual_seed(ctx.subseed("augment"))
    _seed_dropout(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _seed_dropout(ctx) -> None:
    """Dropout draws from the device's default generator: both sides seed
    it from the run's seed before their first step."""
    s = ctx.subseed("dropout")
    if ctx.device.type == "cuda":
        torch.cuda.manual_seed(s)
    else:
        torch.manual_seed(s)


def window(state, ctx) -> Dict:
    """Steps for ``ctx.seconds`` (and at least the three compared); the
    first moment after step 1 and the parameters after step 3 are copied
    on the device as the steps run, the losses kept as tensors."""
    step, train, it = state["step"], state["train"], state["feed"]
    model, names = state["model"], state["names"]
    opt_state = state["optimizer"].optimizer.state
    spans = ctx.spans
    _, _, batch = _sizes(ctx)
    steps, pending, losses = 0, None, []
    first_moment, after = None, None
    t0 = time.perf_counter()
    while steps < STEPS_CHECKED or time.perf_counter() - t0 < ctx.seconds:
        b = next(it)
        with spans.span("train_step"):
            out = step(train, b)
        steps += 1
        if steps <= STEPS_CHECKED:
            losses.append(out["loss"])
            if steps == 1:
                first_moment = {names[id(p)]: s["exp_avg"].clone()
                                for p, s in opt_state.items()}
            if steps == STEPS_CHECKED:
                after = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        if pending is not None:  # one step in flight: read the one before
            with spans.span("read_loss"):
                float(pending)
        pending = out["loss"]
    with spans.span("read_loss"):
        float(pending)
    elapsed = time.perf_counter() - t0
    state.update(
        batches=state["batches"][WARM_STEPS:WARM_STEPS + STEPS_CHECKED],
        losses=[float(x) for x in losses],
        first_grad={k: v / (1.0 - 0.9) for k, v in first_moment.items()},
        after=after)
    return {"attempted": steps, "failed": 0, "steps": steps,
            "clips": steps * batch, "elapsed": elapsed}


def end_to_end(result) -> Dict[str, float]:
    return {"train_clips_per_s": result["clips"] / result["elapsed"]}


# ------------------------------------------------------------------ check
def gather(ctx, visual, mel, labels, idx, starts):
    """The reference's batch: each clip's frames ``start .. start + T`` and
    the mel columns at ``round(start / fps * mel_hz)`` (clamped to the
    clip), resampled to ``audio_frames`` by the truncated ``linspace``
    index table, on the device."""
    g = ref.geometry(ctx.config["model"])
    t = g["frames"]
    mel_len = max(1, int(round(t / FPS * MEL_HZ)))
    table = np.linspace(0, mel_len - 1, g["audio_frames"]).astype(np.int64)
    v = np.stack([visual[i, s:s + t] for i, s in zip(idx, starts)])
    a_len = mel.shape[2]
    ms = torch.round(torch.as_tensor(starts, dtype=torch.float32)
                     / FPS * MEL_HZ).long().numpy()
    ms = np.clip(ms, 0, a_len - 1)
    cols = np.minimum(ms[:, None] + table[None, :], a_len - 1)
    a = np.ascontiguousarray(np.stack([mel[i][:, c]
                                       for i, c in zip(idx, cols)]))
    dev = ctx.device
    return {"visual": torch.from_numpy(v).to(dev),
            "audio": torch.from_numpy(a[..., None]).to(dev),
            "label": torch.from_numpy(labels[idx]).to(dev),
            "sample_mask": torch.ones(len(idx), device=dev)}


def follow(state, ctx, precision):
    """The reference's three steps: losses, first gradients, parameters
    after."""
    params = {k: v.clone() for k, v in state["weights"].items()}
    adam = ref_train.Adam(ref_train.trainable(params), LR)
    aug = torch.Generator(device=ctx.device).manual_seed(
        ctx.subseed("augment"))
    shift = torch.Generator().manual_seed(ctx.subseed("augment"))
    _seed_dropout(ctx)
    losses, first = [], None
    for idx, starts in state["batches"]:
        b = gather(ctx, state["visual"], state["mel"], state["labels"], idx,
                   starts)
        loss, grads = ref_train.train_step(
            params, ctx.config["model"], b, adam, aug, shift, precision,
            float(ctx.config["model"]["dropout"]))
        losses.append(loss)
        if first is None:
            first = grads
    return losses, first, params


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's gap of norms, ``| |got| - |want| |`` over
    ``max(|want|, the median leaf's |want|)``, over the leaves ``keep``."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return {k: abs((float(got[k].norm()) if k in got else 0.0) - norms[k])
            / max(norms[k], median) for k in keep}


def compare(state, losses, first, params) -> Dict[str, float]:
    w = state["weights"]
    grad_norms = {k: float(v.norm()) for k, v in first.items()}
    median = float(np.median(list(grad_norms.values())))
    # Leaves whose gradient is round-off (a bias before a BatchNorm) move
    # under Adam by round-off alone: left out of the change, by the rule.
    moved = [k for k, n in grad_norms.items() if n >= 1e-3 * median]
    change_got = {k: state["after"][k] - w[k] for k in moved}
    change_want = {k: params[k] - w[k] for k in moved}
    steps = [abs(a - b) / abs(b) for a, b in zip(state["losses"], losses)]
    change = leaf_gaps(change_got, change_want, moved)
    worst = sorted(change, key=change.get, reverse=True)[:3]
    return {
        "loss_gap": max(steps),
        "loss_gap_by_step": steps,
        "grad_gap": max(leaf_gaps(state["first_grad"], first,
                                  list(first)).values()),
        "change_gap": max(change.values()),
        "change_worst": [(k, change[k], float(change_want[k].norm()),
                          grad_norms[k] / median) for k in worst],
    }


def check(state, ctx):
    for key in ("model", "optimizer", "train", "step", "feed", "cache"):
        state.pop(key, None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    losses, first, params = follow(state, ctx, ctx.config[PRECISION])
    state["ref"] = (losses, first, params)
    got = compare(state, losses, first, params)
    state["detail"] = {"loss_gap_by_step": got["loss_gap_by_step"],
                       "change_worst": got["change_worst"]}
    limits = ctx.config["limits"]
    return [(k, got[k], limits[k]) for k in ("loss_gap", "grad_gap",
                                             "change_gap")]


def control(state, ctx, precision=None):
    """The reference one precision step below the configuration's (TF32
    for fp32), or at ``precision``, in the program's place, held to the
    same comparison."""
    low = follow(state, ctx,
                 precision or ref.lower(ctx.config[PRECISION]))
    losses, first, params = state["ref"]
    lowered = dict(state, losses=low[0], first_grad=low[1], after=low[2])
    got = compare(lowered, losses, first, params)
    state["detail"]["control_loss_gap_by_step"] = got["loss_gap_by_step"]
    limits = ctx.config["limits"]
    return [(k, got[k], limits[k]) for k in ("loss_gap", "grad_gap",
                                             "change_gap")]
