"""Drive the port's main path on one CUDA card, hold each kernel against
its plain twin at every input that path gave it, and time each kernel
beside its twin and the least time the card's peaks allow.

    python chip_smoke.py

The runs, with every kernel's launch counter set to 0 just before each:

- ``predict``: ``Predictor.predict`` on clip S (30 frames + 2.0 s, the
  short path with refinement) and clip L (150 frames + 10 s, the pipelined
  long path), through the bf16 engine at ``ModelConfig()`` on
  BatchNorm-calibrated seeded weights (K1, K2);
- ``requests``: the fp32 engine on R1-R3 as a user's request runs them:
  crop, log-mel, align, score (K1, K2);
- ``int8``: the same engine under ``quantized_int8`` on R1-R3 and on one
  full group of 256 windows, the bulk cells' batch (K1, K2, K4, K3);
- ``train_step``: one fp32 train step at batch 2, which takes the module
  chain and launches no kernel;
- ``avhubert``: AV-HuBERT LARGE's engine on one group of 256 windows (K5);
- ``auto_avsr``: Auto-AVSR's engine at its published widths on one group
  of 256 windows of 96 frames and their PCM (K5's Swish instantiation);
- ``bulk``: the served bf16 engine on one group of 256 windows, the bulk
  cells' group (K2, K6 on layers 1-2 at ``(256, 32, 24, 24, 64)``).

While they run, each kernel's wrapper, where the main path looks it up,
is wrapped: the first call at each shape, dtype and parameter set is run
once more with the twin on the same inputs, and the kernel's result held
to the kernel's bound (K1 within 1e-3 dB after the floor; K2 within
2e-5 of max(1, |twin|) of the fp32 twin, and for a bf16 clip one bf16
step of |twin| more; K3 and K4 bit for bit; K5 at most 1e-3 of pooled values apart, each within
``av_stem.sum_order_bound``; K6 within 2e-5 of max(1, |twin|) of its
fp32 twin). Shapes that the main path does not reach are
held by the card tests (``tests/test_torch_*_card.py``).

Printed, one JSON line each: every run's launches; ``main_path_shapes``,
each kernel's recorded inputs; ``kernels``, for each kernel its launches
by run, how many inputs were held and how close, and at the recorded input
with the most work its time and its twin's (CUDA events, kernel and twin
in turns) beside ``bound_ms``, the least time by ``benchmark/core/
peaks.py``; then the card's name and power limit, and ``{"ok": true}``.
Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
GROUP = 256  # the engine's max_batch: the bulk cells' group


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ── each kernel's seams, twins and bounds ────────────────────────────────

def seams():
    """``(kernel, module, attribute, twin)`` for every wrapper entry, with
    the module in which the main path looks the entry up."""
    from lipsync_tpu_torch.models import artifact as artifact_mod
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import av_stem as k5
    from lipsync_tpu_torch.ops.kernels import conv3d_tf32x3 as k6
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1

    return (
        ("log_mel", k1, "log_mel_db", k1.log_mel_db_plain),
        ("hf_stem", artifact_mod, "hf_stem", k2.hf_stem_plain),
        ("int8_conv", layers_mod, "int8_conv_dequant",
         k3.int8_conv_dequant_plain),
        ("int8_conv", layers_mod, "int8_conv_int32", k3.int8_conv_plain),
        ("int8_quant", layers_mod, "absmax", k4.absmax_plain),
        ("int8_quant", layers_mod, "quantize", k4.quantize_plain),
        ("int8_quant", layers_mod, "absmax_quantize",
         k4.absmax_quantize_plain),
        ("av_stem", k5, "av_stem", k5.av_stem_plain),
        ("conv3d_tf32x3", k6, "conv3d_tf32x3", k6.conv3d_tf32x3_plain),
    )


def kernel_modules() -> dict:
    import torch_card
    from lipsync_tpu_torch.ops.kernels import av_stem as k5

    return {**torch_card.KERNELS, "av_stem": k5}


def zero_counts() -> None:
    from lipsync_tpu_torch.ops.kernels import build

    with build.COUNT_LOCK:
        for k in kernel_modules().values():
            k.launches = 0


def counts() -> dict:
    import torch

    torch.cuda.synchronize()
    return {name: k.launches for name, k in kernel_modules().items()}


def gap(name: str, got, want, args) -> float:
    """How far the kernel's result ``got`` lies from the twin's ``want``,
    in units of the kernel's bound: at most 1 holds; K3 and K4 give 0
    where bit-equal and infinity otherwise."""
    import torch

    import torch_card
    from lipsync_tpu_torch.ops.kernels import av_stem as k5
    from lipsync_tpu_torch.ops.kernels import mel as k1

    if name == "log_mel":
        return float((k1.finish_db(got) - k1.finish_db(want)).abs().max()
                     / 1e-3)
    if name in ("hf_stem", "conv3d_tf32x3"):
        # 3xTF32 keeps the convolution at fp32's accuracy; a bf16 clip's
        # result is that rounded to bf16: one bf16 step (2^-8) of |twin|
        # more
        got, want = got.float(), want.float()
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        if args[0].dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * want.abs()
        return float(((got - want).abs() / tol).max())
    if name == "av_stem":
        diff = (got.float() - want.float()).abs()
        share = float((diff > 0).float().mean())
        used = float((diff / k5.sum_order_bound(*args)).max())
        return max(share / 1e-3, used)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    same = all(
        g is w is None or (torch_card.same_float(g, w)
                           if g.dtype.is_floating_point else torch.equal(g, w))
        for g, w in pairs)
    return 0.0 if same else float("inf")


def key_of(entry: str, args, kwargs) -> tuple:
    """An input's key: the entry, each tensor's shape, dtype and strides,
    every other argument as it is."""
    import torch

    def one(v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), str(v.dtype)[6:], tuple(v.stride()))
        return repr(v)

    return (entry, *map(one, args), *sorted((k, one(v))
                                            for k, v in kwargs.items()))


def twin_args(name: str, args: tuple) -> tuple:
    """The twin's inputs: K2's bf16 clip is held against the fp32 twin on
    the same values."""
    if name == "hf_stem":
        return (args[0].float(), *args[1:])
    return args


class Recorder:
    """While open, every entry of :func:`seams` is wrapped: the first call
    at each key (:func:`key_of`) is checked against its twin and its gap
    (:func:`gap`) kept; of each kernel, the inputs with the most work are
    kept for timing."""

    def __init__(self):
        self.seen, self.gaps, self.failures = {}, {}, []
        self.widest = {}
        self.lock = threading.Lock()

    def wrap(self, name, entry, kernel, twin):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            key = key_of(entry, args, kwargs)
            with self.lock:
                new = key not in self.seen.setdefault(name, set())
                self.seen[name].add(key)
            if new:
                want = twin(*twin_args(name, args), **kwargs)
                g = gap(name, out, want, args)
                with self.lock:
                    self.gaps.setdefault(name, []).append(g)
                    if not g <= 1.0:
                        self.failures.append((name, key, g))
                    work = args[0].numel()
                    if work > self.widest.get(name, (0,))[0]:
                        self.widest[name] = (work, entry, kernel, twin, tuple(
                            a.clone() if hasattr(a, "clone") else a
                            for a in args), dict(kwargs))
            return out
        return call

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for _, mod, attr, _ in seams()]
        for (name, mod, attr, twin), (_, _, kernel) in zip(seams(),
                                                           self.saved):
            setattr(mod, attr, self.wrap(name, attr, kernel, twin))
        return self

    def __exit__(self, *exc):
        for mod, attr, kernel in self.saved:
            setattr(mod, attr, kernel)


# ── timing and bounds ────────────────────────────────────────────────────

def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters: int = 20) -> tuple:
    """Kernel and plain ms per call, each the mean of two readings taken
    in turns (kernel, plain, plain, kernel)."""
    k_a, p_a = time_ms(kernel, iters), time_ms(plain, iters)
    p_b, k_b = time_ms(plain, iters), time_ms(kernel, iters)
    return (k_a + k_b) / 2, (p_a + p_b) / 2


def least_ms(name: str, args: tuple, kwargs: dict, out) -> tuple:
    """``(ms, basis)``: the least time of one launch on these inputs, from
    ``benchmark/core/peaks.py``'s peaks; ``out`` is the kernel's result."""
    import numpy as np

    from benchmark.core import peaks
    from lipsync_tpu_torch.ops.kernels import av_stem as k5
    from lipsync_tpu_torch.ops.kernels import conv3d_tf32x3 as k6
    from lipsync_tpu_torch.ops.kernels import mel as k1

    x = args[0]
    if name == "log_mel":
        # the window, a real n_fft-point FFT (2.5 N log2 N), the power and
        # the mel sums over each band's support, per frame
        p = dict(zip(("sr", "n_fft", "hop_length", "win_length", "n_mels",
                      "center"), args[1:]), **kwargs)
        sr, n_fft = p.get("sr", k1.SR), p.get("n_fft", k1.N_FFT)
        n_mels = p.get("n_mels", k1.N_MELS)
        bands = k1.kernel_tables(x.device, sr, n_fft, n_mels)[4].cpu()
        support = int((bands[:, 1] - bands[:, 0] + 1).clamp(min=0).sum())
        frames = x.shape[0] * out.shape[-1]
        ops = frames * (n_fft + 2.5 * n_fft * np.log2(n_fft)
                        + 3 * (n_fft // 2 + 1) + 2 * support)
        return 1e3 * peaks.least_seconds(
            4 * (x.numel() + out.numel()), ops, "fp32"), "fp32 SIMT"
    if name == "hf_stem":
        return 1e3 * peaks.k2_hf_stem(x.shape, x.element_size()), "tf32"
    if name == "int8_conv":
        w, stride, padding = args[1], args[-2], args[-1]
        y = out[0] if isinstance(out, tuple) else out
        return 1e3 * peaks.k3_int8_conv(
            tuple(x.shape), tuple(w.shape), stride, padding,
            y.element_size()), "int8"
    if name == "int8_quant":  # x read once, int8 written once
        return 1e3 * peaks.least_seconds(
            x.numel() * (x.element_size() + 1), 0.0, "fp32"), "bytes"
    if name == "conv3d_tf32x3":  # the fp32 work at the TF32 rate; x, the
        # residual and the output moved once
        p, stride, padding = args[1], args[2], args[3]
        res = args[4] if len(args) > 4 else kwargs.get("residual")
        n_bytes = 4 * x.numel() + out.numel() * out.element_size() + (
            0 if res is None else 4 * res.numel())
        return 1e3 * peaks.least_seconds(
            n_bytes, k6.flops(x.shape, p.weight.shape, stride, padding),
            "tf32"), "tf32"
    b, _, t, h, w = x.shape  # K5, as benchmark/metrics prices a position
    positions = b * t * k5.out_size(h) * k5.out_size(w)
    return 1e3 * positions * peaks.least_seconds(
        2 * 4 + 2 * k5.C_OUT / 4, 2 * 5 * 7 * 7 * k5.C_OUT, "bf16"), "bf16"


# ── the runs ─────────────────────────────────────────────────────────────

def windows(n: int, shape: tuple, mel: tuple, seed: int):
    """``n`` uint8 windows of ``shape``, darkened per window, and dB
    log-mel of ``mel``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    level = rng.randint(64, 257, (n,) + (1,) * len(shape))
    visual = (rng.randint(0, 256, (n, *shape)) * level // 256).astype(
        np.uint8)
    return visual, (-80 * rng.rand(n, *mel)).astype(np.float32)


def run_predict(dev, cfg, calibrated) -> None:
    import pytest

    import torch_card
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )

    engine = ScoringEngine(calibrated, cfg, device=dev)
    _, memory, boxes, paths = torch_card.clip_set()
    configs = {"S": PredictorConfig(refine_margin=1.5), "L": PredictorConfig()}
    with pytest.MonkeyPatch.context() as m:
        memory.install(m)
        for clip, pcfg in configs.items():
            result = Predictor(config=pcfg, model_config=cfg, engine=engine,
                               detector_backend=boxes,
                               device=dev).predict(paths[clip])
            check(result["verdict"] and result["tracks"],
                  f"predict {clip}: {result}")


def run_requests(dev, cfg, calibrated) -> None:
    import numpy as np

    import torch_card
    from lipsync_tpu_torch.inference.engine import ScoringEngine

    engine = ScoringEngine(calibrated, cfg, use_bfloat16=False, device=dev)
    for req in torch_card.requests().values():
        check(np.isfinite(torch_card.serve(engine, *req)).all(),
              "non-finite probabilities")


def run_int8(dev, cfg, calibrated) -> None:
    import numpy as np

    import torch_card
    from lipsync_tpu_torch.inference.engine import ScoringEngine

    engine = ScoringEngine(calibrated, cfg, quantized_int8=True, device=dev)
    for req in torch_card.requests().values():
        check(np.isfinite(torch_card.serve(engine, *req)).all(),
              "non-finite int8 probabilities")
    visual, mel = windows(GROUP, (cfg.video_frames, cfg.crop_size,
                                  cfg.crop_size, 3),
                          (cfg.mel_bins, cfg.audio_frames), 1)
    check(np.isfinite(engine.score_logits(visual, mel)).all(),
          "non-finite int8 logits")


def run_bulk(dev, cfg, calibrated) -> None:
    import numpy as np

    from lipsync_tpu_torch.inference.engine import ScoringEngine

    engine = ScoringEngine(calibrated, cfg, max_batch=GROUP, device=dev)
    visual, mel = windows(GROUP, (cfg.video_frames, cfg.crop_size,
                                  cfg.crop_size, 3),
                          (cfg.mel_bins, cfg.audio_frames), 17)
    check(np.isfinite(engine.score_logits(visual, mel)).all(),
          "non-finite bf16 logits")


def run_train_step(dev, cfg) -> None:
    import numpy as np

    import torch_card
    from lipsync_tpu_torch.models import LipSyncModel, seeded_state_dict
    from lipsync_tpu_torch.training import steps
    from lipsync_tpu_torch.training import train as train_mod

    cfg = dataclasses.replace(cfg, dropout=0.0)
    model = LipSyncModel(cfg)
    model.load_state_dict(seeded_state_dict(model, SEED))
    model.to(dev)
    state = steps.create_train_state(model, torch_card.SGD1(model), SEED,
                                     None)
    rng = np.random.default_rng(SEED)
    batch = {
        "visual": rng.integers(0, 256, (2, cfg.video_frames, cfg.crop_size,
                                        cfg.crop_size, 3), dtype=np.uint8),
        "audio": rng.uniform(-80, 0, (2, cfg.mel_bins, cfg.audio_frames, 1)
                             ).astype(np.float32),
        "label": np.asarray([1.0, 0.0], np.float32),
    }
    metrics = steps.make_train_step(steps.LossConfig())(
        state, train_mod.to_device(batch, dev), shift=5)
    check(all(np.isfinite(float(v)) for v in metrics.values()),
          f"train step: {metrics}")


def run_avhubert(dev, cfg) -> None:
    import numpy as np

    from benchmark.reference import avhubert as ref
    from lipsync_tpu_torch.inference.engine import ScoringEngine

    model = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    engine = ScoringEngine(ref.make_weights(model, 11, dev), cfg,
                           max_batch=GROUP, device=dev)
    visual, mel = windows(GROUP, (cfg.video_frames, cfg.crop_size,
                                  cfg.crop_size),
                          (cfg.mel_bins, cfg.audio_frames), 13)
    check(np.isfinite(engine.score_logits(visual, mel)).all(),
          "non-finite AV-HuBERT logits")


def run_auto_avsr(dev, cfg) -> None:
    import numpy as np

    from benchmark.reference import auto_avsr as ref
    from lipsync_tpu_torch.inference.engine import ScoringEngine

    model = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    engine = ScoringEngine(ref.make_weights(model, 11, dev), cfg,
                           max_batch=GROUP, device=dev)
    visual, _ = windows(GROUP, (cfg.video_frames, cfg.crop_size,
                                cfg.crop_size), (1,), 13)
    pcm = np.random.RandomState(14).randn(
        GROUP, 1, cfg.video_frames * 640).astype(np.float32)
    check(np.isfinite(engine.score_logits(visual, pcm)).all(),
          "non-finite Auto-AVSR logits")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    for path in (ROOT, ROOT / "tests"):  # benchmark/, tests/torch_card.py
        sys.path.insert(0, str(path))

    import torch_card
    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.models.auto_avsr import AutoAVSRConfig
    from lipsync_tpu_torch.models.avhubert import AVHubertConfig
    from lipsync_tpu_torch.utils.device import disable_tf32

    disable_tf32()  # as the port's entry points set the process
    dev = torch.device("cuda", 0)
    cfg = ModelConfig()
    calibrated = torch_card.weight_sets(cfg, dev)["bn_calibrated"]
    runs = {"predict": lambda: run_predict(dev, cfg, calibrated),
            "requests": lambda: run_requests(dev, cfg, calibrated),
            "int8": lambda: run_int8(dev, cfg, calibrated),
            "train_step": lambda: run_train_step(dev, cfg),
            "avhubert": lambda: run_avhubert(dev, AVHubertConfig()),
            "auto_avsr": lambda: run_auto_avsr(dev, AutoAVSRConfig()),
            "bulk": lambda: run_bulk(dev, cfg, calibrated)}
    expect = {"predict": {"log_mel", "hf_stem", "conv3d_tf32x3"},
              "requests": {"log_mel", "hf_stem", "conv3d_tf32x3"},
              "int8": {"log_mel", "hf_stem", "int8_conv", "int8_quant"},
              "train_step": set(), "avhubert": {"av_stem"},
              "auto_avsr": {"av_stem"},
              "bulk": {"hf_stem", "conv3d_tf32x3"}}
    by_run = {}
    with Recorder() as rec:
        for run, fn in runs.items():
            t0 = time.perf_counter()
            zero_counts()
            fn()
            by_run[run] = counts()
            emit({"run": run, "launches": by_run[run],
                  "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()
            launched = {k for k, n in by_run[run].items() if n}
            if launched != expect[run]:
                rec.failures.append((run, "launched", sorted(launched)))
    emit({"main_path_shapes": {k: sorted(map(str, v))
                               for k, v in rec.seen.items()}})

    rows = []
    for name, k in kernel_modules().items():
        _, entry, kernel, twin, args, kwargs = rec.widest[name]
        out = kernel(*args, **kwargs)
        ms, plain_ms = in_turns(
            lambda: kernel(*args, **kwargs),
            lambda: twin(*args, **kwargs),
            iters=20 if name != "int8_conv" else 5)
        bound_ms, basis = least_ms(name, args, kwargs, out)
        rows.append({
            "name": name, "source": f"lipsync_tpu_torch/csrc/"
                                    f"{Path(k.__file__).stem}.cu",
            "launches": {run: n[name] for run, n in by_run.items()},
            "inputs_held": len(rec.gaps[name]),
            "widest_gap_of_bound": max(rec.gaps[name]),
            "timed": {"entry": entry, "x": list(args[0].shape),
                      "dtype": str(args[0].dtype)[6:]},
            "timer": "cuda events per call, host launch included",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_basis": basis, "bound_share": bound_ms / ms})
        del out
    from benchmark.core import peaks

    emit({"kernels": rows})
    emit({"card": torch.cuda.get_device_name(0),
          "power_limit_w": peaks.power_limit_w()})
    check(not rec.failures, f"failures: {rec.failures}")
    emit({"ok": True})


if __name__ == "__main__":
    main()
