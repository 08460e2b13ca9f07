#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printed as one JSON line:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the ``nvcc`` build of every kernel (``csrc/*.cu``, one compiler per
   source, all started together), with its seconds, ptxas's registers,
   shared memory and spills (none allowed) and K2's blocks per SM (>= 2);
3. K1 (log-mel) against its plain twin at 16384 / 65536 / 262144 /
   1048576 samples (< 1e-3 dB), with kernel, twin, library (``ops/mel.py``'s
   rFFT chain) and bound times, and on a quiet-band signal against a
   float64 DFT of the same chain (K1 no further than the twin + 2e-4 dB,
   and within the 2.5e-3 dB fp32 floor that the CPU tests pin);
4. K2 (HF stem) against its twin at every main-path batch, (B, 32, 96, 96,
   3) for B = 1 / 16 / 128, and at an odd, non-square (2, 4, 15, 10, 3)
   that leaves partial output tiles: fp32 atol 2e-5, bf16 within
   |d| <= 8e-3 |fp32| + 1e-5 of the fp32 result on the same input; kernel,
   twin and bound times in both dtypes;
5. three requests at the full width of ``ModelConfig()``, each crop ->
   log-mel (K1) -> align -> engine (K2 inside): R1 32 frames of 360x640 +
   2.2 s of PCM through ``score_probs``; R2 150 frames (10 s at 15 fps, 15
   windows of stride 8) and R3 600 frames (72 windows) through
   ``score_track_probs``. Two sets of weights, both from the seed: the
   seeded weights as they are (``seeded``: their logits barely vary) and
   the same weights with every BatchNorm calibrated on R2's windows
   (``bn_calibrated``: activations near unit scale, logits that spread).
   The main path serves the requests once on the calibrated weights in
   bf16 and must advance both launch counters on each. For both sets, fp32
   logits must be within 1e-3 of the same request with the twins on the
   card, and bf16 probabilities within 4e-3 of fp32. Warm latency is the
   median of 5.

Then a ``kernels`` line, the ``nvidia-smi`` line, and the result line
``{"ok": true, "device": {...}}``. Every fp32 comparison runs with TF32 off
(``torch.backends.cudnn.allow_tf32`` defaults to True). Any failure raises
and exits non-zero; nothing is printed as a result when CUDA or the package
is missing.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
STRIDE = 8

# Published peaks (dense, no sparsity) by card: (bytes/s, fp32 SIMT FLOP/s,
# TF32 tensor-core FLOP/s). K2's conv1 runs on the tensor cores, so its
# bound counts operations at the TF32 rate (H100 SXM: 495 TFLOP/s; the other
# cards: half their dense bf16 rate). K1 stays on fp32 SIMT FMA, the only
# type that holds its dB at quiet bands, so its bound keeps the SIMT rate;
# it counts the operations that the function needs (an rFFT, the mel bands'
# supports), not those of the kernel's direct DFT.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 417.5e12),
    "H200": (4.8e12, 67e12, 494.5e12),
    "H100": (3.35e12, 67e12, 495e12),  # SXM
}
SIMT, TENSOR = "fp32 SIMT", "TF32 tensor cores"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise ValueError(f"no published peaks for {name!r}; add them to PEAKS")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    if not (ROOT / "lipsync_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: the lipsync_tpu_torch package is not beside "
                 "this script")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.inference.policy import align_audio_chunk
    from lipsync_tpu_torch.models import (
        LipSyncModel,
        ModelConfig,
        artifact as artifact_mod,
        bn_calibrated_state_dict,
        seeded_state_dict,
    )
    from lipsync_tpu_torch.ops import mel as mel_ops
    from lipsync_tpu_torch.ops.kernels import build
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import audio as audio_mod
    from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
    from lipsync_tpu_torch.utils import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peak_key, (mem_bw, fp32_peak, tf32_peak) = peaks(kind)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_of": peak_key,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})

    # ── 2. build ──────────────────────────────────────────────────────
    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
             for n, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "nvcc": build.nvcc_path(), "ptxas": ptxas,
          "hf_stem_blocks_per_sm": {
              dt: k2.blocks_per_sm(getattr(torch, dt))
              for dt in ("float32", "bfloat16")}})
    spills = [int(v) for lines in ptxas.values() for ln in lines
              for v in re.findall(r"(\d+) bytes spill", ln)]
    check(not any(spills), f"ptxas reports spills: {ptxas}")
    check(k2.blocks_per_sm(torch.bfloat16) >= 2
          and k2.blocks_per_sm(torch.float32) >= 2,
          "K2 fits fewer than 2 blocks per SM")

    def bound_ms(n_bytes: float, flops: float, basis: str = SIMT):
        t_bytes = n_bytes / mem_bw
        t_ops = flops / (tf32_peak if basis == TENSOR else fp32_peak)
        return max(t_bytes, t_ops) * 1e3, (
            "bytes" if t_bytes >= t_ops else "operations")

    def in_turns(kernel, plain, iters: int = 20):
        """Kernel and plain times, each the mean of two runs taken in turns
        (kernel, plain, plain, kernel)."""
        k_a, p_a = time_ms(kernel, iters), time_ms(plain, iters)
        p_b, k_b = time_ms(plain, iters), time_ms(kernel, iters)
        return (k_a + k_b) / 2, (p_a + p_b) / 2

    def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
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

    rng = np.random.default_rng(SEED)

    # ── 3. K1 vs its twin ─────────────────────────────────────────────
    k1_tables = k1.kernel_tables(dev)
    k1_bytes = 4 * sum(tb.numel() for tb in k1_tables)
    bands = k1_tables[4].cpu()
    support = int((bands[:, 1] - bands[:, 0] + 1).clamp(min=0).sum())

    def k1_flops(t: int) -> float:
        """Operations per clip of t frames that the function needs: the
        window, a real 400-point FFT (2.5 N log2 N, half a complex FFT's
        5 N log2 N), the power c^2 + s^2 and the mel sums over each band's
        support."""
        n_fft = k1.N_FFT
        return t * (n_fft + 2.5 * n_fft * np.log2(n_fft)
                    + 3 * (n_fft // 2 + 1) + 2 * support)

    k1_rows = {}
    for n in (16384, 65536, 262144, 1 << 20):
        y2 = torch.from_numpy(synthetic.pcm(rng, n)).to(dev)[None]
        t = k1.n_frames_for(n)
        got = k1.finish_db(k1.log_mel_db(y2))
        want = k1.finish_db(k1.log_mel_db_plain(y2))
        lib = mel_ops.log_mel_spectrogram(y2[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_lib = float((got[0] - lib).abs().max())
        check(err < 1e-3, f"K1 vs twin at n={n}: {err} dB")
        flops = k1_flops(t)
        n_bytes = 4 * (n + 80 * t) + k1_bytes
        bms, bby = bound_ms(n_bytes, flops)
        kms, pms = in_turns(lambda: k1.log_mel_db(y2),
                            lambda: k1.log_mel_db_plain(y2))
        row = {"n": n, "frames": t, "max_abs_err_db": err,
               "max_abs_err_vs_rfft_db": err_lib,
               "kernel_ms": kms, "plain_ms": pms,
               "kernel_over_plain": kms / pms,
               # cuFFT + cuBLAS, and the clip-max reference and floor
               "library_ms": time_ms(
                   lambda: mel_ops.log_mel_spectrogram(y2[0])),
               "bound_ms": bms, "bound_by": bby, "bound_basis": SIMT,
               "gflop": flops / 1e9, "mbytes": n_bytes / 1e6}
        k1_rows[n] = row
        emit({"phase": "k1_mel", **row})

    # Quiet bands: a loud tone over faint noise puts mel bands 75-80 dB
    # below the clip peak, where every fp32 DFT chain rounds to ~1.5e-3 dB.
    # K1 may not round worse than its twin there, nor past that fp32 floor
    # as the CPU tests pin it (the twin on the card sums in another order).
    n = 41000
    tt = np.arange(n) / 16000.0
    yq = (0.5 * np.sin(2 * np.pi * 220 * tt)
          + 3e-4 * rng.standard_normal(n)).astype(np.float32)
    yq2 = torch.from_numpy(yq).to(dev)[None]
    got = k1.finish_db(k1.log_mel_db(yq2))[0].cpu().numpy()
    twin = k1.finish_db(k1.log_mel_db_plain(yq2))[0].cpu().numpy()
    yp = np.pad(yq.astype(np.float64), (200, 200))
    frames64 = np.lib.stride_tricks.sliding_window_view(yp, 400)[::160]
    power64 = np.abs(np.fft.rfft(
        frames64[: k1.n_frames_for(n)]
        * mel_ops.hann_window(400).astype(np.float64), axis=-1)) ** 2
    ref = 10 * np.log10(np.maximum(
        power64 @ mel_ops.mel_filterbank(16000, 400, 80).T.astype(np.float64),
        1e-10)).T
    ref = np.maximum(ref - ref.max(), -80.0)
    quiet = {"kernel_vs_f64_db": float(np.abs(got - ref).max()),
             "twin_vs_f64_db": float(np.abs(twin - ref).max())}
    emit({"phase": "k1_quiet_band", "n": n, **quiet})
    check(quiet["kernel_vs_f64_db"] <= quiet["twin_vs_f64_db"] + 2e-4,
          f"K1 rounds worse than its twin at quiet bands: {quiet}")
    check(quiet["kernel_vs_f64_db"] <= 2.5e-3,
          f"K1 rounds past the fp32 floor at quiet bands: {quiet}")

    # ── 4. K2 vs its twin ─────────────────────────────────────────────
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    lap = torch.zeros(3, 3, 3, 3)
    for i in range(3):
        lap[i, i] = torch.tensor([[0., 1, 0], [1, -4, 1], [0, 1, 0]])
    stem_args = (
        (lap.to(dev) + randn(3, 3, 3, 3, scale=0.1)),
        randn(32, 3, 3, 3, 3, scale=0.2), randn(32, scale=0.1),
        (torch.rand(32, generator=gen) + 0.5).to(dev), randn(32, scale=0.1),
        randn(32, scale=0.1), (torch.rand(32, generator=gen) + 0.5).to(dev),
    )

    def k2_errors(video):
        """fp32 max |kernel - twin| (atol 2e-5), and the share of the bf16
        tolerance |d| <= 8e-3 |fp32| + 1e-5 that the bf16 kernel uses
        against the fp32 result on the same (bf16) input (<= 1 passes)."""
        v16 = video.to(torch.bfloat16)
        got = k2.hf_stem(video, *stem_args)
        got16 = k2.hf_stem(v16, *stem_args).float()
        want = k2.hf_stem_plain(video, *stem_args)
        want16 = k2.hf_stem_plain(v16.float(), *stem_args)
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        err16 = (got16 - want16).abs()
        used16 = float((err16 / (8e-3 * want16.abs() + 1e-5)).max())
        shape = tuple(video.shape)
        check(err32 <= 2e-5, f"K2 fp32 vs twin at {shape}: {err32}")
        check(used16 <= 1.0, f"K2 bf16 vs fp32 result at {shape}: "
                             f"tolerance used {used16}")
        return err32, float(err16.max()), used16

    def k2_row(video):
        err32, err16_max, used16 = k2_errors(video)
        b, t, h, w, _ = video.shape
        ho, wo = k2.out_size(h), k2.out_size(w)
        flops = 2 * b * t * h * w * 3 * 27 + 2 * b * t * ho * wo * 32 * 81 \
            + 2 * b * t * ho * wo * 32
        io32 = 4 * (video.numel() + b * t * ho * wo * 32)
        row = {"shape": list(video.shape), "max_abs_err": err32,
               "bf16_max_abs_err": err16_max, "bf16_tolerance_used": used16,
               "gflop": flops / 1e9, "mbytes_fp32": io32 / 1e6,
               "bound_basis": TENSOR}
        for dtype, tag, io in ((torch.float32, "", io32),
                               (torch.bfloat16, "bf16_", io32 / 2)):
            v = video.to(dtype)
            kms, pms = in_turns(lambda: k2.hf_stem(v, *stem_args),
                                lambda: k2.hf_stem_plain(v, *stem_args),
                                iters=10)
            bms, bby = bound_ms(io, flops, TENSOR)
            row.update({f"{tag}kernel_ms": kms, f"{tag}plain_ms": pms,
                        f"{tag}kernel_over_plain": kms / pms,
                        f"{tag}bound_ms": bms, f"{tag}bound_by": bby,
                        f"{tag}bound_share": bms / kms})
            del v
        return row

    odd = torch.rand(2, 4, 15, 10, 3, generator=gen).to(dev)
    odd_err32, _, odd_used16 = k2_errors(odd)
    emit({"phase": "k2_hf_stem", "shape": list(odd.shape),
          "max_abs_err": odd_err32, "bf16_tolerance_used": odd_used16})
    del odd
    k2_rows = {}
    for b in (1, 16, 128):
        video = torch.rand(b, 32, 96, 96, 3, generator=gen).to(dev)
        k2_rows[b] = k2_row(video)
        emit({"phase": "k2_hf_stem", **k2_rows[b]})
        del video
    torch.cuda.empty_cache()

    # ── 5. requests at full width ─────────────────────────────────────
    cfg = ModelConfig()

    requests = {name: (*req, name != "R1")  # R1 is one window, no track
                for name, req in synthetic.requests(SEED).items()}

    def serve(engine, frames, boxes, y, track, probs=True, stages=None):
        """crop -> mel -> align -> engine, as a user's request runs;
        ``stages`` collects each stage's host-clock ms (synchronised)."""
        marks = [time.perf_counter()]

        def mark():
            if stages is not None:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

        crops = crop_track_on_device(frames, boxes, 0, cfg.crop_size)
        mark()
        mel = audio_mod.preprocess_audio_pcm(y)
        mark()
        n = len(crops)
        if not track:
            audio = align_audio_chunk(mel, 0, n, cfg.audio_frames,
                                      cfg.video_frames)[None]
            mark()
            clip = crops[None, : cfg.video_frames]
            fn = engine.score_probs if probs else engine.score_logits
            out = fn(clip, audio)
        else:
            starts = list(range(0, n - cfg.video_frames + 1, STRIDE))
            audio = np.stack([align_audio_chunk(mel, s, n, cfg.audio_frames,
                                                cfg.video_frames)
                              for s in starts])
            mark()
            fn = (engine.score_track_probs if probs
                  else engine.score_track_logits)
            out = fn(crops, starts, audio)
        mark()
        if stages is not None:
            for key, a, b in zip(("crop", "mel", "align", "engine"),
                                 marks, marks[1:]):
                stages[key] = (b - a) * 1e3
        return out

    def profile_served(fn, top: int = 8):
        """One warm served run under torch.profiler: device busy time (sum
        of kernel times on the card), wall time, and the top kernels."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in p.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            return {"device_busy_ms": None, "wall_ms": wall * 1e3,
                    "note": "profiler reported no device events"}
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        return {"device_busy_ms": busy, "wall_ms": wall * 1e3,
                "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
                "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3,
                                 e.count] for e in kernels[:top]]}

    @contextlib.contextmanager
    def plain_kernels():
        """The same path with each kernel's twin in its place."""
        saved = (audio_mod.log_mel_spectrogram_fused, artifact_mod.hf_stem)
        audio_mod.log_mel_spectrogram_fused = (
            lambda y: k1.finish_db(k1.log_mel_db_plain(y[None]))[0])
        artifact_mod.hf_stem = k2.hf_stem_plain
        try:
            yield
        finally:
            audio_mod.log_mel_spectrogram_fused, artifact_mod.hf_stem = saved

    # Weights: seeded, and the same with every BatchNorm calibrated on
    # R2's windows (fp32, before the counts are set to 0).
    cal_visual, cal_audio = synthetic.track_windows(
        requests["R2"][:3], cfg.video_frames, cfg.crop_size,
        cfg.audio_frames, STRIDE, device=dev)
    seeded = seeded_state_dict(LipSyncModel(cfg), SEED)
    weight_sets = {
        "bn_calibrated": bn_calibrated_state_dict(
            cfg, seeded, cal_visual, cal_audio),
        "seeded": seeded,
    }
    del cal_visual, cal_audio
    engines = {name: (ScoringEngine(w, cfg),  # bf16 on CUDA by default
                      ScoringEngine(w, cfg, use_bfloat16=False))
               for name, w in weight_sets.items()}
    eng16, eng32 = engines["bn_calibrated"]
    check(eng16.model.dtype == torch.bfloat16, "served engine is not bf16")

    # The main path: every count set to 0, the three requests served once.
    k1.launches = k2.launches = 0
    served, per_request = {}, {}
    for name, req in requests.items():
        before = (k1.launches, k2.launches)
        served[name] = serve(eng16, *req)
        torch.cuda.synchronize()
        per_request[name] = (k1.launches - before[0], k2.launches - before[1])
    main_launches = {"log_mel": k1.launches, "hf_stem": k2.launches}
    for name, (n1, n2) in per_request.items():
        check(n1 >= 1 and n2 >= 1,
              f"{name} did not launch both kernels: K1 {n1}, K2 {n2}")

    # Accuracy on both sets of weights: every number is printed before any
    # of them is checked.
    accuracy = {}
    for wname, (e16, e32) in engines.items():
        rows, all_logits = {}, []
        for name, req in requests.items():
            probs16 = (served[name] if wname == "bn_calibrated"
                       else serve(e16, *req))
            logits32 = serve(e32, *req, probs=False)
            before = (k1.launches, k2.launches)
            with plain_kernels():
                logits_plain = serve(e32, *req, probs=False)
            check((k1.launches, k2.launches) == before,
                  "the twin run launched a kernel")
            check(probs16.shape == logits32.shape == logits_plain.shape,
                  f"{wname} {name}: shapes differ")
            check(bool(np.isfinite(probs16).all()
                       and np.isfinite(logits32).all()),
                  f"{wname} {name}: non-finite output")
            rows[name] = {
                "windows": len(probs16),
                "max_abs_dlogit_fp32_kernels_vs_twins":
                    float(np.abs(logits32 - logits_plain).max()),
                "max_abs_dprob_bf16_vs_fp32":
                    float(np.abs(probs16 - e32.calibrator(logits32)).max()),
                "prob_mean_bf16": float(np.mean(probs16)),
            }
            all_logits.append(logits32)
        logits = np.concatenate(all_logits)
        accuracy[wname] = rows, float(logits.std())
        emit({"phase": "accuracy", "weights": wname,
              "logit_std_fp32": float(logits.std()),
              "logit_min_fp32": float(logits.min()),
              "logit_max_fp32": float(logits.max()), "requests": rows})
    # The bf16 bound says little on logits that barely vary.
    check(accuracy["bn_calibrated"][1] >= 0.1,
          f"calibrated logits barely vary: std {accuracy['bn_calibrated'][1]}")
    for wname, (rows, _) in accuracy.items():
        for name, row in rows.items():
            d_logit = row["max_abs_dlogit_fp32_kernels_vs_twins"]
            d_prob = row["max_abs_dprob_bf16_vs_fp32"]
            check(d_logit <= 1e-3,
                  f"{wname} {name}: fp32 kernels vs twins {d_logit}")
            check(d_prob <= 4e-3,
                  f"{wname} {name}: bf16 vs fp32 probability {d_prob}")

    for name, req in requests.items():
        def latency(engine):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(engine, *req)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return statistics.median(times)

        n_win = accuracy["bn_calibrated"][0][name]["windows"]
        lat16, lat32 = latency(eng16), latency(eng32)
        prof = profile_served(lambda: serve(eng16, *req))
        stages = {}
        serve(eng16, *req, stages=stages)
        emit({"phase": "request", "name": name,
              "frames": len(req[0]), "pcm_samples": len(req[2]),
              "windows": n_win, "launches": {"log_mel": per_request[name][0],
                                             "hf_stem": per_request[name][1]},
              "latency_ms_bf16_median5": lat16 * 1e3,
              "windows_per_s_bf16": n_win / lat16,
              "latency_ms_fp32_median5": lat32 * 1e3,
              "windows_per_s_fp32": n_win / lat32,
              "stage_ms_bf16": stages, "profile_bf16": prof})

    # ── 6. kernels ────────────────────────────────────────────────────
    r1_n = 1 << (len(requests["R1"][2]) - 1).bit_length()
    m = k1_rows[max(r1_n, 1 << 14)]
    k2m = k2_rows[16]  # R2's bucket, fp32 as in the earlier slice
    emit({"kernels": [
        {"name": "log_mel", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/mel.cu",
         "replaces": "lipsync_tpu/ops/pallas/mel_kernel.py:65",
         "launches": main_launches["log_mel"],
         "max_abs_err": m["max_abs_err_db"], "ms": m["kernel_ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "bound_basis": m["bound_basis"],
         "library_ms": m["library_ms"]},
        {"name": "hf_stem", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/hf_stem.cu",
         "replaces": "lipsync_tpu/ops/pallas/hf_stem.py:174",
         "launches": main_launches["hf_stem"],
         "max_abs_err": k2m["max_abs_err"], "ms": k2m["kernel_ms"],
         "plain_ms": k2m["plain_ms"], "bound_ms": k2m["bound_ms"],
         "bound_by": k2m["bound_by"], "bound_basis": k2m["bound_basis"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
