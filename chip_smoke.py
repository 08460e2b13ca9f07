#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printed as one JSON line:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the ``nvcc`` build of every kernel (``csrc/*.cu``, one compiler per
   source, all started together), with its seconds, ptxas's registers,
   shared memory and spills (none allowed), K2's blocks per SM (>= 2)
   and no ``wgmma`` that ptxas had to serialise (K3);
3. K1 (log-mel) against its plain twin at 16384 / 32768 / 65536 / 262144
   / 1048576 samples (< 1e-3 dB), with kernel, twin, library (``ops/mel.py``'s
   rFFT chain) and bound times, and on a quiet-band signal against a
   float64 DFT of the same chain (K1 no further than the twin + 2e-4 dB,
   and within the 2.5e-3 dB fp32 floor that the CPU tests pin);
3b. K1 at every parameter set of ``K1_PARAM_SETS`` (the Pallas kernel's
   range: 22.05 kHz / 510 / 128 mels, 8 kHz, uncentred, 13 empty bands,
   an odd n_fft, no floor) at 65536 samples: < 1e-3 dB from its twin on
   white noise, within 2.5e-3 dB of a float64 chain on a tone over noise,
   empty bands at 10 log10(1e-10) dB; event and device times beside the
   twin, ``ops/mel.py`` and the bound, and at the defaults the
   run-time-sized kernel against the fixed one. Outside K1's range the
   audio preprocessing launches no K1 and the wrapper raises; an injected
   K1 failure inside it ends the preprocessing;
4. K2 (HF stem) against its twin at every main-path batch, (B, 32, 96, 96,
   3) for B = 1 / 16 / 128, the refinement's half windows (4, 16, 96, 96,
   3) and the trainers' validation batches (6 and 3, 32, 96, 96, 3), and at
   an odd,
   non-square (2, 4, 15, 10, 3) that leaves partial
   output tiles, the serving phase's buckets (2 / 4 / 8, 32, 96, 96, 3),
   the benchmark's batch of 1024 and the dry run's (2 and 4, 4, 32, 32,
   3): fp32 atol 2e-5, bf16 within
   |d| <= 8e-3 |fp32| + 1e-5 of the fp32 result on the same input; kernel,
   twin and bound times in both dtypes;
4b. K3 (int8 convolution) and K4 (int8 quantize) against their twins at
   every int8 encoder convolution of ``ModelConfig()`` (found by one int8
   forward) at B = 1, 8, 16 and 128 windows and at ten odd shapes with
   partial tiles (five on the halo loop: tiles cut at every border, C_in
   2, 5 and 8, a stride-1 stem): K3's int32 outputs equal, its
   dequantized fp32 and bf16 outputs bit-equal; K4's single launch
   (``absmax_quantize``: int8 values, scale and K3's scale vector) and its
   two-launch ``absmax`` and ``quantize`` bit-equal to their twins on fp32
   and bf16 inputs in both memory layouts (on the odd shapes also a frame
   range, exact half-way ties, an input holding a NaN (scale NaN) and one
   holding -inf); the widths that K3 refuses as they are (C_out 100, C_in
   200 and 320 at layer4 of B = 16) through ``layers.int8_conv``,
   bit-equal to the same call with the twins in the kernels' places. K3's
   device time and bound (int8 tensor-core rate) at every B; at B = 16
   also the dequantizing entry's, the twin, im2col + ``torch._int_mm``,
   the bf16 cuDNN convolution of the same shape, K4's single launch
   against its old pair in turns (per call and device time) beside its
   bound and its twin, and the whole ``layers.int8_conv`` against the
   parent's torch chain around K3's int32 entry (bit-equal; device and
   per-call times in turns); and unequal ``(lo, hi)`` padding pairs
   through ``layers.int8_conv`` (K4 on the input, zeros padded into the
   int8 activation, K3 with none), bit-equal to the twins and to the
   input padded explicitly;
4c. the layer forms that the JAX package's blocks take: ``ConvBNAct``
   and ``ResidualBlockND`` with ``lowering="shift_matmul"`` and
   ``ConvBNAct`` and ``max_pool_same`` at unequal padding pairs, on the
   card against the CPU (float64 within 1e-6; fp32 within 1e-5);
4d. K5 (AV-HuBERT's 3D stem: conv, BatchNorm, PReLU, max-pool in one
   launch) at ``K5_MAIN`` (the AV-HuBERT bulk cell's group: 256 windows
   of 32 frames of 88 x 88) and at the ragged ``K5_ODD``, against the
   module chain (``ResEncoder.frontend3D``) on the card: bit-equal on
   pixels of eighths and weights of sixteenths (every fp32 sum exact);
   on random inputs, the share of pooled values that differ (<= 1e-3) and
   the widest difference, each within ``av_stem.sum_order_bound`` (the
   card test's tolerance); blocks per SM (>= 2 in both staging variants).
   At ``K5_MAIN`` its time per call (CUDA events) and device time
   (profiler) beside its bound (the bf16 tensor-core rate), the twin's
   time (``av_stem_plain`` on the card) and the cuDNN chain with the copy
   into the trunk's frames that K5 replaces (``library_ms``);
4e. K5 on the AV-HuBERT bulk cell's path: ``ScoringEngine`` with
   ``AVHubertConfig()`` scores two groups of 256 windows on seeded,
   BatchNorm-calibrated weights; one launch of K5 a group (the count the
   ``kernels`` line gives K5), and logits within 0.03125 (two bf16 steps)
   of the same engine with the module chain in K5's place;
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
   median of 5;
5b. the engine's ``max_in_flight`` and ``transfer_uint8`` on R2 in fp32
   (``engine_options_phase``): 1 and 2 groups of 4 in flight give equal
   logits, within 1e-3 of one group; windows off the uint8 grid uploaded
   unrounded score as the model on them (1e-5) and otherwise than
   rounded;
6. ``Predictor.predict`` from a clip to a verdict, at the same width and on
   the same calibrated weights, through the served bf16 engine and the fp32
   one: clip S (30 frames + 2.0 s, the short path with refinement and the
   mouth-motion check) and clip L (150 frames + 10 s, the pipelined long
   path, and the batch path once more in bf16), both from
   ``utils/synthetic.py``. The clips are held in memory (``INGEST`` says
   why); the detector is a ``FakeDetector`` with each clip's mouth box. The
   engines must give the same verdict and selected track, |dconfidence| <=
   4e-3; pipelined and batch L the same verdict and window probabilities
   within 1e-3; the fp32 S and L the same verdict, confidence and window
   probabilities within 1e-3 of the same ``predict`` with the twins on the
   card; every ``predict`` must launch K1 and K2; and
   ``predict_from_path`` on a missing file must raise FileNotFoundError.
   Per clip and engine: the median of 5 warm latencies, the predictor's own
   preprocessing / inference split, host stage times and the device's idle
   share.

7. the trainer at the same width (``training``): a corpus of 32 synthetic
   clips (``utils/synthetic.py::write_corpus``); one train step (batch 2,
   dropout 0, SGD with lr 1) on the card against the same step on this
   machine's CPU replaying the card's ReLU masks and max-pool choices
   (loss and metrics within 1e-5, BatchNorm statistics within 1e-5, each
   gradient within ``PARITY_GRAD_TOL`` of its tensor's largest);
   ``run_training`` for 3 epochs of 4 steps at batch 8 with host
   augmentation (phase 1 moves the head and the encoders' BatchNorm
   statistics but no encoder parameter, phase 2 the audio encoder and not
   the visual one), a ``--resume`` that continues at the epoch and phase
   of the metadata, a ``--device-cache`` epoch, ``run_finetune`` with one
   frozen epoch, and clip S served from the finetuned ``best_model_f1``
   through ``Predictor``. Validation and the served clip must launch K2,
   no train step may. Step times (median of 5) at batch 8 and 32, fed from
   the host and from the device cache, with clips/s, peak memory and the
   idle share of a profiled window of 3 steps; once more at batch 32 with
   PyTorch's TF32 defaults on, as a reading only.

8. the HTTP service (``serving``): the calibrated weights saved as a
   ``.pth``, ``Settings`` pointing at it, the port's ``Predictor`` from
   ``settings.to_predictor_config()`` with a detector that knows the
   clips' boxes (``ClipBoxes``), and ``Server(AppState(...),
   load_model=False)``, whose start-up wraps the engine in
   ``CoalescingEngine``, runs the warmup and starts the embedded worker.
   Over stdlib ``urllib``: ``/healthz``; ``POST /api/lip-sync`` of S and L,
   each body equal to ``LipSyncResponse.from_result(predict(clip))`` (every
   float within 1e-6), K1 and K2 launched by each; ``POST /jobs`` of L
   polled to COMPLETED (minimal and debug payloads); the metrics route; 4
   clients posting 8 requests of S (all 200, same verdict, |dconfidence|
   <= 1e-3, fewer coalesced batches than scoring calls). Then p50 / p95
   latency and requests/s at concurrency 1 and 4, and the direct
   ``predict`` of the same predictor. The clips reach the server as upload
   tokens that ``INGEST`` maps back to the clip in memory;
9. the single-card options (``options``): ``Settings(option)`` for the
   default, ``shared_visual_encoding``, ``fold_hf_stem`` and
   ``quantized_int8``, each as a bf16 ``Predictor`` and an fp32 engine
   from ``load_engine`` on the calibrated weights, on S, L and (fp32) R1-R3.
   K1 in every run; K2 in every run but the fold's and none under the fold;
   K3 and K4 only in the int8 engine's runs, 24 launches each per
   forward. Shared: L's window probabilities finite, a one-window track
   within 1e-5 of the per-window engine in fp32. Fold: fp32 |dprob| <=
   1e-3 against the unfolded engine on seeded weights (the JAX package's
   bound), a reading on the calibrated ones. Int8: fp32 logits within 1e-4
   of the same run with K3's and K4's twins in their places; fp32 |dprob|
   <= 5e-3 against the fp32 default on seeded weights, a reading on the
   calibrated ones. Latency of every option's bf16 ``predict`` of S and L,
   median of 5;
10. data parallelism (``data_parallel``): the engine over two shards on
   the one card against one device (default, shared encoding, int8 with
   its lockstep scales: K2 2, K3 48 and K4 96 launches per bucket: the
   shards take K4's two-launch entries), the
   bf16 ``Predictor`` over that mesh, and the trainer as an NCCL world of
   one, each checked against its one-device run; TF32 on vs off as a
   reading.
11. the modules that complete the port (``completion``): the lip
   localizer's trainer (``tools/train_lip_localizer.py``) on 1,024 training
   and 256 validation faces (seeds 0 and 10,000; the JAX script's 40,000
   and 4,000 steps cut to fit the run, and cut from 4,096 and 512 when
   phase 14 came), one Adam step on the card against
   the same step on the CPU from ``init_params(RandomState(1))`` on a batch
   of 256 (loss within 1e-5 relative, each gradient within
   ``PARITY_GRAD_TOL`` of its tensor's largest), 300 steps at batch 256
   with TF32 off (the last logged loss below the first; median step time,
   validation IoU mean and p10), and its ``npz`` loaded into the numpy
   ``LipLocalizer``, whose forward must equal the card's within 1e-5 on
   the validation patches; ``write_corpus`` on the card for 8 clips of 48
   frames as npy, zarr and lmdb (one K1 launch per clip), read back through
   ``training/data.py`` byte for byte alike, and one train step from each
   with the same loss within 1e-6 relative; ``cuda_trace`` around one fp32
   ``predict`` of clip S (the trace must name ``log_mel_kernel`` and
   ``hf_stem_kernel``) with a ``SpanTimer`` around its pre, inference and
   post stages (all three reported); ``LegacyFusionModule(256, 256)`` at B
   = 16, T_v 32 against T_a 41, and ``temporal_aggregation`` with and
   without lengths, card fp32 within 1e-5 of the CPU. The H.264 round trip
   is checked on the CPU only (``tests/test_torch_h264.py``): the card's
   machine has no FFmpeg. The localizer trainer itself runs on the card as
   ``python3 -m lipsync_tpu_torch.tools.train_lip_localizer --out
   weights/lip_localizer.npz`` (the JAX script's defaults).

12. the operational tools (``tools``): ``tools/make_synthetic_dataset.py``
   renders three disjoint splits in memory as ``run_synthetic_eval`` makes
   them (envelope style, jitter, hard negatives, 3 s clips, seeds 1 / 7 /
   13; 8 / 4 / 4 clips per class); ``precompute_training_tensors`` writes
   them on the card (zarr ``full_sequence`` for all three with the centre
   box; on the test split also npy through a ``FakeDetector`` holding that
   box, lmdb and ``fixed_clip``), ``validate_preprocessed`` reads each
   store, ``run_training`` takes 2 epochs of at most 4 steps at batch 8
   (TF32 off after it), ``fit_calibrator`` fits temperature, Platt and
   isotonic, and ``validate_pipeline`` scores the test split in
   preprocessed mode with the bf16 and int8 engines of its command line
   and an fp32 engine, Platt-calibrated, then in video mode four test
   clips through ``Predictor.predict``. No failed clip and no error row;
   K1 once per clip precomputed and per ``predict``; K2 once per eval-mode
   forward; K3 and K4 24 times per int8 forward; uint8 crops within one
   step and the mel within the 2.5e-3 dB fp32 quiet-band floor of the same
   tool run with ``--device cpu`` (the clips are silent between
   syllables), and K1 on the test split's PCM against a float64 chain as
   phase 3 holds it at quiet bands; the calibrators equal to a CPU refit of
   the card's logits; each
   ``metrics.json`` equal to its recomputation from ``predictions.csv``.
   Precompute ms per clip by stage (ingest stand-in, crop, K1, store
   write), training seconds, eval windows/s per engine and the fit's ms.
   Decode, muxing and haar detection are held on the CPU only, by
   ``tests/test_torch_tools_*.py`` (no FFmpeg or cascade files there).

13. the evaluation harnesses and the diagnostics (``evaluation``), each
   through its ``main(argv)`` on the calibrated weights saved as a ``.pth``
   and on clips rendered in memory: an envelope and a phoneme tier (3
   clips per class, 3 s) and the nine fake constructions of
   ``eval_unseen_fakes`` (2 per class) precomputed on the card;
   ``eval_cross_tier`` over both tiers in process and over one through a
   ``python -m ...validate_pipeline`` subprocess; ``eval_unseen_fakes``;
   ``eval_robustness_grid`` over its 12 cells without a codec, a codec
   cell (which must raise: no FFmpeg there) and ``--quantized-int8`` on
   ``clean``; ``eval_shared_encoding`` (3 tracks of 120 frames);
   ``eval_shared_encoding_flips`` (4 clips); ``eval_multiface`` and
   ``measure_articulation_bands`` on a 2-face and a 3-face scene whose
   detector knows every face's box (``SceneBoxes``; the tracker is the
   real one); ``debug_clips``; ``diagnose_sync_signal`` and
   ``inspect_preprocessed_window`` on a tier; ``probe_link_engine`` at
   batch 32, 2 groups, 2 iterations; ``check_epoch`` on a checkpoint the
   phase writes; ``checking_threshold`` on the cross-tier predictions;
   ``diagnose_videos`` on a garbage and a missing file through the port's
   own ingest; ``eval_crop_agreement`` at ``--n 50``. Checks: every tool
   returns, no failed clip or error row, each JSON output carries the JAX
   script's keys (``EVAL_KEYS``), finite shared-encoding deviations, every
   scene face recovered, K1 once per clip precomputed, per track and per
   ``predict``, K2 once per eval-mode forward, K3 and K4 24 times per int8
   forward and only in the int8 grid, and a raising K2 (``eval_cross_tier``,
   whose tiers are preprocessed) or K1 (``debug_clips``) ends the run.
   Every tool's seconds, windows/s of the engine-bound ones, and the
   probe's link MB/s and windows/s.

13b. the benchmark driver (``bench``): ``tools/bench.py::run`` in this
   process at the root ``bench.py``'s card sizes (the model path at 1024
   windows, the engine under its pinned 4 x 128-window payload, the track
   and shared paths, the train step at batch 32); its JSON dict as a phase
   line (its keys the root driver's less ``note``, every number finite,
   ``platform`` "cuda"), then each path's seconds, peak memory and
   launches (K2 on the model, engine, track and shared paths, none in the
   train step). It runs before phase 14, whose ``bench_train_scaling``
   tries a batch of 1024 that does not fit; cuDNN plans picked under that
   memory pressure appear to stay for the rest of the process: run after
   phase 14, the model path at 1024 windows read 1,476 ms a batch against
   907 in a fresh process (one H100 80GB HBM3 at 700 W).

13c. the entry points (``graft``): ``tools/graft_entry.py``'s ``entry()``
   forward (fp32, batch 8) on its example inputs and on a seeded batch,
   within 1e-3 of the twins' forward; ``dryrun_multichip(2)``: one train
   step on two gloo ranks on the CPU (one card), its serving paths over
   ``[cuda:0, cuda:0]`` within 2e-5 of one device (1e-4 shared).

14. the rest of the scripts tier (``scripts``): ``smoke_interference.sh``
   at tiny sizes (4 / 2 clips per class, 1 epoch, 1 scene per kind, 2 per
   unseen construction; inside it ``train_interference_r4.sh`` at 2 / 2
   clips and 1 epoch), which chains the generator, precompute, training
   with the device cache, finetune, the merge, ``fit_calibrator``,
   ``eval_multiface``, ``eval_unseen_fakes`` and the in-line replay as
   child processes; ``run_finetune_jenkins.sh`` (``check_setup``,
   ``run_finetune.sh`` raw-video from the calibrated weights on clips of
   its own, ``validate_pipeline`` on them); ``run_finetune_strict_venv`` without a ``./venv`` (exit 1
   and its message); then in this process ``profile_forward --batch 128
   --iters 5 --artifact-detail`` (every stage ``0 < mfu <= 1`` against
   the bf16 peak, K2 once per artifact, high-frequency and full call),
   ``profile_host --seconds 3 --repeats 3`` (K1 once per repeat),
   ``bench_int8 --batch 128`` (|dprob| <= 5e-3, K3 = K4 = 24 per int8
   forward), ``bench_fold --batch 128`` (|dprob| <= 1e-3, K2 in the
   unfolded arm only), ``diagnose_int8 --batch 16 --iters 3`` (K3's
   accumulators equal to its twin's at every geometry),
   ``bench_train_scaling --batches 32,1024,128`` (1024 an out-of-memory
   row, 128 after it), ``bench_predictor``, ``bench_serving`` with the
   stub and with the model (8 requests each, no error) and
   ``bench_coalesce_r5`` (4 cells). The card's machine has no FFmpeg and
   no cascade files: every process of the phase, the children through a
   ``sitecustomize`` first on their ``PYTHONPATH``, writes and reads clips
   as ``.npz`` payloads at their paths and detects the centre box
   (:func:`file_clips`, :class:`CenterBoxes`); each child appends its
   launches and kernel inputs to a log that the phase reads. ``bench_haar``
   (host only, cascades) is held on the CPU only. Seconds per tool and
   each tool's report.

Phases 5-14 record the shape and dtype of every input that their main
runs give each kernel's wrapper (for K3 also the weight shape, stride,
padding, bias and output dtype; for K4 the memory layout); each must be
one that phase 3, 4 or 4b held against the twin
(the ``main_path_shapes`` line). Then a ``kernels`` line,
the ``nvidia-smi`` line, and the result line
``{"ok": true, "device": {...}}``. Every fp32 comparison runs with TF32 off
(``torch.backends.cudnn.allow_tf32`` defaults to True). Any failure raises
and exits non-zero; nothing is printed as a result when CUDA or the package
is missing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
STRIDE = 8
# The training phase's corpus: clips of 48 frames (3.2 s), and the
# validation batch that run_training's 0.2 split makes of it.
CORPUS_CLIPS = 32
CORPUS_FRAMES = 48
VAL_CLIPS = max(1, int(CORPUS_CLIPS * 0.2))
# Card vs CPU, one train step on one activation pattern: each gradient
# within this share of its tensor's largest.
PARITY_GRAD_TOL = 1e-3

# Published peaks by card: ``utils/device.py::card_peaks`` (dense, no
# sparsity). K2's conv1 runs on the tensor cores, so its bound counts
# operations at the TF32 rate. K1 stays on fp32 SIMT FMA, the only type
# that holds its dB at quiet bands, so its bound keeps the SIMT rate; it
# counts the operations that the function needs (an rFFT, the mel bands'
# supports), not those of the kernel's direct DFT. K3 runs int8 x int8 ->
# int32 on the tensor cores.
SIMT, TENSOR, INT8 = "fp32 SIMT", "TF32 tensor cores", "int8 tensor cores"
# K2 inputs of the served paths beyond phase 4's batches: the server's
# warmup (a two-window track), concurrent requests coalesced into buckets
# of 2, 4 and 8 one-window requests, phase 10's shards (a bucket split
# over two: R3's 128 windows in halves of 64, R2's 16 in halves of 8, a
# ragged bucket of 8 in halves of 4), phase 13's link probe (groups of 32
# windows) and phase 13b's model path (1024 windows, the benchmark's batch).
K2_EXTRA_BATCHES = (2, 4, 8, 32, 64, 1024)
# K2 inputs of phase 13c's dry run (4 frames of 32 x 32): a bucket of 4
# windows on one device and in its halves on two shards.
GRAFT_K2_SHAPES = ((2, 4, 32, 32, 3), (4, 4, 32, 32, 3))
# K1 inputs beyond phase 3's timed buckets: phase 13's shared-encoding
# tracks (120 frames, 8 s of PCM in a bucket of 131072 samples).
K1_EXTRA_SAMPLES = (1 << 17,)
# K1's parameter sets beyond the defaults, as the JAX package's Pallas
# kernel takes them (tests/test_torch_mel.py holds the twin against it at
# each): 22.05 kHz at 128 mels and the widest n_fft whose bins fit its 256
# lanes, 8 kHz, uncentred frames, a filterbank with 13 empty bands, an odd
# n_fft and no floor. Phase 3b holds each at this many samples.
K1_PARAM_SETS = {
    "defaults": {},
    "22050_510_128_128": dict(sr=22050, n_fft=510, hop_length=128,
                              n_mels=128),
    "8000_256_80_40": dict(sr=8000, n_fft=256, hop_length=80, n_mels=40),
    "16000_320_160_64_uncentred": dict(sr=16000, n_fft=320, hop_length=160,
                                       n_mels=64, center=False),
    "16000_256_160_128_empty_bands": dict(sr=16000, n_fft=256,
                                          hop_length=160, n_mels=128),
    "odd_n_fft_401": dict(n_fft=401),
    "no_floor": dict(top_db=None),
}
K1_PARAM_SAMPLES = 65536
# Outside K1's range the audio preprocessing takes ops/mel.py's chain.
K1_OUTSIDE = {"win_length_1024": dict(win_length=1024),
              "n_mels_160": dict(n_mels=160)}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it was printed
    (``t_s``, seconds since the script started)."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def peaks(name: str):
    """``(key, (bytes/s, fp32 SIMT, TF32, int8))`` of the card called
    ``name``, from the port's table."""
    from lipsync_tpu_torch.utils.device import card_peaks

    key, p = card_peaks(name)
    return key, (p.bytes_per_s, p.fp32, p.tf32, p.int8)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def tf32_on() -> None:
    """PyTorch's defaults (cuDNN TF32 on) and matmul TF32 on: what an entry
    point must turn off."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def tf32_flags() -> dict:
    import torch

    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


def mel_float64(y, sr=16000, n_fft=400, hop_length=160, n_mels=80,
                center=True, **_):
    """The log-mel chain of PCM ``y`` in float64, K1's frames: (centred)
    n_fft-sample Hann frames at the hop, power rFFT, the mel bands, dB to
    the clip's peak floored at -80 (by default 400 / 160 / 80 at 16 kHz)."""
    import numpy as np

    from lipsync_tpu_torch.ops import mel as mel_ops
    from lipsync_tpu_torch.ops.kernels import mel as k1

    pad = n_fft // 2 if center else 0
    yp = np.pad(np.asarray(y, np.float64), (pad, pad))
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop_length]
    power = np.abs(np.fft.rfft(
        frames[: k1.n_frames_for(len(y), n_fft, hop_length, center)]
        * mel_ops.hann_window(n_fft).astype(np.float64), axis=-1)) ** 2
    ref = 10 * np.log10(np.maximum(
        power @ mel_ops.mel_filterbank(sr, n_fft, n_mels).T.astype(
            np.float64), 1e-10)).T
    return np.maximum(ref - ref.max(), -80.0)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k1_params(extra: dict) -> dict:
    """K1's keyword arguments for a set of ``K1_PARAM_SETS`` (``top_db`` is
    the wrapper's floor, not the kernel's): every size named, win_length =
    n_fft."""
    full = {"sr": 16000, "n_fft": 400, "hop_length": 160, "n_mels": 80,
            "center": True, **extra}
    full.pop("top_db", None)
    return {**full, "win_length": full["n_fft"]}


def plain_log_mel(y, top_db=80.0, **params):
    """``log_mel_spectrogram_fused`` of one clip with K1's twin in the
    kernel's place."""
    from lipsync_tpu_torch.ops.kernels import mel as k1

    return k1.finish_db(k1.log_mel_db_plain(y[None], **params), top_db)[0]


def k1_key(y, *args, **kwargs) -> tuple:
    """An input of K1's wrapper ``log_mel_db``: shape, dtype and the
    parameter set, defaults filled in."""
    import inspect

    from lipsync_tpu_torch.ops.kernels import mel as k1

    bound = inspect.signature(k1.log_mel_db_plain).bind(y, *args, **kwargs)
    bound.apply_defaults()
    return (*shape_key(y), *(v for k, v in bound.arguments.items()
                             if k != "y"))


def k1_flops(t: int, n_fft: int, support: int) -> float:
    """Operations per clip of t frames that the function needs: the window,
    a real n_fft-point FFT (2.5 N log2 N, half a complex FFT's 5 N log2 N),
    the power c^2 + s^2 and the mel sums over each band's support."""
    import numpy as np

    return t * (n_fft + 2.5 * n_fft * np.log2(n_fft)
                + 3 * (n_fft // 2 + 1) + 2 * support)


class _FailingMelLibrary:
    """K1's library with a launch that fails as a refused launch does."""

    @staticmethod
    def lipsync_log_mel(*args):
        return 700  # cudaErrorIllegalAddress


def engine_options_phase(dev, cfg, weights, eng32, r2) -> dict:
    """Phase 5b: ``ScoringEngine``'s ``max_in_flight`` and
    ``transfer_uint8`` on R2 in fp32. Groups of 4 windows streamed one at
    a time and two at a time (the default) give the same logits, within
    1e-3 of the one-group engine's; R2's windows a third of a uint8 step
    off the grid, uploaded unrounded (``transfer_uint8=False``), score as
    the model does on those fp32 windows (1e-5) and otherwise than the
    rounded default, and uint8 windows score alike in both. R2's time at groups of 4 for 1 and 2 in flight (median
    of 5, in turns) is a reading."""
    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.engine import ScoringEngine

    crops, audio = r2
    starts = list(range(0, len(crops) - cfg.video_frames + 1, STRIDE))
    streamed = {k: ScoringEngine(weights, cfg, use_bfloat16=False,
                                 max_batch=4, max_in_flight=k)
                for k in (1, 2)}
    logits = {k: e.score_track_logits(crops, starts, audio)
              for k, e in streamed.items()}
    one_group = eng32.score_track_logits(crops, starts, audio)

    # The crops lie on the uint8 grid; a third of a step up keeps each
    # pixel's rounding and moves what the unrounded forward sees.
    windows = np.clip(np.stack([crops[s : s + cfg.video_frames]
                                for s in starts]) + 0.3 / 255.0, 0.0, 1.0)
    windows = windows.astype(np.float32)
    raw_eng = ScoringEngine(weights, cfg, use_bfloat16=False,
                            transfer_uint8=False)
    raw = raw_eng.score_logits(windows, audio)
    rounded = eng32.score_logits(windows, audio)
    bucket = 1 << (len(windows) - 1).bit_length()

    def padded(x):
        return np.concatenate([x, np.repeat(x[-1:], bucket - len(x), 0)])

    with torch.inference_mode():
        direct = raw_eng.model(torch.from_numpy(padded(windows)).to(dev),
                             torch.from_numpy(padded(audio)[..., None])
                             .to(dev))[: len(windows)].cpu().numpy()
    u8 = np.clip(windows * 255.0 + 0.5, 0, 255).astype(np.uint8)

    def median_ms(engine):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.score_track_logits(crops, starts, audio)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    ms_1, ms_2 = median_ms(streamed[1]), median_ms(streamed[2])
    ms_2b, ms_1b = median_ms(streamed[2]), median_ms(streamed[1])
    out = {"windows": len(starts), "groups": -(-len(starts) // 4),
           "in_flight_1_vs_2_max_abs": float(
               np.abs(logits[1] - logits[2]).max()),
           "groups_of_4_vs_one_group_max_abs": float(
               np.abs(logits[2] - one_group).max()),
           "unrounded_vs_model_max_abs": float(np.abs(raw - direct).max()),
           "unrounded_vs_rounded_max_abs": float(
               np.abs(raw - rounded).max()),
           "uint8_windows_equal": bool(np.array_equal(
               raw_eng.score_logits(u8, audio),
               eng32.score_logits(u8, audio))),
           "r2_ms_groups_of_4_in_flight_1": (ms_1 + ms_1b) / 2,
           "r2_ms_groups_of_4_in_flight_2": (ms_2 + ms_2b) / 2}
    emit({"phase": "engine_options", **out})
    check(np.array_equal(logits[1], logits[2]),
          f"max_in_flight changed the logits: {out}")
    check(out["groups_of_4_vs_one_group_max_abs"] <= 1e-3,
          f"groups of 4 vs one group: {out}")
    check(out["unrounded_vs_model_max_abs"] <= 1e-5
          and out["unrounded_vs_rounded_max_abs"] > 0
          and out["uint8_windows_equal"],
          f"transfer_uint8=False: {out}")
    return out


def k1_param_phase(dev, rng, time_ms, in_turns, bound_ms, checked) -> dict:
    """Phase 3b: K1 against its twin at every set of ``K1_PARAM_SETS`` at
    ``K1_PARAM_SAMPLES`` samples, on white noise (the JAX package's own
    signal for its < 1e-3 dB bound, tests/test_ops.py): < 1e-3 dB, at an
    empty band 10 log10(1e-10) dB, with kernel, twin, library
    (``ops/mel.py``) and bound times; at the defaults also the
    run-time-sized kernel against the fixed one. On ``synthetic.pcm``
    (a tone over noise, mel bands down at the -80 dB floor) K1 and its twin
    against a float64 chain of the set, floored at -80 dB: K1 within the
    2.5e-3 dB fp32 floor of quiet bands. Kernel times from CUDA events per
    call and from the profiler (``device_ms``). Then the routes around K1:
    outside its range the audio preprocessing launches no K1
    (``ops/mel.py``'s chain, finite, of the right shape) and the wrapper
    raises before a launch; inside it an injected K1 failure ends the
    preprocessing."""
    import numpy as np
    import torch

    from lipsync_tpu_torch.ops import mel as mel_ops
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import audio as audio_mod
    from lipsync_tpu_torch.utils import synthetic

    n = K1_PARAM_SAMPLES
    y2 = torch.from_numpy(
        (0.2 * rng.standard_normal(n)).astype(np.float32)).to(dev)[None]
    yq = synthetic.pcm(rng, n)
    yq2 = torch.from_numpy(yq).to(dev)[None]
    rows = []
    for name, extra in K1_PARAM_SETS.items():
        p = k1_params(extra)
        top_db = extra.get("top_db", 80.0)
        t = k1.n_frames_for(n, p["n_fft"], p["hop_length"], p["center"])
        got = k1.finish_db(k1.log_mel_db(y2, **p), top_db)
        want = k1.finish_db(k1.log_mel_db_plain(y2, **p), top_db)
        lib = mel_ops.log_mel_spectrogram(y2[0], top_db=top_db, **p)
        torch.cuda.synchronize()
        check(got.shape == (1, p["n_mels"], t), f"K1 {name}: {got.shape}")
        err = float((got - want).abs().max())
        checked["log_mel"].add(k1_key(y2, **p))
        ref = mel_float64(yq, **p)
        quiet = {f"{what}_vs_f64_db": float(np.abs(
            k1.finish_db(fn(yq2, **p))[0].cpu().numpy() - ref).max())
            for what, fn in (("kernel", k1.log_mel_db),
                             ("twin", k1.log_mel_db_plain))}
        tables = k1.kernel_tables(dev, p["sr"], p["n_fft"], p["n_mels"])
        bands = tables[4].cpu()
        empty = [m for m in range(p["n_mels"]) if bands[m, 1] < bands[m, 0]]
        support = int((bands[:, 1] - bands[:, 0] + 1).clamp(min=0).sum())
        flops = k1_flops(t, p["n_fft"], support)
        n_bytes = (4 * (n + p["n_mels"] * t)
                   + sum(tb.numel() * tb.element_size() for tb in tables))
        bms, bby = bound_ms(n_bytes, flops)
        kms, pms = in_turns(lambda: k1.log_mel_db(y2, **p),
                            lambda: k1.log_mel_db_plain(y2, **p))
        row = {"set": name, "params": {**p, "top_db": top_db}, "n": n,
               "frames": t, "max_abs_err_db": err,
               "max_abs_err_vs_rfft_db": float((got[0] - lib).abs().max()),
               "quiet_band": quiet, "empty_bands": len(empty),
               "kernel_ms": kms, "plain_ms": pms,
               "kernel_device_ms": device_ms(lambda: k1.log_mel_db(y2, **p),
                                             K1_KERNELS),
               "library_ms": time_ms(lambda: mel_ops.log_mel_spectrogram(
                   y2[0], top_db=top_db, **p)),
               "bound_ms": bms, "bound_by": bby, "bound_basis": SIMT,
               "gflop": flops / 1e9, "mbytes": n_bytes / 1e6}
        if empty:
            absolute = k1.log_mel_db(y2, **p)[0, empty]
            row["empty_band_db"] = [float(absolute.min()),
                                    float(absolute.max())]
        if name == "defaults":
            general = k1._launch(y2, p, t, general=True)
            row["general_vs_fixed_db"] = float(
                (general - k1.log_mel_db(y2, **p)).abs().max())
            row["fixed_ms"], row["general_ms"] = in_turns(
                lambda: k1.log_mel_db(y2, **p),
                lambda: k1._launch(y2, p, t, general=True))
            row["general_device_ms"] = device_ms(
                lambda: k1._launch(y2, p, t, general=True), K1_KERNELS)
        rows.append(row)
        emit({"phase": "k1_params", **row})
        check(err < 1e-3, f"K1 vs twin at {name}: {err} dB")
        check(quiet["kernel_vs_f64_db"] <= 2.5e-3,
              f"K1 past the fp32 floor at quiet bands at {name}: {quiet}")
        check(not empty or max(abs(v + 100.0) for v in row["empty_band_db"])
              <= 1e-4, f"K1 {name}: empty bands {row.get('empty_band_db')}")
        check(name != "defaults" or row["general_vs_fixed_db"] < 1e-3,
              f"K1 run-time-sized vs fixed: {row.get('general_vs_fixed_db')}")

    # The routes around K1.
    pcm = synthetic.pcm(rng, 41000)
    routes = {}
    for name, kw in K1_OUTSIDE.items():
        before = k1.launches
        mel = audio_mod.preprocess_audio_pcm(pcm, device=dev, **kw)
        torch.cuda.synchronize()
        n_mels = kw.get("n_mels", 80)
        cpu = audio_mod.preprocess_audio_pcm(pcm, device="cpu", **kw)
        routes[name] = {"k1_launches": k1.launches - before,
                        "shape": list(mel.shape),
                        "card_vs_cpu_db": float(np.abs(mel - cpu).max())}
        check(k1.launches == before, f"{name}: the chain launched K1")
        check(mel.shape == (n_mels, 1 + len(pcm) // 160)
              and bool(np.isfinite(mel).all()), f"{name}: {mel.shape}")
        try:
            k1.log_mel_spectrogram_fused(
                y2, n_fft=kw.get("win_length", 400),
                win_length=kw.get("win_length", 400), n_mels=n_mels)
            routes[name]["wrapper_raised"] = None
        except ValueError as e:
            routes[name]["wrapper_raised"] = str(e)
        check(routes[name]["wrapper_raised"] is not None
              and k1.launches == before,
              f"{name}: K1's wrapper did not refuse before a launch")
    saved = k1._library
    k1._library = _FailingMelLibrary
    try:
        audio_mod.preprocess_audio_pcm(pcm, win_length=511, n_mels=128,
                                       device=dev)
        routes["injected_failure"] = None
    except RuntimeError as e:
        routes["injected_failure"] = str(e)
    finally:
        k1._library = saved
    emit({"phase": "k1_routes", **routes})
    check(routes["injected_failure"] is not None
          and "log_mel kernel launch failed" in routes["injected_failure"],
          f"an injected K1 failure did not end the call: {routes}")
    return {"rows": rows, "routes": routes}


# How a clip reaches the predictor on the card. The card's machine has no
# FFmpeg libraries or headers (its ldconfig lists no libavformat or
# libavcodec, and /usr/include has no libavformat), so the native ingest
# cannot be built there. The phase keeps each clip in memory and stands in
# for the port's ``ingest.probe``, ``read_video`` and ``read_audio`` only;
# everything from the frames onward is the port's own code.
INGEST = "in_memory"


class InMemoryClips:
    """Readers with the signatures of ``preprocessing/ingest.py`` that
    serve clips held in memory by path, or by the bytes of a file that
    holds a clip's upload token (the HTTP service writes each upload to a
    temporary file and predicts that path); any other path raises
    ``FileNotFoundError``."""

    def __init__(self, ingest_mod, fps: float):
        self.ingest = ingest_mod
        self.fps = fps
        self.clips = {}
        self.uploads = {}

    def add(self, name: str, frames, pcm, path=None) -> str:
        """Serve ``(frames, pcm)`` at ``path`` (``/in-memory/<name>.avi``
        unless given) and to the upload token of ``name``."""
        path = path or f"/in-memory/{name}.avi"
        self.clips[path] = (frames, pcm)
        self.uploads[self.upload(name)] = path
        return path

    @staticmethod
    def upload(name: str) -> bytes:
        """The bytes a client uploads for clip ``name``."""
        return f"chip-smoke in-memory clip {name}".encode()

    def _get(self, path):
        key = str(path)
        if key not in self.clips and Path(key).is_file():
            key = self.uploads.get(Path(key).read_bytes(), key)
        try:
            return self.clips[key]
        except KeyError:
            raise FileNotFoundError(str(path)) from None

    def probe(self, path):
        frames, pcm = self._get(path)
        return self.ingest.MediaInfo(
            width=frames.shape[2], height=frames.shape[1], fps=self.fps,
            duration_sec=len(frames) / self.fps, nb_frames=len(frames),
            has_audio=True, sample_rate=16000)

    def read_video(self, path, target_fps=15.0, max_total_frames=None,
                   out_size=None):
        check(target_fps == self.fps and out_size is None,
              "the in-memory clips are stored at the target rate and size")
        frames = self._get(path)[0]
        return frames[:max_total_frames].copy()

    def read_audio(self, path, sr=16000):
        check(sr == 16000, "the in-memory clips hold 16 kHz PCM")
        return self._get(path)[1].copy()

    @contextlib.contextmanager
    def installed(self):
        saved = (self.ingest.probe, self.ingest.read_video,
                 self.ingest.read_audio)
        self.ingest.probe = self.probe
        self.ingest.read_video = self.read_video
        self.ingest.read_audio = self.read_audio
        try:
            yield
        finally:
            (self.ingest.probe, self.ingest.read_video,
             self.ingest.read_audio) = saved


@contextlib.contextmanager
def kernel_inputs(seen: dict):
    """While open, adds the (shape, dtype) of every input that a kernel's
    wrapper gets to ``seen[name]`` (for K1 with its parameter set,
    :func:`k1_key`; for K3 and K4 the keys of :func:`k3_key` and
    :func:`k4_key`); the wrapper runs as it would."""
    from lipsync_tpu_torch.models import artifact as artifact_mod
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import mel as k1

    saved = (k1.log_mel_db, artifact_mod.hf_stem,
             layers_mod.int8_conv_dequant, layers_mod.absmax,
             layers_mod.quantize, layers_mod.absmax_quantize,
             layers_mod.int8_conv_int32)

    def logged(name, fn, key=lambda x, *args, **kwargs: shape_key(x)):
        def call(x, *args, **kwargs):
            seen.setdefault(name, set()).add(key(x, *args, **kwargs))
            return fn(x, *args, **kwargs)
        return call

    k1.log_mel_db = logged("log_mel", saved[0], k1_key)
    artifact_mod.hf_stem = logged("hf_stem", saved[1])
    layers_mod.int8_conv_dequant = logged("int8_conv", saved[2], k3_key)
    layers_mod.absmax = logged("int8_quant", saved[3], k4_key)
    layers_mod.quantize = logged("int8_quant", saved[4], k4_key)
    layers_mod.absmax_quantize = logged("int8_quant", saved[5], k4_key)
    layers_mod.int8_conv_int32 = logged("int8_conv", saved[6], k3_int32_key)
    try:
        yield
    finally:
        (k1.log_mel_db, artifact_mod.hf_stem, layers_mod.int8_conv_dequant,
         layers_mod.absmax, layers_mod.quantize, layers_mod.absmax_quantize,
         layers_mod.int8_conv_int32) = saved


def shape_key(x) -> tuple:
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


def conv_key(x, w, stride, padding) -> tuple:
    """K3's geometry: activation shape, weight shape, stride, padding."""
    return (tuple(x.shape), tuple(w.shape), tuple(int(v) for v in stride),
            tuple(int(v) for v in padding))


def k3_key(x, w, scale, bias, out_dtype, stride, padding, **_) -> tuple:
    """An input of K3's dequantizing entry: its geometry, whether it adds a
    bias, and the dtype it writes."""
    return (*conv_key(x, w, stride, padding), bias is not None,
            str(out_dtype).removeprefix("torch."))


def k3_int32_key(x, w, stride, padding, **_) -> tuple:
    """An input of K3's int32 entry: its geometry, and that it writes
    int32."""
    return (*conv_key(x, w, stride, padding), False, "int32")


def k4_key(x, arg=None, **_) -> tuple:
    """An input of K4 (``absmax(x, frames)``, ``quantize(x, scale)`` or
    ``absmax_quantize(x, w_scale)``): shape, dtype, memory layout, and
    whether absmax read a frame range. The single launch and the pair
    share a key, and phase 4b holds both on each key it checks."""
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4

    return (*shape_key(x), k4.layout_of(x), isinstance(arg, tuple))


class ClipBoxes:
    """A detector for many clips at once: each known frame's mouth box,
    looked up by a fingerprint of the frame's pixels; other frames have
    none. It keeps no per-video state (``FakeDetector`` counts frames), so
    concurrent requests can share it."""

    name = "fake"

    def __init__(self):
        self.boxes = {}

    @staticmethod
    def key(frame) -> bytes:
        return frame[::29, ::31].tobytes()

    def add(self, frames, boxes) -> None:
        for f, b in zip(frames, boxes):
            self.boxes[self.key(f)] = tuple(b)
        check(len({self.key(f) for f in frames}) == len(frames),
              "clip frames share a fingerprint")

    def reset(self) -> None:
        pass

    def detect(self, frame):
        from lipsync_tpu_torch.preprocessing.face_detection import Detection

        box = self.boxes.get(self.key(frame))
        return [] if box is None else [Detection(bbox=box, detector="fake")]


class StageClock:
    """Host time per stage, summed over the wrapped functions' calls. An
    outer stage counts only when no other outer stage is running, so the
    outer stages add up without overlap; an inner stage (``inner=True``) is
    a part of an outer one, timed on its own. A wrapped function either
    reads its result back to the host (its time includes the device's) or
    only enqueues device work (its time is the host's enqueue)."""

    def __init__(self):
        self.ms = {}
        self.outer = set()
        self._depth = 0
        self._saved = []

    def wrap(self, owner, attr: str, stage: str, inner: bool = False):
        fn = getattr(owner, attr)
        if not inner:
            self.outer.add(stage)

        def timed(*args, **kwargs):
            counted = inner or self._depth == 0
            self._depth += not inner
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= not inner
                if counted:
                    self.ms[stage] = (self.ms.get(stage, 0.0)
                                      + (time.perf_counter() - t0) * 1e3)

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


class PredictorLog(logging.Handler):
    """Keeps the predictor's own log records: their arguments hold its
    ``perf_counter`` points (preprocessing, inference and total ms)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def split_ms(self):
        """(preprocessing, inference, total) ms of the last ``predict``."""
        pre = inf = total = None
        for r in self.records:
            msg = r.msg
            if msg.startswith("Preprocessing completed"):
                pre = float(r.args[0])
            elif msg.startswith("Inference completed"):
                total, inf = float(r.args[3]), float(r.args[4])
            elif msg.startswith("Long-video inference done"):
                total, pre, inf = (float(r.args[4]), float(r.args[5]),
                                   float(r.args[6]))
        return {"preprocessing": pre, "inference": inf, "total": total}


def predictor_phase(eng16, eng32, cfg, profile_served, plain_kernels,
                    record) -> dict:
    """``Predictor.predict`` on two in-memory clips at full width, on the
    served bf16 engine and the fp32 one. S (30 frames, 2.0 s) takes the
    short path with refinement (``refine_margin`` 1.5 sends its one track
    through ``_temporal_smoothed_confidence``) and the mouth-motion check;
    L (150 frames, 10 s) the pipelined long path, and once more the batch
    path. The detector is a ``FakeDetector`` with the clip's mouth box on
    every frame. ``plain_kernels`` puts the twins in the kernels' place;
    ``record`` records the kernels' inputs over the main run. Returns the
    kernels' launches over the main run."""
    import numpy as np
    import torch

    from lipsync_tpu_torch.inference import pipelined as pipelined_mod
    from lipsync_tpu_torch.inference import predictor as predictor_mod
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import audio as audio_mod
    from lipsync_tpu_torch.preprocessing import haar
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing import video as video_mod
    from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
    from lipsync_tpu_torch.utils import synthetic

    rng = np.random.default_rng(SEED)
    clips = {"S": synthetic.request(rng, 30, 2.0),
             "L": synthetic.request(rng, 150, 150 / synthetic.FPS)}
    memory = InMemoryClips(ingest, synthetic.FPS)
    paths = {name: memory.add(name, frames, pcm)
             for name, (frames, _, pcm) in clips.items()}
    configs = {"S": PredictorConfig(refine_margin=1.5),
               "L": PredictorConfig(),
               "L_batch": PredictorConfig(pipelined_long_video=False)}
    engines = {"bf16": eng16, "fp32": eng32}

    def predictor(run: str, dtype: str) -> Predictor:
        boxes = clips[run[0]][1]
        return Predictor(
            config=configs[run], model_config=cfg, engine=engines[dtype],
            detector_backend=FakeDetector(lambda i: [boxes[i]]))

    log = PredictorLog()
    plog = logging.getLogger(predictor_mod.__name__)
    saved_handlers = plog.handlers[:]
    plog.handlers = [log]

    def predict(run: str, dtype: str, pred=None):
        """One synchronised ``predict``: (result, K1 and K2 launches,
        seconds)."""
        pred = pred or predictor(run, dtype)
        torch.cuda.synchronize()
        before = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        result = pred.predict(paths[run[0]])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return result, (k1.launches - before[0],
                        k2.launches - before[1]), seconds

    def window_probs(result):
        return np.asarray(result["tracks"][0]["window_confidences"])

    runs = [(run, dtype) for run in ("S", "L") for dtype in ("bf16", "fp32")]
    runs.append(("L_batch", "bf16"))
    compare = {}
    with memory.installed():
        # The main run: every count set to 0, each clip predicted once per
        # engine, and L once more through the batch path.
        k1.launches = k2.launches = 0
        results, launches = {}, {}
        with record():
            for run, dtype in runs:
                results[run, dtype], launches[run, dtype], _ = predict(
                    run, dtype)
        main_launches = {"log_mel": k1.launches, "hf_stem": k2.launches}

        # fp32 S and L once more with the twins in the kernels' place.
        for clip in ("S", "L"):
            with plain_kernels():
                twin, n, _ = predict(clip, "fp32")
            check(n == (0, 0), "the twin run launched a kernel")
            r32 = results[clip, "fp32"]
            p32, p_twin = window_probs(r32), window_probs(twin)
            compare[f"{clip}_fp32_kernels_vs_twins"] = {
                "same_verdict": r32["verdict"] == twin["verdict"],
                "abs_dconfidence": abs(r32["confidence"] - twin["confidence"]),
                "max_abs_dprob": (float(np.abs(p32 - p_twin).max())
                                  if len(p32) == len(p_twin) else None),
            }

        rows = {}
        for run, dtype in runs:
            r = results[run, dtype]
            rows[run, dtype] = {
                "verdict": r["verdict"], "confidence": r["confidence"],
                "selected_track_id": r["selected_track_id"],
                "tracks": len(r["tracks"] or []),
                "windows": len(window_probs(r)) if r["tracks"] else 0,
                "launches": {"log_mel": launches[run, dtype][0],
                             "hf_stem": launches[run, dtype][1]},
            }
        for clip in ("S", "L"):
            r16, r32 = results[clip, "bf16"], results[clip, "fp32"]
            compare[f"{clip}_bf16_vs_fp32"] = {
                "same_verdict": r16["verdict"] == r32["verdict"],
                "same_track": (r16["selected_track_id"]
                               == r32["selected_track_id"]),
                "abs_dconfidence": abs(r16["confidence"] - r32["confidence"]),
            }
        pipe, batch = results["L", "bf16"], results["L_batch", "bf16"]
        p_pipe, p_batch = window_probs(pipe), window_probs(batch)
        compare["L_pipelined_vs_batch_bf16"] = {
            "same_verdict": pipe["verdict"] == batch["verdict"],
            "windows": [len(p_pipe), len(p_batch)],
            "max_abs_dprob": (float(np.abs(p_pipe - p_batch).max())
                              if len(p_pipe) == len(p_batch) else None),
        }
        try:
            predictor("S", "bf16").predict_from_path("/no/such/clip.avi")
            missing = "returned"
        except FileNotFoundError:
            missing = "FileNotFoundError"
        emit({"phase": "predictor", "ingest": INGEST,
              "runs": {f"{r}_{d}": row for (r, d), row in rows.items()},
              "compare": compare, "main_launches": main_launches,
              "predict_from_path_missing": missing})

        # Every number is printed before any of them is checked.
        for (run, dtype), (n1, n2) in launches.items():
            check(n1 >= 1 and n2 >= 1, f"predict {run} {dtype} did not "
                                       f"launch both kernels: {n1}, {n2}")
        for name, c in compare.items():
            check(c["same_verdict"], f"{name}: verdicts differ")
            if "same_track" in c:
                check(c["same_track"], f"{name}: selected tracks differ")
            # bf16 vs fp32 within 4e-3; fp32 kernels vs twins within 1e-3
            bound = 4e-3 if "bf16_vs_fp32" in name else 1e-3
            if "abs_dconfidence" in c:
                check(c["abs_dconfidence"] <= bound,
                      f"{name}: |dconfidence| {c['abs_dconfidence']}")
            if "max_abs_dprob" in c:
                check(c["max_abs_dprob"] is not None
                      and c["max_abs_dprob"] <= 1e-3,
                      f"{name}: window probabilities {c}")
        check(missing == "FileNotFoundError",
              "predict_from_path on a missing file did not raise")

        # Latency, the stage split and the device's idle share.
        for run, dtype in runs:
            pred = predictor(run, dtype)
            times = [predict(run, dtype, pred)[2] for _ in range(5)]
            prof = profile_served(lambda: pred.predict(paths[run[0]]))
            clock = StageClock()
            clock.wrap(ingest, "read_video", "decode")
            clock.wrap(predictor_mod, "preprocess_audio", "audio")
            clock.wrap(audio_mod, "preprocess_audio_pcm", "mel", inner=True)
            clock.wrap(predictor_mod, "detect_voice_activity", "vad")
            clock.wrap(pred.backend, "detect", "detection")
            clock.wrap(video_mod, "track_faces", "tracking")
            clock.wrap(video_mod, "crop_track_on_device", "crop_device")
            clock.wrap(pipelined_mod, "crop_mouth_uint8", "crop_host")
            for attr in ("score_probs", "score_track_probs"):
                clock.wrap(pred.engine, attr, "scoring")
            clock.wrap(pred.engine, "dispatch_track_logits",
                       "scoring_dispatch")
            log.records.clear()
            try:
                _, n, seconds = predict(run, dtype, pred)
            finally:
                clock.restore()
            outer = sum(v for k, v in clock.ms.items() if k in clock.outer)
            split = log.split_ms()
            emit({"phase": "predictor_latency", "run": run, "dtype": dtype,
                  "frames": len(clips[run[0]][0]),
                  "latency_ms_median5": statistics.median(times) * 1e3,
                  "latency_ms_all": [t * 1e3 for t in times],
                  "launches_per_predict": {"log_mel": n[0], "hf_stem": n[1]},
                  "predictor_split_ms": split,
                  "stage_ms": clock.ms,
                  # tracking inside the pipelined loop, the device readback
                  # of the pipelined path, speaking scores and the policy
                  "stage_ms_rest": seconds * 1e3 - outer,
                  "profile": prof})
            check(None not in split.values(),
                  f"the predictor's log gave no split for {run}: {split}")

        # The default detector, where the card has the cascade files.
        frontal = haar.find_cascade_file("haarcascade_frontalface_default.xml")
        if frontal is None:
            emit({"phase": "predictor_default_backend",
                  "skipped": "no haarcascade_frontalface_default.xml under "
                             + " or ".join(haar.CASCADE_SEARCH_DIRS)})
        else:
            result = Predictor(config=configs["L"], model_config=cfg,
                               engine=eng16).predict(paths["L"])
            emit({"phase": "predictor_default_backend",
                  "tracks": len(result["tracks"] or []),
                  "verdict": result["verdict"]})
    plog.handlers = saved_handlers
    return main_launches


@contextlib.contextmanager
def activation_pattern(tape: list, replay: bool, seen: dict):
    """While open, records (``replay`` False) or replays (True) in call
    order every ReLU mask and every max-pool choice of the port's model and
    losses. A gradient is discontinuous where a ReLU input or two pooled
    values lie within rounding of each other, and two devices' fp32 may
    take different sides there; replaying one device's pattern on the
    other compares the two gradients of the same smooth function. ``seen``
    collects, in replay, how many recorded choices the replaying device
    would have made otherwise, and the largest such input relative to its
    tensor's scale (0 where none flipped)."""
    import torch
    import torch.nn.functional as F

    from lipsync_tpu_torch.models import audio_encoder, visual_encoder

    relu, pool = F.relu, visual_encoder.max_pool_same
    it = iter(tape)
    seen.update(relu_flips=0, pool_flips=0, relu_flip_scale=0.0)

    def relu_(x, inplace=False):
        if not replay:
            tape.append((x > 0).cpu())
            return relu(x)
        mask = next(it).to(x.device)
        flipped = (x > 0) != mask
        n = int(flipped.sum())
        if n:
            xd = x.detach()
            seen["relu_flips"] += n
            seen["relu_flip_scale"] = max(
                seen["relu_flip_scale"],
                float(xd[flipped].abs().max() / xd.std()))
        # In the memory layout of relu's own output: dropout lays its noise
        # out in memory order.
        return torch.empty_like(x).copy_(x * mask)

    def pool_(x, window, strides, padding):
        fn = {2: F.max_pool2d, 3: F.max_pool3d}[len(window)]
        out, idx = fn(x, tuple(window), tuple(strides),
                      tuple(p[0] for p in padding), return_indices=True)
        if not replay:
            tape.append(idx.cpu())
            return out
        rec = next(it).to(x.device)
        seen["pool_flips"] += int((rec != idx).sum())
        return torch.empty_like(out).copy_(
            x.flatten(2).gather(2, rec.flatten(2)).view(rec.shape))

    F.relu = relu_
    visual_encoder.max_pool_same = audio_encoder.max_pool_same = pool_
    try:
        yield
    finally:
        F.relu = relu
        visual_encoder.max_pool_same = audio_encoder.max_pool_same = pool


class SGD1:
    """``torch.optim.SGD(lr=1)`` with the port optimizer's interface: one
    step moves each parameter by exactly its gradient."""

    def __init__(self, model):
        import torch

        self.opt = torch.optim.SGD(model.parameters(), lr=1.0)
        self.param_groups = self.opt.param_groups

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        self.opt.step()


def conv_biases_before_batchnorm(model) -> set:
    """A conv bias in front of a training-mode BatchNorm has a zero
    gradient in exact arithmetic: two runs hold rounding noise there."""
    import torch

    zero = set()
    for name, mod in model.named_modules():
        kids = list(mod.children()) if isinstance(mod, torch.nn.Sequential) \
            else []
        for i, (a, b) in enumerate(zip(kids, kids[1:])):
            if (isinstance(a, torch.nn.modules.conv._ConvNd)
                    and a.bias is not None
                    and isinstance(b, torch.nn.modules.batchnorm._BatchNorm)):
                zero.add(f"{name}.{i}.bias")
    return zero


def training_parity(dev, cfg) -> dict:
    """One train step at full width, batch 2, dropout 0, augmentation off,
    a fixed shift and seeded weights, with SGD(lr=1): on the card, then on
    the card machine's CPU replaying the card's activation pattern. Returns
    the comparison; the caller checks it."""
    import dataclasses

    import numpy as np
    import torch

    from lipsync_tpu_torch.models import LipSyncModel, seeded_state_dict
    from lipsync_tpu_torch.training import steps

    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    weights = seeded_state_dict(LipSyncModel(cfg0), SEED)
    rng = np.random.default_rng(SEED)
    batch = {
        "visual": rng.integers(0, 256, (2, cfg.video_frames, cfg.crop_size,
                                        cfg.crop_size, 3), dtype=np.uint8),
        "audio": rng.uniform(-80, 0, (2, cfg.mel_bins, cfg.audio_frames, 1)
                             ).astype(np.float32),
        "label": np.asarray([1.0, 0.0], np.float32),
    }
    tape = []

    def run(device, replay):
        model = LipSyncModel(cfg0)
        model.load_state_dict(weights)
        model.to(device)
        state = steps.create_train_state(model, SGD1(model), SEED)
        seen = {}
        t0 = time.perf_counter()
        with activation_pattern(tape, replay, seen):
            metrics = steps.make_train_step(steps.LossConfig())(
                state, {k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()}, shift=5)
            metrics = {k: float(v) for k, v in metrics.items()}
        seconds = time.perf_counter() - t0
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in model.named_buffers()
                 if "running" in n}
        return metrics, grads, stats, seen, seconds

    card = run(dev, False)
    cpu = run(torch.device("cpu"), True)
    metric_rel = {k: abs(card[0][k] - cpu[0][k]) / max(abs(cpu[0][k]), 1e-6)
                  for k in cpu[0]}
    zero = conv_biases_before_batchnorm(LipSyncModel(cfg0))
    grad_rel = {n: float((card[1][n] - g).abs().max() / g.abs().max())
                for n, g in cpu[1].items() if n not in zero}
    stat_rel = {n: float((card[2][n] - s).abs().max()
                         / max(1.0, float(s.abs().max())))
                for n, s in cpu[2].items()}
    worst = sorted(((v, n) for n, v in grad_rel.items()), reverse=True)[:5]
    return {"metrics_card": card[0], "metrics_cpu": cpu[0],
            "metric_rel": metric_rel, "grad_rel_worst5": worst,
            "grad_rel_max": worst[0][0],
            "zero_grads": sorted(zero),
            "zero_grads_max": max(float(side[1][n].abs().max())
                                  for side in (card, cpu) for n in zero),
            "stat_rel_max": max(stat_rel.values()),
            "replay": cpu[3], "pattern_entries": len(tape),
            "seconds_card": card[4], "seconds_cpu": cpu[4]}


def training_phase(dev, cfg, profile_steps, record) -> dict:
    """The trainer on the card at the width of ``cfg``: a synthetic
    corpus, the one-step card-vs-CPU parity, ``run_training`` (phases,
    resume, device cache), ``run_finetune``, the trained checkpoint served
    through ``Predictor``, and step times. Returns the kernels' launches
    over the main run."""
    import tempfile

    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.models import LipSyncModel
    from lipsync_tpu_torch.ops.augment import AugmentConfig
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
    from lipsync_tpu_torch.training import checkpoints as ckpt
    from lipsync_tpu_torch.training import finetune as finetune_mod
    from lipsync_tpu_torch.training import train as train_mod
    from lipsync_tpu_torch.training.data import BatchLoader, LipSyncDataset
    from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
    from lipsync_tpu_torch.training.steps import (
        LossConfig,
        create_train_state,
        make_train_step,
    )
    from lipsync_tpu_torch.utils import synthetic

    def sync():
        torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_training_"))
    corpus = synthetic.write_corpus(work / "corpus", n_clips=CORPUS_CLIPS,
                                    n_frames=CORPUS_FRAMES,
                                    crop_size=cfg.crop_size, seed=SEED,
                                    device=dev)
    emit({"phase": "training_corpus", "clips": CORPUS_CLIPS,
          "frames": CORPUS_FRAMES,
          "seconds": time.perf_counter() - t_phase})

    parity = training_parity(dev, cfg)
    emit({"phase": "training_parity", **parity})
    # Tolerances: loss and metrics 1e-5 relative; every BatchNorm buffer
    # 1e-5 (relative where its values exceed 1); each gradient within
    # PARITY_GRAD_TOL of its tensor's largest, on one activation pattern.
    # A gradient that is zero in exact arithmetic (a conv bias in front of
    # a training-mode BatchNorm) must stay rounding noise (< 1e-6).
    for k, v in parity["metric_rel"].items():
        check(v <= 1e-5, f"train-step {k}: card vs CPU {v}")
    check(parity["stat_rel_max"] <= 1e-5,
          f"BatchNorm statistics: card vs CPU {parity['stat_rel_max']}")
    check(parity["grad_rel_max"] <= PARITY_GRAD_TOL,
          f"gradients: card vs CPU {parity['grad_rel_worst5']}")
    check(len(parity["zero_grads"]) == 4 and parity["zero_grads_max"] < 1e-6,
          f"zero gradients: {parity['zero_grads']} {parity['zero_grads_max']}")

    # ── run_training, run_finetune and the served checkpoint ──────────────
    out = work / "weights"
    geometry = ["--video-frames", str(cfg.video_frames),
                "--crop-size", str(cfg.crop_size),
                "--audio-frames", str(cfg.audio_frames)]
    base = ["--preprocessed-dir", str(corpus), "--output-dir", str(out),
            "--batch-size", "8", "--max-steps-per-epoch", "4",
            "--phase2-start-epoch", "1", "--phase3-start-epoch", "2",
            *geometry]
    saved, step_k2, val_k2, losses = {}, [], [], []
    real_save, real_validate = ckpt.save_checkpoint, train_mod.validate
    real_make_step = train_mod.make_train_step

    def save_spy(path, state_dict, metadata=None):
        if Path(path).name == "latest" and Path(path).parent == out:
            saved[metadata["epoch"]] = {k: v.detach().cpu().clone()
                                        for k, v in state_dict.items()}
        real_save(path, state_dict, metadata)

    def validate_spy(*args, **kwargs):
        before = k2.launches
        result = real_validate(*args, **kwargs)
        val_k2.append(k2.launches - before)
        return result

    def make_step_spy(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def counted(state, batch, shift=None):
            before = k2.launches
            metrics = step(state, batch, shift)
            losses.append(float(metrics["loss"]))
            step_k2.append(k2.launches - before)
            return metrics
        return counted

    ckpt.save_checkpoint = save_spy
    train_mod.validate = finetune_mod.validate = validate_spy
    train_mod.make_train_step = finetune_mod.make_train_step = make_step_spy
    predict_launches = None
    seconds = {}
    try:
        # The main run: every count set to 0, then the trainer, the resume,
        # the device cache, the finetune and the served checkpoint.
        k1.launches = k2.launches = 0
        with record():
            tf32_on()
            t0 = time.perf_counter()
            history = train_mod.run_training(
                train_mod.build_argparser().parse_args(
                    base + ["--epochs", "3"]), device=dev)
            seconds["run_training"] = time.perf_counter() - t0
            tf32_after = {"run_training": tf32_flags()}
            meta = {name: ckpt.load_metadata(out / name)
                    for name in ("latest", "best_model_loss",
                                 "best_model_accuracy")}

            t0 = time.perf_counter()
            resumed = train_mod.run_training(
                train_mod.build_argparser().parse_args(
                    base + ["--epochs", "4", "--resume", str(out / "latest"),
                            "--max-steps-per-epoch", "2"]), device=dev)
            seconds["resume"] = time.perf_counter() - t0
            meta_resumed = ckpt.load_metadata(out / "latest")

            t0 = time.perf_counter()
            cached = train_mod.run_training(
                train_mod.build_argparser().parse_args(
                    ["--preprocessed-dir", str(corpus), "--output-dir",
                     str(work / "cached"), "--batch-size", "8",
                     "--max-steps-per-epoch", "4", "--epochs", "1",
                     "--phase3-start-epoch", "0", "--device-cache",
                     *geometry]), device=dev)
            seconds["device_cache"] = time.perf_counter() - t0

            tf32_on()
            t0 = time.perf_counter()
            ft = work / "finetune"
            ft_history = finetune_mod.run_finetune(
                finetune_mod.build_argparser().parse_args(
                    ["--preprocessed-dir", str(corpus),
                     "--checkpoint", str(out / "latest"),
                     "--output-dir", str(ft), "--batch-size", "8",
                     "--max-steps-per-epoch", "4", "--epochs", "2",
                     "--frozen-epochs", "1", *geometry]), device=dev)
            seconds["run_finetune"] = time.perf_counter() - t0
            tf32_after["run_finetune"] = tf32_flags()
            ft_meta = {name: ckpt.load_metadata(ft / name)
                       for name in ("best_frozen_loss", "best_model_f1")}

            # Serve the finetuned checkpoint: clip S through Predictor.
            rng = np.random.default_rng(SEED)
            frames, boxes, pcm = synthetic.request(rng, 30, 2.0)
            memory = InMemoryClips(ingest, synthetic.FPS)
            path = memory.add("S_trained", frames, pcm)
            pred = Predictor(model_path=ft / "best_model_f1",
                             config=PredictorConfig(refine_margin=1.5),
                             model_config=cfg,
                             detector_backend=FakeDetector(
                                 lambda i: [boxes[i]]), device=dev)
            with memory.installed():
                before = (k1.launches, k2.launches)
                served = pred.predict(path)
                sync()
            predict_launches = (k1.launches - before[0],
                                k2.launches - before[1])
        main_launches = {"log_mel": k1.launches, "hf_stem": k2.launches}
    finally:
        ckpt.save_checkpoint, train_mod.validate = real_save, real_validate
        finetune_mod.validate = real_validate
        train_mod.make_train_step = finetune_mod.make_train_step = \
            real_make_step

    torch.manual_seed(int(train_mod.build_argparser().parse_args(
        []).seed))  # run_training's initial weights
    init = {k: v.clone() for k, v in LipSyncModel(cfg).state_dict().items()}

    def moved(a, b, prefix, stats=False):
        keys = [k for k in a if k.startswith(prefix) and "num_batches" not in k
                and ("running_" in k) == stats]
        return sum(not torch.equal(a[k], b[k]) for k in keys), len(keys)

    phases = {
        "epoch0_visual_params": moved(init, saved[0], "visual_encoder."),
        "epoch0_audio_params": moved(init, saved[0], "audio_encoder."),
        "epoch0_visual_stats": moved(init, saved[0], "visual_encoder.", True),
        "epoch0_audio_stats": moved(init, saved[0], "audio_encoder.", True),
        "epoch0_head_params": moved(init, saved[0], "classifier."),
        "epoch1_audio_params": moved(saved[0], saved[1], "audio_encoder."),
        "epoch1_visual_params": moved(saved[0], saved[1], "visual_encoder."),
        "epoch2_visual_params": moved(saved[1], saved[2], "visual_encoder."),
    }
    for entry, flags in tf32_after.items():
        check(flags == {"cudnn": False, "matmul": False},
              f"{entry} left TF32 on: {flags}")
    emit({"phase": "training_run", "tf32_after": tf32_after,
          "history": history,
          "resumed": resumed, "device_cache": cached,
          "finetune": ft_history, "seconds": seconds,
          "meta_latest": meta["latest"], "meta_resumed": meta_resumed,
          "finetune_meta_keys": {k: sorted(v) for k, v in ft_meta.items()},
          "moved_of": phases, "losses": losses,
          "k2_per_train_step": sorted(set(step_k2)),
          "k2_per_validation": val_k2, "main_launches": main_launches,
          "served": {"verdict": served["verdict"],
                     "confidence": served["confidence"],
                     "launches": {"log_mel": predict_launches[0],
                                  "hf_stem": predict_launches[1]}}})
    train_keys = {"epoch", "phase", "train_loss", "train_accuracy",
                  "val_loss", "val_accuracy", "best_val_loss",
                  "best_val_accuracy", "video_frames", "audio_frames",
                  "crop_size"}
    for name, m in meta.items():
        check(set(m) == train_keys, f"{name} metadata keys: {sorted(m)}")
    check(meta["latest"]["epoch"] == 2 and meta["latest"]["phase"] == 3,
          f"latest after 3 epochs: {meta['latest']}")
    check(phases["epoch0_visual_params"][0] == 0
          and phases["epoch0_audio_params"][0] == 0,
          f"phase 1 moved an encoder parameter: {phases}")
    check(phases["epoch0_visual_stats"][0] > 0
          and phases["epoch0_audio_stats"][0] > 0
          and phases["epoch0_head_params"][0] > 0,
          f"phase 1 left the head or the encoders' statistics: {phases}")
    check(phases["epoch1_audio_params"][0] > 0
          and phases["epoch1_visual_params"][0] == 0,
          f"phase 2 moved visual or left audio: {phases}")
    check(phases["epoch2_visual_params"][0] > 0,
          f"phase 3 left the visual encoder: {phases}")
    check(all(np.isfinite(losses)) and len(losses) > 0,
          f"non-finite training loss: {losses}")
    check(meta_resumed["epoch"] == 3 and meta_resumed["phase"] == 3
          and resumed["epoch"] == 3,
          f"resume did not follow the metadata: {meta_resumed}")
    check(np.isfinite(cached["val_loss"]), f"device-cache run: {cached}")
    check(all("f1_threshold" in m for m in ft_meta.values()),
          f"finetune checkpoints: {ft_meta}")
    check(step_k2 and set(step_k2) == {0}, "a train step launched K2")
    check(val_k2 and min(val_k2) >= 1, f"validation without K2: {val_k2}")
    check(predict_launches[0] >= 1 and predict_launches[1] >= 1
          and served["verdict"] and np.isfinite(served["confidence"]),
          f"served checkpoint: {served['verdict']} {predict_launches}")

    # ── step times at batch 8 and 32, host-fed and from the device cache ──
    torch.manual_seed(SEED)
    model = LipSyncModel(cfg).to(dev)
    state = create_train_state(
        model, PhaseOptimizer(model.named_parameters(), 3, 1e-4, 1e-5),
        SEED)
    host_step = make_train_step(LossConfig())
    cache_step = make_train_step(LossConfig(), augment_cfg=AugmentConfig())
    host_ds = LipSyncDataset(preprocessed_dir=corpus,
                             video_frames=cfg.video_frames,
                             audio_frames=cfg.audio_frames)
    cache = DeviceDatasetCache(LipSyncDataset(
        preprocessed_dir=corpus, video_frames=cfg.video_frames,
        audio_frames=cfg.audio_frames, uint8_visual=True), device=dev)

    def time_steps(step, next_batch, b):
        """Median of 5 warm steps, peak memory and a profiled window of 3
        steps."""
        def one():
            return float(step(state, next_batch())["loss"])

        for _ in range(2):
            one()
        sync()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        return {"step_ms_median5": ms, "step_ms_all": [t * 1e3 for t in times],
                "clips_per_s": b / ms * 1e3,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "profile_3_steps": profile_steps(
                    lambda: [one() for _ in range(3)])}

    for b in (8, 32):
        host_batch = next(iter(BatchLoader(host_ds, batch_size=b, seed=SEED,
                                           train_mode_override=True)))
        rng = np.random.RandomState(SEED)

        def from_cache():
            return next(iter(cache.batches(range(CORPUS_CLIPS), b, rng=rng,
                                           train_mode=True)))

        feeds = {
            "host_fed": (host_step,
                         lambda: train_mod.to_device(host_batch, dev)),
            "device_cache": (cache_step, from_cache),
        }
        for feed, (step, next_batch) in feeds.items():
            emit({"phase": "training_step_time", "feed": feed, "batch": b,
                  "tf32": False, **time_steps(step, next_batch, b)})
    # The same step with PyTorch's default for convolutions (TF32 on) and
    # TF32 matmuls: a reading for later work, not the deployed
    # configuration (the entry points turn TF32 off) and not checked.
    saved_tf32 = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        emit({"phase": "training_step_time", "feed": "device_cache",
              "batch": 32, "tf32": True, "deployed": False,
              **time_steps(cache_step, from_cache, 32)})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved_tf32
    del state, model, cache
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "training_seconds", "seconds": phase_s})
    return main_launches


def json_diff(a, b, path="$"):
    """(largest difference between two JSON values' floats, the paths
    where anything else differs)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return 0.0, [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        parts = [json_diff(a[k], b[k], f"{path}.{k}") for k in a]
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return 0.0, [f"{path}: lengths {len(a)} != {len(b)}"]
        parts = [json_diff(x, y, f"{path}[{i}]")
                 for i, (x, y) in enumerate(zip(a, b))]
    elif type(a) is float and type(b) is float:
        return abs(a - b), []
    else:
        return 0.0, [] if (type(a), a) == (type(b), b) else [
            f"{path}: {a!r} != {b!r}"]
    return (max((d for d, _ in parts), default=0.0),
            [m for _, ms in parts for m in ms])


class Client:
    """The HTTP calls of the serving phase, on stdlib ``urllib``."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def _send(self, req):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, route):
        import urllib.request

        return self._send(urllib.request.Request(self.base + route))

    def post_json(self, route, payload):
        import urllib.request

        return self._send(urllib.request.Request(
            self.base + route, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}))

    def post_upload(self, route, data: bytes):
        import urllib.request

        boundary = "chip-smoke-boundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="video_file"; filename="clip.mp4"\r\n'
                "Content-Type: video/mp4\r\n\r\n").encode() + data + (
            f"\r\n--{boundary}--\r\n").encode()
        return self._send(urllib.request.Request(
            self.base + route, data=body, headers={
                "Content-Type": f"multipart/form-data; boundary={boundary}"}))


def clip_set(ingest_mod, synthetic):
    """Clips S and L (the predictor phase's, from the same seed) in memory,
    with a detector that knows their boxes."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    clips = {"S": synthetic.request(rng, 30, 2.0),
             "L": synthetic.request(rng, 150, 150 / synthetic.FPS)}
    memory = InMemoryClips(ingest_mod, synthetic.FPS)
    boxes = ClipBoxes()
    paths = {}
    for name, (frames, bx, pcm) in clips.items():
        paths[name] = memory.add(name, frames, pcm)
        boxes.add(frames, bx)
    return memory, boxes, paths


def parent_int8_conv(x, weight, bias, stride, padding):
    """The int8 lowering as the port ran it before K4 and K3's epilogue
    (``models/layers.py::int8_conv`` until then): torch's elementwise chain
    around K3's int32 entry. The yardstick of the whole fused convolution."""
    import torch

    from lipsync_tpu_torch.models.layers import _INV_127
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4

    x32, w32 = x.float(), weight.float()
    w_scale = torch.clamp(
        w32.abs().amax(dim=tuple(range(1, w32.dim()))) * _INV_127,
        min=1e-12)
    x_scale = torch.clamp(x32.abs().max() * _INV_127, min=1e-12)
    w_q = k4.quantize_int8(w32, w_scale.view(-1, *[1] * (w32.dim() - 1)))
    x_q = k4.quantize_int8(x32, x_scale)
    last = lambda t: t.movedim(1, -1).contiguous()  # noqa: E731
    y = k3.int8_conv_int32(last(x_q), last(w_q), stride, padding)
    out = y.float() * (x_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.movedim(-1, 1).to(x.dtype)


# Device-kernel names of K1, K3 and K4, as the profiler reports them.
K1_KERNELS = ("log_mel_kernel",)
K3_KERNELS = ("int8_conv_wgmma_kernel", "int8_conv_halo_kernel")
K4_PAIR = ("absmax_kernel", "quant_rows_kernel", "quant_transpose_kernel")
K4_KERNELS = ("absmax_quantize_kernel", *K4_PAIR)


def device_ms(fn, kernels=None, iters: int = 10) -> float:
    """Device time per call of ``fn`` in the kernels whose names contain
    one of ``kernels`` (every kernel when None), from profiler traces of
    ``iters`` calls after one warm-up: the kernels' own time, without the
    host time between launches that an event-timed loop of small calls
    measures. The median of three traces that recorded the kernels: a
    trace now and then misses every event (two of the first three traces
    of a run have), and such a trace is taken again, up to ten traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (kernels is None or any(k in e.key for k in kernels)))
        if total > 0:
            runs.append(total)
        if len(runs) == 3:
            break
    check(bool(runs), f"ten profiler traces recorded no kernel of {kernels}")
    return statistics.median(runs) / iters / 1e3


def bits(t):
    """``t``'s bit patterns, so that equality is bit for bit."""
    import torch

    return t.view({4: torch.int32, 2: torch.int16}.get(t.element_size(),
                                                      t.dtype))


def same_float(a, b) -> bool:
    """``a`` and ``b`` bit for bit, a NaN matching any NaN."""
    import torch

    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        bits(torch.where(na, 0, a)), bits(torch.where(nb, 0, b))))


def k3_phase(dev, cfg, weights, time_ms, bound_ms, checked,
             plain_int8) -> dict:
    """K3 and K4 against their twins at every int8 encoder convolution of
    ``cfg`` (found by one int8 forward of one window) at B = 1, 8, 16 and
    128 windows (8 untimed), and at ten odd shapes with partial tiles, each
    row naming its main loop (``k3.main_loop``):

    - K3's int32 entry equal to its twin; its dequantizing entry bit-equal
      to its twin writing fp32 and bf16 (with a bias on the odd shapes);
    - K4's single launch (int8 values, scale, K3's scale vector) and its
      absmax and quantize equal to their twins, bit for bit, on the
      convolution's input as fp32 and bf16, channels-last and
      channels-first; on the odd shapes also absmax over a frame range,
      exact half-way ties, and inputs holding a NaN and a -inf;
    - the widths K3 refuses as they are (C_out 100, C_in 200 and 320 at
      layer4 of B = 16) through ``layers.int8_conv``, bit-equal to the
      same call with the twins in the kernels' places (``plain_int8``).

    At B = 16: K3 (int32 out, and dequantized to fp32 and bf16) beside its
    bound, its twin, im2col + ``torch._int_mm`` and the bf16 cuDNN
    convolution of the same shape; K4's single launch on the fp32
    channels-last input against the old absmax + quantize pair in turns
    (pair, single, single, pair), beside its bound and its twin (the torch
    chain it replaces); and the
    whole int8 convolution, ``layers.int8_conv``, against the parent's
    torch chain around K3's int32 entry (:func:`parent_int8_conv`), equal
    bit for bit and timed in turns. Each time is taken twice: ``*_ms`` per
    call from CUDA events, host launch included (the kernels line's
    yardstick, as for K1 and K2), and ``*_device_ms``, the kernels' own
    time from the profiler (:func:`device_ms`). Returns the rows by (conv
    index, B)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from lipsync_tpu_torch.models import LipSyncModel
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4

    geoms, calls, per_forward = [], [0], {}
    real = layers_mod.int8_conv_dequant

    def discover(x, w, scale, bias, out_dtype, stride, padding):
        calls[0] += 1
        key = conv_key(x, w, stride, padding)
        if key not in geoms:
            geoms.append(key)
        per_forward[key] = per_forward.get(key, 0) + 1
        return real(x, w, scale, bias, out_dtype, stride, padding)

    model = LipSyncModel(dataclasses.replace(cfg, conv_lowering="int8"))
    model.load_state_dict(weights)
    model.to(dev).eval()
    layers_mod.int8_conv_dequant = discover
    try:
        with torch.inference_mode():
            model(torch.rand(1, cfg.video_frames, cfg.crop_size,
                             cfg.crop_size, 3, device=dev),
                  torch.rand(1, cfg.mel_bins, cfg.audio_frames, 1,
                             device=dev) * -80)
    finally:
        layers_mod.int8_conv_dequant = real
    del model
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int16).to(torch.int8)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def im2col_int_mm(x, w, stride, padding):
        """The same convolution as one im2col copy and one cuBLASLt int8
        GEMM (K zero-padded to a multiple of 8)."""
        if x.dim() == 4:  # one frame of a 3-d convolution
            return im2col_int_mm(x.unsqueeze(1), w.unsqueeze(1),
                                 (1, *stride), (0, *padding))[:, 0]
        pd, ph, pw = padding
        cout, kd, kh, kw, c = w.shape
        cols = F.pad(x, (0, 0, pw, pw, ph, ph, pd, pd)).unfold(
            1, kd, stride[0]).unfold(2, kh, stride[1]).unfold(3, kw,
                                                              stride[2])
        k = kd * kh * kw * c
        kp = -(-k // 8) * 8
        a = F.pad(cols.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(-1, k),
                  (0, kp - k))
        bm = F.pad(w.reshape(cout, k), (0, kp - k))
        return torch._int_mm(a, bm.t()).view(*cols.shape[:4], cout)

    def activations(x_shape):
        """K4's input for a convolution over ``x_shape`` (channels-last):
        channels-first shape, in both memory layouts."""
        cl = randn(*x_shape, scale=3.0).movedim(-1, 1)
        return {"channels_last": cl, "channels_first": cl.contiguous()}

    def k4_check(x, frames=None, scale=None):
        """K4 vs its twins on ``x``: the single launch's int8 values,
        scale and scale vector (on a random ``w_scale``), absmax's and
        quantize's outputs, bit for bit (a NaN scale matching a NaN), and
        the largest |difference| of the int8 values."""
        m = k4.absmax(x, frames)
        m_twin = k4.absmax_plain(x, frames)
        if scale is None:
            scale = torch.clamp(m_twin * layers_mod._INV_127, min=1e-12)
        q, q_twin = k4.quantize(x, scale), k4.quantize_plain(x, scale)
        w_scale = torch.rand(x.shape[1], generator=gen, device=dev)
        fused = k4.absmax_quantize(x, w_scale)
        twin = k4.absmax_quantize_plain(x, w_scale)
        torch.cuda.synchronize()
        key = (tuple(x.shape), str(x.dtype).removeprefix("torch."),
               k4.layout_of(x))
        checked["int8_quant"].update({(*key, False), (*key, frames
                                                       is not None)})
        return {"absmax_equal": same_float(m, m_twin),
                "quantize_equal": bool(torch.equal(q, q_twin)),
                "fused_equal": bool(torch.equal(fused[0], twin[0]))
                and same_float(fused[1], twin[1])
                and same_float(fused[2], twin[2]),
                "fused_scale": float(fused[1]),
                "max_abs_err": max(
                    int((q.int() - q_twin.int()).abs().max()),
                    int((fused[0].int() - twin[0].int()).abs().max()))}

    odd = [((3, 5, 13, 11, 32), (24, 3, 3, 3, 32), (1, 2, 2), (1, 1, 1)),
           ((2, 3, 9, 10, 3), (16, 2, 5, 3, 3), (1, 2, 1), (0, 2, 1)),
           ((3, 11, 9, 1), (8, 7, 7, 1), (2, 2), (3, 3)),
           ((2, 7, 5, 96), (16, 3, 3, 96), (2, 1), (1, 1)),
           ((2, 3, 6, 6, 64), (136, 1, 1, 1, 64), (1, 2, 2), (0, 0, 0)),
           # The halo loop: partial tiles at every border (the last rows of
           # each frame, of each batch item), C_in 2, 5 and 8, a row of
           # output cut into tiles, C_out past one block of 64 channels, a
           # stride-1 stem.
           ((3, 5, 21, 23, 3), (16, 3, 7, 7, 3), (1, 2, 2), (1, 3, 3)),
           ((2, 3, 17, 150, 2), (24, 2, 5, 3, 2), (1, 1, 2), (1, 2, 1)),
           ((2, 9, 13, 8), (40, 3, 3, 8), (1, 2), (1, 1)),
           ((2, 4, 15, 17, 3), (8, 3, 7, 7, 3), (1, 1, 1), (1, 3, 3)),
           ((1, 3, 9, 300, 5), (136, 1, 3, 3, 5), (1, 1, 1), (0, 1, 1))]
    # B = 8 is phase 12's int8 evaluation batch: held against the twins,
    # not timed.
    cases = [(i, b, (b, *g[0][1:]), *g[1:]) for b in (1, 8, 16, 128)
             for i, g in enumerate(geoms)]
    cases += [(f"odd{i}", 0, *g) for i, g in enumerate(odd)]
    # Phase 14's diagnose_int8 convolves its own list of encoder
    # geometries (CONV_SHAPES, one of them not the model's) at B = 16.
    from lipsync_tpu_torch.tools.diagnose_int8 import CONV_SHAPES

    cases += [(f"diag_{n}", "diag", (16, *x), (co, *ks, ci), st,
               tuple(d // 2 for d in ks))
              for n, x, ks, ci, co, st in CONV_SHAPES]
    dtypes = (torch.float32, torch.bfloat16)
    rows = {}
    for name, b, x_shape, w_shape, stride, padding in cases:
        x, w = rand_int8(x_shape), rand_int8(w_shape)
        cout = w_shape[0]
        scale = torch.rand(cout, generator=gen, device=dev) * 1e-4 + 1e-6
        bias = randn(cout) if b == 0 else None
        got = k3.int8_conv_int32(x, w, stride, padding)
        want = k3.int8_conv_plain(x, w, stride, padding)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        checked["int8_conv"].add(k3_int32_key(x, w, stride, padding))
        fused_equal = {}
        for dt in dtypes:
            fused = k3.int8_conv_dequant(x, w, scale, bias, dt, stride,
                                         padding)
            twin = k3.int8_conv_dequant_plain(x, w, scale, bias, dt, stride,
                                              padding)
            torch.cuda.synchronize()
            fused_equal[str(dt)] = bool(torch.equal(bits(fused),
                                                    bits(twin)))
            checked["int8_conv"].add(k3_key(x, w, scale, bias, dt, stride,
                                            padding))
            del fused, twin
        quant_equal = {}
        for layout, xf in activations(x_shape).items():
            for dt in dtypes:
                quant_equal[f"{layout} {dt}"] = k4_check(xf.to(dt))
                if b == 0:
                    lo, hi = 1, xf.shape[2] - 1
                    quant_equal[f"{layout} {dt} frames"] = k4_check(
                        xf.to(dt), (lo, hi))
            del xf
        if b == 0:  # exact half-way ties at a scale of 1, and clamping
            ties = (torch.randint(-127, 127, x_shape, generator=gen,
                                  device=dev) + 0.5)
            ties[(0,) * ties.dim()] = 127.0  # the single launch's scale: 1
            ties = ties.movedim(-1, 1)
            ones = torch.ones((), device=dev)
            for dt in dtypes:
                quant_equal[f"ties {dt}"] = k4_check(ties.to(dt),
                                                     scale=ones)
                quant_equal[f"clamp {dt}"] = k4_check(
                    (ties * 3).to(dt), scale=ones)
            # A NaN makes the scale NaN (torch.clamp keeps it) and every
            # int8 value 0; a -inf makes it +inf.
            for value in ("nan", "-inf"):
                odd_x = activations(x_shape)["channels_last"]
                odd_x[(0,) * odd_x.dim()] = float(value)
                for dt in dtypes:
                    quant_equal[f"{value} {dt}"] = k4_check(odd_x.to(dt))
                del odd_x
        m, n, kk = k3.gemm_dims(x_shape, w_shape, stride, padding)
        ops = 2.0 * m * n * kk
        bms, bby = bound_ms(x.numel() + w.numel() + 4 * got.numel(), ops,
                            INT8)
        # Two timers, kept apart: ``*_ms`` per call from CUDA events (host
        # launch included), as K1 and K2 are timed in the kernels line;
        # ``*_device_ms`` the kernels' own time from the
        # profiler (:func:`device_ms`). A share or a ratio compares only
        # times of one timer.
        int32 = lambda: k3.int8_conv_int32(x, w, stride, padding)  # noqa
        timed = b not in (8, "diag")  # held, not timed
        kms = time_ms(int32, iters=10) if timed else None
        dms = device_ms(int32, K3_KERNELS) if timed else None
        row = {"conv": name, "x": list(x_shape), "w": list(w_shape),
               "stride": list(stride), "padding": list(padding),
               "main_loop": k3.main_loop(x_shape, w_shape),
               "m": m, "n": n, "k": kk, "equal": equal,
               "max_abs_err": int((got.long() - want.long()).abs().max()),
               "fused_equal": fused_equal, "k4_equal": quant_equal,
               "kernel_ms": kms, "device_ms": dms,
               "bound_ms": bms, "bound_by": bby,
               "bound_share": bms / kms if timed else None,
               "device_bound_share": bms / dms if timed else None,
               "bound_basis": INT8}
        if b == 16:
            for dt in dtypes:
                tag = str(dt).removeprefix("torch.")
                size = torch.tensor([], dtype=dt).element_size()
                fused = lambda: k3.int8_conv_dequant(  # noqa: E731
                    x, w, scale, None, dt, stride, padding)
                row[f"fused_{tag}_ms"] = time_ms(fused, iters=10)
                row[f"fused_{tag}_device_ms"] = device_ms(fused, K3_KERNELS)
                (row[f"fused_{tag}_bound_ms"],
                 row[f"fused_{tag}_bound_by"]) = bound_ms(
                    x.numel() + w.numel() + 4 * cout + size * got.numel(),
                    ops, INT8)
            plain = lambda: k3.int8_conv_plain(  # noqa: E731
                x, w, stride, padding)
            row["plain_ms"] = time_ms(plain, iters=2, warmup=1)
            row["plain_device_ms"] = device_ms(plain, iters=2)
            lib = im2col_int_mm(x, w, stride, padding)
            row["int_mm_equal"] = bool(torch.equal(lib, want))
            del lib
            int_mm = lambda: im2col_int_mm(  # noqa: E731
                x, w, stride, padding)
            row["int_mm_ms"] = time_ms(int_mm, iters=5)
            row["int_mm_device_ms"] = device_ms(int_mm, iters=5)
            conv = F.conv3d if x.dim() == 5 else F.conv2d
            xb = x.movedim(-1, 1).to(torch.bfloat16)
            wb = w.movedim(-1, 1).to(torch.bfloat16)
            cudnn = lambda: conv(  # noqa: E731
                xb, wb, stride=stride, padding=padding)
            row["bf16_cudnn_ms"] = time_ms(cudnn, iters=10)
            row["bf16_cudnn_device_ms"] = device_ms(cudnn)
            del xb, wb
            # K4 on the main path's input: fp32, channels-last, the single
            # launch against the old pair in turns (pair, single, single,
            # pair). Its bound reads x once and writes the int8 copy once.
            xf = activations(x_shape)["channels_last"]
            ws = torch.rand(cout, generator=gen, device=dev)

            def k4_pair():
                sc = torch.clamp(k4.absmax(xf) * layers_mod._INV_127,
                                 min=1e-12)
                return k4.quantize(xf, sc), sc * ws

            k4_fused = lambda: k4.absmax_quantize(xf, ws)  # noqa: E731
            k4_twin = lambda: k4.absmax_quantize_plain(xf, ws)  # noqa: E731
            for timer, timed in (
                    ("ms", lambda fn, _: time_ms(fn, iters=10)),
                    ("device_ms", lambda fn, names: device_ms(fn, names))):
                p_a = timed(k4_pair, K4_PAIR)
                f_a = timed(k4_fused, K4_KERNELS[:1])
                f_b = timed(k4_fused, K4_KERNELS[:1])
                p_b = timed(k4_pair, K4_PAIR)
                row[f"k4_turns_{timer}"] = [f_a, f_b]
                row[f"k4_pair_turns_{timer}"] = [p_a, p_b]
                row[f"k4_{timer}"] = (f_a + f_b) / 2
                row[f"k4_pair_{timer}"] = (p_a + p_b) / 2
            row["k4_plain_ms"] = time_ms(k4_twin, iters=10)
            row["k4_plain_device_ms"] = device_ms(k4_twin)
            row["k4_bound_ms"], row["k4_bound_by"] = bound_ms(
                5 * xf.numel(), 0.0)
            row["k4_device_bound_share"] = (row["k4_bound_ms"]
                                            / row["k4_device_ms"])
            row["k4_pair_device_bound_share"] = (
                row["k4_bound_ms"] / row["k4_pair_device_ms"])
            # The whole int8 convolution, fused against the parent's chain
            # (in turns: fused, parent, parent, fused), on float weights.
            wf = randn(cout, *w_shape[-1:], *w_shape[1:-1], scale=0.05)
            whole = {}
            for dt in dtypes:
                xd = xf.to(dt)
                fused = layers_mod.int8_conv(xd, wf, None, stride, padding)
                chain = parent_int8_conv(xd, wf, None, stride, padding)
                torch.cuda.synchronize()
                tag = str(dt).removeprefix("torch.")
                whole[f"equal_{tag}"] = bool(torch.equal(bits(fused),
                                                         bits(chain)))
                whole[f"strides_equal_{tag}"] = fused.stride() == \
                    chain.stride()
                del fused, chain
                f_a = time_ms(lambda: layers_mod.int8_conv(
                    xd, wf, None, stride, padding), iters=10)
                p_a = time_ms(lambda: parent_int8_conv(
                    xd, wf, None, stride, padding), iters=10)
                p_b = time_ms(lambda: parent_int8_conv(
                    xd, wf, None, stride, padding), iters=10)
                f_b = time_ms(lambda: layers_mod.int8_conv(
                    xd, wf, None, stride, padding), iters=10)
                whole[f"fused_{tag}_ms"] = [f_a, f_b]
                whole[f"parent_{tag}_ms"] = [p_a, p_b]
                # The same calls' device time, every kernel of the chain.
                whole[f"fused_{tag}_device_ms"] = device_ms(
                    lambda: layers_mod.int8_conv(xd, wf, None, stride,
                                                 padding))
                whole[f"parent_{tag}_device_ms"] = device_ms(
                    lambda: parent_int8_conv(xd, wf, None, stride, padding))
                # x and w read once, the output written once.
                whole[f"bound_{tag}_ms"] = bound_ms(
                    xd.element_size() * (xd.numel() + got.numel())
                    + 4 * wf.numel(), ops, INT8)[0]
                del xd
            row["whole"] = whole
            del xf, wf
        rows[name, b] = row
        del x, w, got, want
    # The widths K3 refuses as they are: layer4 at B = 16 with C_out 100,
    # C_in 200 and C_in 320, through layers.int8_conv, against the same
    # call with the twins in the kernels' places.
    c1_convs = {
        "cout_100": ((16, 32, 6, 6, 256), (100, 3, 3, 3, 256), (1, 2, 2),
                     (1, 1, 1)),
        "cin_200": ((16, 32, 3, 3, 200), (200, 3, 3, 3, 200), (1, 1, 1),
                    (1, 1, 1)),
        "cin_320": ((16, 32, 3, 3, 320), (320, 3, 3, 3, 320), (1, 1, 1),
                    (1, 1, 1)),
    }
    c1 = {}
    for name, (x_shape, w_shape, stride, padding) in c1_convs.items():
        xf = activations(x_shape)["channels_last"]
        wf = randn(w_shape[0], w_shape[-1], *w_shape[1:-1], scale=0.05)
        for dt in dtypes:
            bias = randn(w_shape[0]) if dt == torch.bfloat16 else None
            before = k3.launches, k4.launches
            got = layers_mod.int8_conv(xf.to(dt), wf, bias, stride, padding)
            torch.cuda.synchronize()
            launched = [k3.launches - before[0], k4.launches - before[1]]
            with plain_int8():
                want = layers_mod.int8_conv(xf.to(dt), wf, bias, stride,
                                            padding)
            torch.cuda.synchronize()
            c1[f"{name} {dt}"] = {
                "x": list(x_shape), "w": list(w_shape),
                "bias": bias is not None, "shape": list(got.shape),
                "equal": bool(torch.equal(bits(got), bits(want))),
                "launches_k3_k4": launched,
                "twin_launches_k3_k4": [k3.launches - before[0]
                                        - launched[0],
                                        k4.launches - before[1]
                                        - launched[1]]}
            del got, want
        del xf, wf
    # Unequal (lo, hi) padding pairs through layers.int8_conv: K4 on x, the
    # int8 activation padded with zeros, K3 with no padding; bit-equal to
    # the same call with the twins in the kernels' places, and to x padded
    # explicitly with zeros through K4 and K3 (a zero quantizes to 0).
    c6_convs = {
        "unequal_3d": ((16, 8, 12, 12, 64), (64, 3, 3, 3, 64), (1, 2, 2),
                       UNEQUAL_PAD),
        "unequal_stem": ((4, 8, 21, 19, 3), (16, 3, 7, 7, 3), (1, 2, 2),
                         ((1, 1), (3, 2), (2, 3))),
        "unequal_2d": ((16, 17, 33, 32), (32, 3, 3, 32), (1, 2),
                       ((2, 0), (0, 1))),
    }
    c6 = {}
    for name, (x_shape, w_shape, stride, padding) in c6_convs.items():
        xf = activations(x_shape)["channels_last"]
        wf = randn(w_shape[0], w_shape[-1], *w_shape[1:-1], scale=0.05)
        bias = randn(w_shape[0])
        flat = tuple(v for pair in reversed(padding) for v in pair)
        for dt in dtypes:
            before = k3.launches, k4.launches
            got = layers_mod.int8_conv(xf.to(dt), wf, bias, stride, padding)
            torch.cuda.synchronize()
            launched = [k3.launches - before[0], k4.launches - before[1]]
            padded = layers_mod.int8_conv(F.pad(xf.to(dt), flat), wf, bias,
                                          stride, (0,) * len(padding))
            before = k3.launches, k4.launches
            with plain_int8():
                want = layers_mod.int8_conv(xf.to(dt), wf, bias, stride,
                                            padding)
            torch.cuda.synchronize()
            c6[f"{name} {dt}"] = {
                "x": list(x_shape), "w": list(w_shape),
                "padding": [list(p) for p in padding],
                "shape": list(got.shape),
                "equal_twins": bool(torch.equal(bits(got), bits(want))),
                "equal_padded_input": bool(torch.equal(bits(got),
                                                       bits(padded))),
                "launches_k3_k4": launched,
                "twin_launches_k3_k4": [k3.launches - before[0],
                                        k4.launches - before[1]]}
            del got, want, padded
        del xf, wf
    torch.cuda.empty_cache()
    for b in (1, 8, 16, 128, 0, "diag"):
        emit({"phase": "k3_int8_conv", "batch": b or "odd",
              "rows": [r for (_, bb), r in rows.items() if bb == b]})
    emit({"phase": "k3_int8_widths", "convs": c1})
    emit({"phase": "k3_int8_unequal_padding", "convs": c6})
    # K4's device time over one int8 forward at B = 16: each geometry's
    # time times its convolutions per forward.
    k4_forward = {
        key: sum(per_forward[geoms[i]] * r[f"{key}_device_ms"]
                 for (i, bb), r in rows.items() if bb == 16)
        for key in ("k4", "k4_pair")}
    summary = {
        "k4_device_ms_per_forward": k4_forward["k4"],
        "k4_pair_device_ms_per_forward": k4_forward["k4_pair"],
        "k4_bound_ms_per_forward": sum(
            per_forward[geoms[i]] * r["k4_bound_ms"]
            for (i, bb), r in rows.items() if bb == 16)}
    emit({"phase": "k3_int8_conv_summary", "geometries": len(geoms),
          "int8_convs_per_forward": calls[0], **summary,
          "wgmma_geometries": sum(k3.main_loop(g[0], g[1]) == "wgmma"
                                  for g in geoms),
          "halo_geometries": sum(k3.main_loop(g[0], g[1]) == "halo"
                                 for g in geoms),
          "all_equal": all(r["equal"] for r in rows.values())})
    for (name, b), r in rows.items():
        check(r["equal"], f"K3 vs twin at conv {name}, B={b}: "
                          f"max |d| {r['max_abs_err']}")
        check(all(r["fused_equal"].values()),
              f"K3 dequantized vs twin at conv {name}, B={b}: "
              f"{r['fused_equal']}")
        check(all(v["absmax_equal"] and v["quantize_equal"]
                  and v["fused_equal"] for v in r["k4_equal"].values()),
              f"K4 vs twin at conv {name}, B={b}: {r['k4_equal']}")
        if "whole" in r:
            check(all(v for k, v in r["whole"].items() if "equal" in k),
                  f"fused int8 conv vs the parent's chain at {name}: "
                  f"{r['whole']}")
    for name, r in c1.items():
        check(r["equal"] and r["launches_k3_k4"][0] >= 1
              and r["launches_k3_k4"][1] == 1
              and r["twin_launches_k3_k4"] == [0, 0],
              f"int8 conv at a width K3 refuses as it is, {name}: {r}")
    for name, r in c6.items():
        check(r["equal_twins"] and r["equal_padded_input"]
              and r["launches_k3_k4"][0] >= 1
              and r["launches_k3_k4"][1] == 1
              and r["twin_launches_k3_k4"] == [0, 0],
              f"int8 conv at unequal padding, {name}: {r}")
    return rows, summary


def serving_phase(dev, cfg, weights, record) -> dict:
    """``python -m lipsync_tpu_torch.serving.app``'s server in this process
    at full width: the calibrated weights saved as a ``.pth``, ``Settings``
    pointing at it, the port's ``Predictor`` from
    ``settings.to_predictor_config()`` with ``ClipBoxes``, and
    ``Server(AppState(...), load_model=False)``, whose real start-up wraps
    the engine in ``CoalescingEngine``, runs the warmup and starts the
    embedded worker. Sequential requests over stdlib ``urllib``, the job
    flow, the metrics route, 4 concurrent clients, then latency readings.
    Returns the kernels' launches over the main run."""
    import tempfile

    import torch

    from lipsync_tpu_torch.inference.predictor import Predictor
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.serving.app import (
        MINIMAL_RESULT_KEYS,
        AppState,
        Server,
    )
    from lipsync_tpu_torch.serving.config import Settings
    from lipsync_tpu_torch.serving.schemas import LipSyncResponse
    from lipsync_tpu_torch.utils import synthetic

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    model_path = work / "calibrated.pth"
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, model_path)
    memory, boxes, paths = clip_set(ingest, synthetic)
    settings = Settings(model_path=model_path, port=0, device=str(dev),
                        sqlite_db_path=str(work / "jobs.db"),
                        worker_poll_interval_sec=0.05)
    out = {}
    with memory.installed():
        predictor = Predictor(model_path=settings.model_path,
                              config=settings.to_predictor_config(),
                              model_config=cfg, detector_backend=boxes,
                              device=settings.device)
        state = AppState(settings, predictor=predictor)
        # The main run: every count set to 0, then the start-up (warmup
        # included), the requests, the job and the concurrent clients.
        k1.launches = k2.launches = 0
        with record():
            server = Server(state, load_model=False)
            server.start_background()
            try:
                state.warmup.join()
                out = serving_requests(server, state, memory, paths,
                                       MINIMAL_RESULT_KEYS, LipSyncResponse)
                main_launches = {"log_mel": k1.launches,
                                 "hf_stem": k2.launches}
                emit({"phase": "serving", **out,
                      "main_launches": main_launches})
                serving_checks(out)
                out["readings"] = serving_readings(server, predictor,
                                                   memory, paths)
                emit({"phase": "serving_latency", **out["readings"],
                      "coalesce_max_wait_ms": settings.coalesce_max_wait_ms})
            finally:
                server.stop()
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return main_launches


def serving_requests(server, state, memory, paths, minimal_keys,
                     response_cls) -> dict:
    """The checked part of the serving phase: health, S and L against the
    direct ``predict``, the job flow, the metrics route, 4 concurrent
    clients of S."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import mel as k1

    client = Client(server.port)
    predictor = state.predictor
    out = {"healthz": client.get("/healthz")}
    seq, bodies, direct = {}, {}, {}
    for name in ("S", "L"):
        before = (k1.launches, k2.launches)
        code, body = client.post_upload("/api/lip-sync",
                                        memory.upload(name))
        torch.cuda.synchronize()
        launched = (k1.launches - before[0], k2.launches - before[1])
        direct[name] = predictor.predict(paths[name])
        want = response_cls.from_result(direct[name]).to_dict()
        diff, mismatches = json_diff(body, want) if code == 200 else (
            None, [f"status {code}: {body}"])
        bodies[name] = body
        seq[name] = {"status": code, "verdict": body.get("verdict"),
                     "confidence": body.get("confidence"),
                     "selected_track_id": body.get("selected_track_id"),
                     "max_abs_dfloat_vs_predict": diff,
                     "mismatches": mismatches[:5],
                     "launches": {"log_mel": launched[0],
                                  "hf_stem": launched[1]}}
    out["lip_sync"] = seq

    code, job = client.post_upload("/jobs", memory.upload("L"))
    t0 = time.perf_counter()
    status = None
    while time.perf_counter() - t0 < 300:
        status, res = client.get(f"/result/{job['job_id']}")
        if status != 202:
            break
        time.sleep(0.05)
    debug = client.get(f"/result/{job['job_id']}?include_debug=true")[1]
    want_min = {k: v for k, v in bodies["L"].items() if k in minimal_keys}
    d_min, m_min = json_diff(res.get("result"), want_min)
    raw = json.loads(json.dumps(direct["L"]))
    d_dbg, m_dbg = json_diff(debug.get("result"), raw)
    out["job"] = {"create_status": code, "status": res.get("status"),
                  "result_status": status,
                  "seconds": time.perf_counter() - t0,
                  "minimal_keys": sorted(res.get("result") or {}),
                  "minimal_max_abs_dfloat": d_min,
                  "minimal_mismatches": m_min[:5],
                  "debug_max_abs_dfloat": d_dbg,
                  "debug_mismatches": m_dbg[:5]}
    out["evaluate"] = client.post_json("/api/metrics/evaluate", {
        "evaluations": [{"predicted_is_fake": True, "true_is_fake": True},
                        {"predicted_is_fake": False,
                         "true_is_fake": True}]})

    # 4 clients, 8 requests of S. The linger is raised to 25 ms for this
    # check so that the clients' scoring calls land in one window.
    eng = predictor.engine
    calls, lock = [0], threading.Lock()
    score_probs = eng.score_probs

    def counted(visual, audio):
        with lock:
            calls[0] += 1
        return score_probs(visual, audio)

    eng.score_probs = counted
    saved_wait, eng.max_wait_s = eng.max_wait_s, 0.025
    dispatched0 = eng.batches_dispatched
    barrier = threading.Barrier(4)

    def client_thread(_):
        barrier.wait()
        return [client.post_upload("/api/lip-sync", memory.upload("S"))
                for _ in range(2)]

    try:
        with ThreadPoolExecutor(4) as pool:
            results = [r for rs in pool.map(client_thread, range(4))
                       for r in rs]
    finally:
        del eng.score_probs
        eng.max_wait_s = saved_wait
    out["concurrent"] = {
        "requests": len(results),
        "statuses": sorted({c for c, _ in results}),
        "same_verdict": all(b.get("verdict") == seq["S"]["verdict"]
                            for _, b in results),
        "max_abs_dconfidence": max(abs(b["confidence"]
                                       - seq["S"]["confidence"])
                                   for _, b in results),
        "score_probs_calls": calls[0],
        "batches_dispatched": eng.batches_dispatched - dispatched0,
    }
    return out


def serving_checks(out) -> None:
    check(out["healthz"] == (200, {"status": "ok", "model_loaded": True}),
          f"healthz: {out['healthz']}")
    for name, row in out["lip_sync"].items():
        check(row["status"] == 200 and not row["mismatches"]
              and row["max_abs_dfloat_vs_predict"] <= 1e-6,
              f"/api/lip-sync {name} vs predict: {row}")
        check(row["launches"]["log_mel"] >= 1
              and row["launches"]["hf_stem"] >= 1,
              f"/api/lip-sync {name} did not launch K1 and K2: {row}")
    job = out["job"]
    check(job["create_status"] == 200 and job["status"] == "COMPLETED"
          and not job["minimal_mismatches"]
          and job["minimal_max_abs_dfloat"] <= 1e-6
          and not job["debug_mismatches"]
          and job["debug_max_abs_dfloat"] <= 1e-6, f"job flow: {job}")
    code, m = out["evaluate"]
    check(code == 200 and (m["tp"], m["fn"], m["total"]) == (1, 1, 2),
          f"metrics route: {out['evaluate']}")
    c = out["concurrent"]
    check(c["statuses"] == [200] and c["same_verdict"]
          and c["max_abs_dconfidence"] <= 1e-3,
          f"concurrent requests: {c}")
    check(c["batches_dispatched"] < c["score_probs_calls"],
          f"concurrent requests did not coalesce: {c}")


def serving_readings(server, predictor, memory, paths) -> dict:
    """Latency p50 / p95 and requests/s at concurrency 1 and 4, and the
    direct ``predict`` of the same predictor (median of 5)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    client = Client(server.port)

    def run(name, n, conc):
        def one(_):
            t0 = time.perf_counter()
            code, _ = client.post_upload("/api/lip-sync",
                                         memory.upload(name))
            check(code == 200, f"reading request {name}: {code}")
            return (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(conc) as pool:
            ms = list(pool.map(one, range(n)))
        wall = time.perf_counter() - t0
        return {"requests": n, "concurrency": conc,
                "p50_ms": float(np.percentile(ms, 50)),
                "p95_ms": float(np.percentile(ms, 95)),
                "requests_per_s": n / wall}

    def direct(name, threaded=False):
        """``predict`` on this thread, or on a new thread per call as the
        server's handlers run it."""
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if threaded:
                t = threading.Thread(target=predictor.predict,
                                     args=(paths[name],))
                t.start()
                t.join()
            else:
                predictor.predict(paths[name])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"S_c1": run("S", 10, 1), "L_c1": run("L", 5, 1),
            "S_c4": run("S", 16, 4), "L_c4": run("L", 8, 4),
            "direct_predict_ms_median5": {"S": direct("S"),
                                          "L": direct("L")},
            "direct_predict_new_thread_ms_median5": {
                "S": direct("S", True), "L": direct("L", True)}}


def options_phase(dev, cfg, weight_sets, requests, serve, eng32, seeded32,
                  track_inputs, plain_int8, record) -> dict:
    """The three single-card options of ``Settings``, each served by a
    ``Predictor`` built from ``Settings(option).to_predictor_config()`` on
    the calibrated weights (bf16, the entry point a user calls) and by an
    fp32 engine from ``load_engine`` with the same option: clips S and L,
    and requests R1-R3 through the fp32 engines. ``default`` is
    ``Settings()`` on the same weights, the baseline. Returns the kernels'
    launches over the main run, K2's under the fold and K3's per int8
    forward."""
    import tempfile

    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
    from lipsync_tpu_torch.inference.predictor import Predictor
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.serving.config import Settings
    from lipsync_tpu_torch.utils import synthetic

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_options_"))
    model_path = work / "calibrated.pth"
    torch.save({k: v.detach().cpu()
                for k, v in weight_sets["bn_calibrated"].items()}, model_path)
    memory, boxes, paths = clip_set(ingest, synthetic)
    options = {"default": {}, "shared": {"shared_visual_encoding": True},
               "fold": {"fold_hf_stem": True},
               "int8": {"quantized_int8": True}}
    counters = (k1, k2, k3, k4)
    names = ("log_mel", "hf_stem", "int8_conv", "int8_quant")

    def counts():
        return tuple(k.launches for k in counters)

    def forwards_of(engine):
        """Forwards of ``engine``'s model, counted at the audio encoder,
        which every forward runs once (the shared path calls the model's
        ``encode_visual`` and ``score_encoded``, not ``forward``)."""
        n = [0]
        engine.model.audio_encoder.register_forward_pre_hook(
            lambda *_: n.__setitem__(0, n[0] + 1))
        return n

    preds, engs, n_fwd = {}, {}, {}
    for name, opt in options.items():
        settings = Settings(model_path=model_path, **opt)
        preds[name, "bf16"] = Predictor(
            model_path=settings.model_path,
            config=settings.to_predictor_config(), model_config=cfg,
            detector_backend=boxes, device=dev)
        engs[name] = load_engine(model_path, cfg, use_bfloat16=False,
                                 device=dev, **opt)
        preds[name, "fp32"] = Predictor(
            config=settings.to_predictor_config(), model_config=cfg,
            engine=engs[name], detector_backend=boxes, device=dev)
        for dtype in ("bf16", "fp32"):
            n_fwd[name, dtype] = forwards_of(preds[name, dtype].engine)
    seeded_int8, seeded_fold = (
        ScoringEngine(weight_sets["seeded"], cfg, use_bfloat16=False,
                      device=dev, **{opt: True})
        for opt in ("quantized_int8", "fold_hf_stem"))
    int8_convs = sum(isinstance(m, layers_mod.ConvBNAct)
                     and m.lowering == "int8"
                     for m in engs["int8"].model.modules())

    def launched(fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, [a - b for a, b in zip(counts(), before)]

    results, rows = {}, {}
    with memory.installed():
        # The main run: every count set to 0, each option's predictors on S
        # and L, its fp32 engine on R1-R3.
        k1.launches = k2.launches = k3.launches = k4.launches = 0
        with record():
            for (name, dtype), pred in preds.items():
                for clip in ("S", "L"):
                    f0 = n_fwd[name, dtype][0]
                    results[name, dtype, clip], n = launched(
                        lambda: pred.predict(paths[clip]))
                    rows[name, dtype, clip] = {
                        "launches": dict(zip(names, n)),
                        "forwards": n_fwd[name, dtype][0] - f0}
            logits = {}
            for name in options:
                for rname, req in requests.items():
                    f0 = n_fwd[name, "fp32"][0]
                    logits[name, rname], n = launched(
                        lambda: serve(engs[name], *req, probs=False))
                    rows[name, "fp32", rname] = {
                        "launches": dict(zip(names, n)),
                        "forwards": n_fwd[name, "fp32"][0] - f0}
        main_launches = dict(zip(names, counts()))
        # Measured in the main run: K2 under the fold, K3 and K4 per int8
        # forward.
        of = {name: [r for (n, _, _), r in rows.items() if n == name]
              for name in ("fold", "int8")}
        main_launches["hf_stem_fold"] = sum(r["launches"]["hf_stem"]
                                            for r in of["fold"])
        for k in ("int8_conv", "int8_quant"):
            main_launches[f"{k}_per_forward"] = (
                sum(r["launches"][k] for r in of["int8"])
                / sum(r["forwards"] for r in of["int8"]))

        def window_probs(r):
            return np.asarray(r["tracks"][0]["window_confidences"])

        cmp = {}
        base = results["default", "bf16", "L"]
        shared = {d: results["shared", d, "L"] for d in ("bf16", "fp32")}
        crops, audio = track_inputs(requests["R2"])
        one = engs["shared"].score_track_logits(
            crops[: cfg.video_frames], [0], audio[:1])
        cmp["shared"] = {
            "L_window_probs_finite": all(
                bool(np.isfinite(window_probs(r)).all())
                for r in shared.values()),
            "one_window_vs_per_window_fp32": float(np.abs(
                one - eng32.score_track_logits(
                    crops[: cfg.video_frames], [0], audio[:1])).max()),
            "L_bf16_abs_dconfidence_vs_default": abs(
                shared["bf16"]["confidence"] - base["confidence"]),
            "L_bf16_verdict": [shared["bf16"]["verdict"], base["verdict"]],
            "L_max_abs_dprob_vs_default_bf16": float(np.abs(
                window_probs(shared["bf16"]) - window_probs(base)).max()),
        }
        # The JAX package bounds the fold on seeded weights (|dprob| <
        # 1e-3); on the calibrated ones its border deviation is a reading.
        cmp["fold"] = {
            "fp32_max_abs_dprob_vs_unfolded_seeded": {
                r: float(np.abs(serve(seeded_fold, *req)
                                - serve(seeded32, *req)).max())
                for r, req in requests.items()},
            "fp32_max_abs_dprob_vs_unfolded_calibrated": {
                r: float(np.abs(engs["fold"].calibrator(logits["fold", r])
                                - eng32.calibrator(logits["default", r])
                                ).max()) for r in requests}}
        twin = {}
        for r, req in requests.items():
            before = k3.launches, k4.launches
            with plain_int8():
                twin[r] = serve(engs["int8"], *req, probs=False)
            torch.cuda.synchronize()
            check((k3.launches, k4.launches) == before,
                  "the int8 twin run launched K3 or K4")
        seeded = {r: float(np.abs(serve(seeded_int8, *req)
                                  - serve(seeded32, *req)).max())
                  for r, req in requests.items()}
        cmp["int8"] = {
            "convs_per_forward": int8_convs,
            "fp32_max_abs_dlogit_kernel_vs_twin": {
                r: float(np.abs(logits["int8", r] - twin[r]).max())
                for r in requests},
            "fp32_max_abs_dprob_vs_default_calibrated": {
                r: float(np.abs(engs["int8"].calibrator(logits["int8", r])
                                - eng32.calibrator(logits["default", r])
                                ).max()) for r in requests},
            "fp32_max_abs_dprob_vs_default_seeded": seeded,
        }
        emit({"phase": "options", "runs": {
            "_".join(k): {**v, **({"verdict": results[k]["verdict"],
                                   "confidence": results[k]["confidence"]}
                                  if k in results else {})}
            for k, v in rows.items()}, "compare": cmp,
            "main_launches": main_launches})

        # Every number is printed before any of them is checked.
        for (name, dtype, run), row in rows.items():
            n1, n2, n3, n4 = row["launches"].values()
            f = row["forwards"]
            check(f >= 1 and n1 >= 1, f"{name} {dtype} {run}: {row}")
            check((n2 == 0) == (name == "fold"),
                  f"K2 launches under {name} {dtype} {run}: {row}")
            check(n3 == (int8_convs * f if name == "int8" else 0),
                  f"K3 launches under {name} {dtype} {run}: {row}")
            check(n4 == (int8_convs * f if name == "int8" else 0),
                  f"K4 launches under {name} {dtype} {run}: {row}")
        c = cmp["shared"]
        check(c["L_window_probs_finite"], f"shared L: {c}")
        check(c["one_window_vs_per_window_fp32"] <= 1e-5,
              f"shared one-window track vs per-window: {c}")
        for r, d in cmp["fold"][
                "fp32_max_abs_dprob_vs_unfolded_seeded"].items():
            check(d <= 1e-3, f"fold {r}: |dprob| {d} vs unfolded")
        for r, d in cmp["int8"]["fp32_max_abs_dlogit_kernel_vs_twin"].items():
            check(d <= 1e-4, f"int8 {r}: kernel vs twin |dlogit| {d}")
        for r, d in seeded.items():
            check(d <= 5e-3, f"int8 {r}: seeded |dprob| {d} vs fp32")

        # Latency of every option's bf16 predictor on S and L and of its
        # engine on R3, median of 5.
        lat = {}
        for name in options:
            pred = preds[name, "bf16"]
            for clip in ("S", "L"):
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pred.predict(paths[clip])
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                lat[f"{name}_{clip}"] = statistics.median(times)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(pred.engine, *requests["R3"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            lat[f"{name}_R3"] = statistics.median(times)
        emit({"phase": "options_latency", "dtype": "bf16",
              "latency_ms_median5": lat})
    del preds, engs, seeded_int8, seeded_fold
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return main_launches


def data_parallel_phase(dev, cfg, weights, requests, track_inputs,
                        record) -> dict:
    """Phase 10, data parallelism (``parallel/mesh.py``) on one card, at
    full width on ``weights``:

    (a) the sharded engine over ``[dev, dev]`` (two shards on one card) in
        fp32 against the one-device engine: the default lowering on R2, R3
        and a ragged bucket (|dprob| <= 2e-5), shared encoding on R2 and R3
        (|dlogit| <= 1e-4), int8 on one window and on a bucket of 32
        (logits <= 1e-5; the stem's activation scale on both shards equal
        to the one device's, the whole bucket's);
    (b) ``Predictor`` over that mesh in bf16 on clips S and L against the
        one-device predictor (verdict and track equal, confidence <= 1e-6),
        and ``PredictorConfig(data_parallel_devices=2)``, which takes the
        first two cards, fewer if fewer exist;
    (c) the trainer as a world of one on NCCL (:func:`world_of_one`, in a
        child process that ``torch.distributed.run`` starts);

    and a reading of TF32's effect on S, L and R3, which the entry points
    now turn off.

    Returns the kernels' launches over the sharded runs of (a) and (b), in
    all and by device; their kernel inputs are recorded with ``record``."""
    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.parallel import mesh as mesh_lib
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.utils import synthetic
    from lipsync_tpu_torch.utils.device import disable_tf32

    t_phase = time.perf_counter()
    mesh = [dev, dev]
    tracks = {name: track_inputs(requests[name]) for name in ("R2", "R3")}

    def starts_of(crops):
        return list(range(0, len(crops) - cfg.video_frames + 1, STRIDE))

    crops3, aw3 = tracks["R3"]
    windows = np.stack([crops3[s:s + cfg.video_frames]
                        for s in starts_of(crops3)[:32]])

    def pair(**kw):
        return (ScoringEngine(weights, cfg, use_bfloat16=False, **kw),
                ScoringEngine(weights, cfg, use_bfloat16=False, mesh=mesh,
                              **kw))

    def sigmoid(x):
        return 1 / (1 + np.exp(-np.asarray(x, np.float64)))

    kernels = {"log_mel": k1, "hf_stem": k2, "int8_conv": k3,
               "int8_quant": k4}
    launches = {name: 0 for name in kernels}
    by_device = {name: {} for name in kernels}

    @contextlib.contextmanager
    def main_run():
        """A call on the sharded path: its kernel inputs are recorded and
        its launches counted (the one-device references' are not)."""
        before = {n: (m.launches, dict(m.launches_by_device))
                  for n, m in kernels.items()}
        with record():
            yield
        torch.cuda.synchronize()
        for n, m in kernels.items():
            launches[n] += m.launches - before[n][0]
            for d, c in m.launches_by_device.items():
                by_device[n][d] = (by_device[n].get(d, 0) + c
                                   - before[n][1].get(d, 0))

    out = {"default_dprob": {}, "shared_dlogit": {}, "int8_dlogit": {},
           "shard_launches": {}}
    # (a) the default lowering
    single, sharded = pair()
    for name, (crops, aw) in tracks.items():
        st = starts_of(crops)
        want = single.score_track_logits(crops, st, aw)
        before = k2.launches
        with main_run():
            got = sharded.score_track_logits(crops, st, aw)
        out["shard_launches"][f"hf_stem_{name}"] = k2.launches - before
        out["default_dprob"][name] = float(
            np.abs(sigmoid(got) - sigmoid(want)).max())
    with main_run():
        got = sharded.score_logits(windows[:5], aw3[:5])
    out["default_dprob"]["ragged_5"] = float(np.abs(
        sigmoid(got)
        - sigmoid(single.score_logits(windows[:5], aw3[:5]))).max())
    del single, sharded
    # shared encoding: frame shards with a halo
    single, sharded = pair(shared_visual_encoding=True)
    for name, (crops, aw) in tracks.items():
        st = starts_of(crops)
        with main_run():
            got = sharded.score_track_logits(crops, st, aw)
        out["shared_dlogit"][name] = float(np.abs(
            got - single.score_track_logits(crops, st, aw)).max())
    del single, sharded
    # int8: the shards reduce each activation scale in lockstep
    single, sharded = pair(quantized_int8=True)
    scales = []
    real_max, real_fused = mesh_lib.all_max, layers_mod.absmax_quantize

    def spy(value):  # a shard: the scale of the max over both shards
        result = real_max(value)
        scales.append(float(torch.clamp(result * k4.INV_127, min=1e-12)))
        return result

    def spy_fused(x, w_scale=None):  # one device: K4's single launch
        result = real_fused(x, w_scale)
        scales.append(float(result[1]))
        return result

    mesh_lib.all_max = spy
    layers_mod.absmax_quantize = spy_fused
    try:
        for n in (1, 32):
            want = single.score_logits(windows[:n], aw3[:n])
            one_device = scales[:1]
            scales.clear()
            before = k3.launches, k4.launches
            with main_run():
                got = sharded.score_logits(windows[:n], aw3[:n])
            out["shard_launches"][f"int8_conv_{n}"] = k3.launches - before[0]
            out["shard_launches"][f"int8_quant_{n}"] = (k4.launches
                                                        - before[1])
            out["int8_dlogit"][n] = float(np.abs(got - want).max())
            out.setdefault("int8_stem_scale", {})[n] = {
                "shards": scales[:2], "one_device": one_device}
            scales.clear()
    finally:
        mesh_lib.all_max, layers_mod.absmax_quantize = real_max, real_fused
    del single, sharded

    # (b) the predictor over the mesh, bf16
    memory, boxes, paths = clip_set(ingest, synthetic)
    configs = {"S": PredictorConfig(refine_margin=1.5),
               "L": PredictorConfig()}
    eng_single = ScoringEngine(weights, cfg)
    eng_mesh = ScoringEngine(weights, cfg, mesh=mesh)
    predicted = {}
    with memory.installed():
        for name, pcfg in configs.items():
            rows = []
            for eng in (eng_single, eng_mesh):
                pred = Predictor(config=pcfg, model_config=cfg,
                                 engine=eng, detector_backend=boxes)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (main_run() if eng is eng_mesh
                      else contextlib.nullcontext()):
                    r = pred.predict(paths[name])
                torch.cuda.synchronize()
                rows.append((r, (time.perf_counter() - t0) * 1e3))
            (a, ms_a), (b, ms_b) = rows
            def spans(r):
                return [(t["track_id"], [list(w) for w in t["window_spans"]])
                        for t in r["tracks"] or []]

            predicted[name] = {
                "verdict": [a["verdict"], b["verdict"]],
                "tracks_equal": spans(a) == spans(b),
                "dconfidence": abs(a["confidence"] - b["confidence"]),
                "ms_one_device": ms_a, "ms_two_shards": ms_b}
    launches["by_device"] = by_device
    # TF32's effect on the served path, a reading: S and L through the bf16
    # predictor and R3 through the bf16 engine, median of 3, with TF32 as
    # the entry points set it (off) and as PyTorch leaves it (cuDNN on),
    # in turns off, on, on, off; and R3's |dprob| between the two.
    crops_r3, aw_r3 = tracks["R3"]
    st_r3 = starts_of(crops_r3)
    with memory.installed():
        preds = {name: Predictor(config=pcfg, model_config=cfg,
                                 engine=eng_single, detector_backend=boxes)
                 for name, pcfg in configs.items()}
        runs = {"S": lambda: preds["S"].predict(paths["S"]),
                "L": lambda: preds["L"].predict(paths["L"]),
                "R3": lambda: eng_single.score_track_probs(crops_r3, st_r3,
                                                          aw_r3)}
        tf32_ms = {"off": {k: [] for k in runs}, "on": {k: [] for k in runs}}
        r3_probs = {}
        for mode in ("off", "on", "on", "off"):
            if mode == "on":
                tf32_on()
            else:
                disable_tf32()
            for name, fn in runs.items():
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                tf32_ms[mode][name].append(statistics.median(times))
                if name == "R3":
                    r3_probs[mode] = np.asarray(res)
        disable_tf32()
    out["tf32_reading"] = {
        "ms_median3_in_turns": tf32_ms,
        "r3_dprob_on_vs_off": float(np.abs(r3_probs["on"]
                                           - r3_probs["off"]).max())}
    del eng_single, eng_mesh, preds
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(weights, Path(tmp) / "w.pth")
        pred = Predictor(model_path=Path(tmp) / "w.pth",
                         config=PredictorConfig(data_parallel_devices=2),
                         model_config=cfg, device=dev)
        out["data_parallel_devices_2_mesh"] = [str(d)
                                               for d in pred.engine.mesh]
        check(pred.engine.mesh == mesh_lib.make_mesh(2),
              f"data_parallel_devices=2 built {pred.engine.mesh}")
        del pred

    # (c) the trainer as a world of one on NCCL, in a child process
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=1", str(ROOT / "chip_smoke.py"),
             "--world-of-one", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        check(proc.returncode == 0,
              f"world of one exited {proc.returncode}")
        world = json.loads((Path(tmp) / "world_of_one.json").read_text())
    out["world_of_one"] = world
    out["world_of_one_seconds"] = child_s
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "data_parallel", **out, "predictor": predicted,
          "launches": launches})

    # Every number is printed above before any is checked.
    for name, v in out["default_dprob"].items():
        check(v <= 2e-5, f"sharded vs one device {name}: |dprob| {v}")
    for name, v in out["shared_dlogit"].items():
        check(v <= 1e-4, f"shared encoding sharded {name}: |dlogit| {v}")
    # The int8 encoders are exact integer convolutions on scales equal to
    # the one device's; the fp32 token stages after them round with half
    # the batch as in the other lowerings (2.4e-6 shared, PR 6's first
    # run), hence 1e-5.
    for n, v in out["int8_dlogit"].items():
        check(v <= 1e-5, f"int8 sharded, {n} windows: |dlogit| {v}")
    for n, sc in out["int8_stem_scale"].items():
        check(sc["shards"] == sc["one_device"] * 2,
              f"int8 stem scale differs from one device's ({n}): {sc}")
    sl = out["shard_launches"]
    check(sl["hf_stem_R2"] == 2 and sl["hf_stem_R3"] == 2,
          f"K2 not launched once per shard: {sl}")
    check(sl["int8_conv_1"] == sl["int8_conv_32"] == 2 * 24,
          f"K3 not launched 24 times per shard: {sl}")
    check(sl["int8_quant_1"] == sl["int8_quant_32"] == 2 * 48,
          f"K4 not launched 48 times per shard: {sl}")
    for name, r in predicted.items():
        check(r["verdict"][0] == r["verdict"][1] and r["tracks_equal"]
              and r["dconfidence"] <= 1e-6,
              f"predictor over two shards, {name}: {r}")
    check(world["backend"] == "nccl" and world["world"] == 1,
          f"world of one: {world['backend']} x {world['world']}")
    for feed, par in world["parity"].items():
        for k, v in par["metric_rel"].items():
            check(v <= 1e-5, f"group step {feed} {k}: {v}")
        check(par["stat_rel_max"] <= 1e-5,
              f"group step {feed} statistics: {par['stat_rel_max']}")
        check(par["grad_rel_max"] <= PARITY_GRAD_TOL,
              f"group step {feed} gradients: {par['grad_rel_worst5']}")
    for entry, flags in world["tf32_after"].items():
        check(flags == {"cudnn": False, "matmul": False},
              f"{entry} in the group left TF32 on: {flags}")
    check(all(np.isfinite(v) for h in world["histories"].values()
              for v in h.values()), f"group runs: {world['histories']}")
    check(tf32_flags() == {"cudnn": False, "matmul": False},
          f"phase 10 left TF32 on: {tf32_flags()}")
    return launches


# Phase 11: the lip localizer trainer's reduced run (the JAX script's is
# 40,000 faces and 4,000 steps; 4,096 and 512 faces until phase 14 needed
# the host's rendering time) and the corpus it writes per format.
LL_TRAIN, LL_VAL, LL_STEPS, LL_BATCH = 1024, 256, 300, 256
COMPLETION_CLIPS = 8


def completion_phase(dev, cfg, eng32, smi, record) -> dict:
    """The modules that complete the port, on the card: the lip localizer's
    trainer (card vs CPU step, 300 steps, the written ``npz`` in the numpy
    ``LipLocalizer``), ``write_corpus`` in the three store formats (read
    back identical, one train step each), ``cuda_trace`` and ``SpanTimer``
    around one fp32 ``predict`` of clip S, and the legacy fusion and
    pooling at ``ModelConfig()`` width against the CPU. Returns the
    kernels' launches over its main runs (the corpus writes and the traced
    ``predict``)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from lipsync_tpu_torch.inference import predictor as predictor_mod
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.models import LipSyncModel, seeded_state_dict
    from lipsync_tpu_torch.models.fusion import LegacyFusionModule
    from lipsync_tpu_torch.models.temporal import temporal_aggregation
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing import lip_localizer as ll
    from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
    from lipsync_tpu_torch.tools import train_lip_localizer as ll_tool
    from lipsync_tpu_torch.training import steps
    from lipsync_tpu_torch.training.data import LipSyncDataset, safe_collate
    from lipsync_tpu_torch.utils import synthetic
    from lipsync_tpu_torch.utils.profiling import SpanTimer, cuda_trace

    def sync():
        torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_completion_"))
    cpu = torch.device("cpu")

    # ── the lip localizer's trainer ───────────────────────────────────────
    t0 = time.perf_counter()
    px, ty = ll_tool.build_dataset(LL_TRAIN, SEED)
    vx, vy = ll_tool.build_dataset(LL_VAL, SEED + 10_000)
    render_s = time.perf_counter() - t0
    check(tf32_flags() == {"cudnn": False, "matmul": False},
          f"TF32 on before the localizer step: {tf32_flags()}")
    init = ll.init_params(np.random.RandomState(1))
    step_of = []
    for device in (dev, cpu):
        net = ll.LipLocalizerNet.from_params(init).to(device)
        opt = ll_tool.make_optimizer(net, 3e-3)
        loss = ll_tool.train_step(
            net, opt, torch.from_numpy(px[:LL_BATCH]).to(device),
            torch.from_numpy(ty[:LL_BATCH]).to(device))
        step_of.append((float(loss), {
            n: p.grad.detach().cpu() for n, p in net.named_parameters()}))
    (loss_card, g_card), (loss_cpu, g_cpu) = step_of
    ll_parity = {
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
        "grad_rel": {n: float((g_card[n] - g).abs().max() / g.abs().max())
                     for n, g in g_cpu.items()}}

    t0 = time.perf_counter()
    net, history, iou = ll_tool.train(
        px, ty, vx, vy, steps=LL_STEPS, batch_size=LL_BATCH, lr=3e-3,
        seed=SEED, device=dev, log=lambda line: None)
    sync()
    train_s = time.perf_counter() - t0
    # Step time on a fresh net: 5 warm steps, then 20 synchronised ones.
    timed = ll.LipLocalizerNet.from_params(init).to(dev)
    opt = ll_tool.make_optimizer(timed, 3e-3)
    px_d, ty_d = torch.from_numpy(px).to(dev), torch.from_numpy(ty).to(dev)
    draws = np.random.RandomState(SEED + 7)
    times = []
    for i in range(25):
        idx = torch.from_numpy(draws.randint(0, LL_TRAIN, LL_BATCH)).to(dev)
        sync()
        t1 = time.perf_counter()
        ll_tool.train_step(timed, opt, px_d[idx], ty_d[idx])
        sync()
        if i >= 5:
            times.append(time.perf_counter() - t1)
    npz = ll_tool.save(net, work / "lip_localizer.npz",
                       {"steps": LL_STEPS, "n_train": LL_TRAIN})
    loaded = ll.LipLocalizer.load(npz)
    with torch.no_grad():
        card_pred = net(torch.from_numpy(vx).to(dev)).cpu().numpy()
    host_pred = ll.forward(loaded.params, vx)
    emit({"phase": "completion_lip_localizer", "nvidia_smi": smi,
          "faces": [LL_TRAIN, LL_VAL], "render_s": render_s,
          "step_parity": ll_parity, "steps": LL_STEPS, "batch": LL_BATCH,
          "history": history, "train_s": train_s,
          "step_ms_median20": statistics.median(times) * 1e3,
          "val_iou_mean": float(iou.mean()),
          "val_iou_p10": float(np.percentile(iou, 10)),
          "npz_forward_vs_card_max_abs": float(
              np.abs(host_pred - card_pred).max()),
          "tf32_after_train": tf32_flags()})
    check(ll_parity["loss_rel"] <= 1e-5,
          f"localizer step loss: card vs CPU {ll_parity['loss_rel']}")
    check(max(ll_parity["grad_rel"].values()) <= PARITY_GRAD_TOL,
          f"localizer gradients: card vs CPU {ll_parity['grad_rel']}")
    check(history[-1]["loss"] < history[0]["loss"],
          f"localizer loss did not fall: {history}")
    check(float(np.abs(host_pred - card_pred).max()) <= 1e-5,
          "the written npz's numpy forward differs from the card's")
    check(tf32_flags() == {"cudnn": False, "matmul": False},
          f"the localizer trainer left TF32 on: {tf32_flags()}")

    # ── main runs: the corpus in three formats, a traced predict ─────────
    k1.launches = k2.launches = k3.launches = k4.launches = 0
    corpora, writes = {}, {}
    with record():
        for fmt in synthetic.STORAGE_FORMATS:
            before = k1.launches
            t0 = time.perf_counter()
            corpora[fmt] = synthetic.write_corpus(
                work / fmt, n_clips=COMPLETION_CLIPS, n_frames=CORPUS_FRAMES,
                crop_size=cfg.crop_size, seed=SEED, device=dev,
                storage_format=fmt)
            sync()
            writes[fmt] = {"seconds": time.perf_counter() - t0,
                           "log_mel_launches": k1.launches - before}

        rng = np.random.default_rng(SEED)
        frames, boxes, pcm = synthetic.request(rng, 30, 2.0)
        memory = InMemoryClips(ingest, synthetic.FPS)
        path = memory.add("S", frames, pcm)
        pred = Predictor(config=PredictorConfig(refine_margin=1.5),
                         model_config=cfg, engine=eng32, device=dev,
                         detector_backend=FakeDetector(lambda i: [boxes[i]]))
        spans = SpanTimer()
        stages = (("pre", pred, "_audio_or_silence"),
                  ("pre", predictor_mod, "preprocess_video_tracks"),
                  ("inference", pred, "_score_windows"),
                  ("post", pred, "_apply_mouth_motion_check"))
        trace_dir = work / "trace"
        before = (k1.launches, k2.launches)
        with memory.installed(), spans_around(spans, stages):
            sync()
            t0 = time.perf_counter()
            with cuda_trace(str(trace_dir)):
                result = pred.predict(path)
            traced_s = time.perf_counter() - t0
        traced = (k1.launches - before[0], k2.launches - before[1])
    launches = {"log_mel": k1.launches, "hf_stem": k2.launches,
                "int8_conv": k3.launches, "int8_quant": k4.launches}

    samples = {}
    for fmt, out in corpora.items():
        ds = LipSyncDataset(preprocessed_dir=out, video_frames=cfg.video_frames,
                            audio_frames=cfg.audio_frames, uint8_visual=True)
        samples[fmt] = (ds.storage_format,
                        [ds.get_item(i, train_mode_override=False)
                         for i in range(COMPLETION_CLIPS)])
    identical = {
        fmt: all(g.dtype == w.dtype and np.array_equal(g, w)
                 for got, want in zip(items, samples["npy"][1])
                 for g, w in zip(got, want))
        for fmt, (_, items) in samples.items()}

    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    weights = seeded_state_dict(LipSyncModel(cfg0), SEED)
    losses = {}
    for fmt, (_, items) in samples.items():
        batch = safe_collate(items[:4])
        model = LipSyncModel(cfg0)
        model.load_state_dict(weights)
        model.to(dev)
        state = steps.create_train_state(model, SGD1(model), SEED)
        metrics = steps.make_train_step(steps.LossConfig())(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            shift=5)
        losses[fmt] = float(metrics["loss"])
        del model, state
    loss_rel = {fmt: abs(v - losses["npy"]) / abs(losses["npy"])
                for fmt, v in losses.items()}
    emit({"phase": "completion_corpus", "nvidia_smi": smi,
          "clips": COMPLETION_CLIPS, "frames": CORPUS_FRAMES,
          "writes": writes,
          "storage_format_read": {f: s[0] for f, s in samples.items()},
          "samples_identical_to_npy": identical, "train_step_loss": losses,
          "loss_rel_to_npy": loss_rel})
    for fmt, w in writes.items():
        check(w["log_mel_launches"] == COMPLETION_CLIPS,
              f"write_corpus {fmt}: {w['log_mel_launches']} K1 launches for "
              f"{COMPLETION_CLIPS} clips")
        check(samples[fmt][0] == fmt, f"{fmt} corpus read as {samples[fmt][0]}")
        check(identical[fmt], f"{fmt} corpus samples differ from npy's")
        check(loss_rel[fmt] <= 1e-6, f"{fmt} train-step loss: {loss_rel}")

    traces = sorted(trace_dir.glob("*.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    emit({"phase": "completion_trace", "nvidia_smi": smi,
          "trace_files": [p.name for p in traces],
          "trace_mb": len(text) / 1e6,
          "names_log_mel_kernel": "log_mel_kernel" in text,
          "names_hf_stem_kernel": "hf_stem_kernel" in text,
          "spans_ms": spans.spans, "traced_predict_s": traced_s,
          "launches": {"log_mel": traced[0], "hf_stem": traced[1]},
          "verdict": result["verdict"], "confidence": result["confidence"]})
    check(len(traces) == 1, f"cuda_trace wrote {traces}")
    check("log_mel_kernel" in text and "hf_stem_kernel" in text,
          "the trace does not name K1's and K2's kernels")
    check(set(spans.spans) == {"pre", "inference", "post"},
          f"SpanTimer spans: {spans.spans}")
    check(traced[0] >= 1 and traced[1] >= 1,
          f"the traced predict launched K1 {traced[0]}, K2 {traced[1]}")

    # ── legacy fusion and pooling at ModelConfig() width ─────────────────
    rng = np.random.default_rng(SEED)
    b, t_v, t_a, d = 16, cfg.video_frames, 41, cfg.embed_dim
    v = rng.normal(size=(b, t_v, d)).astype(np.float32)
    a = rng.normal(size=(b, t_a, d)).astype(np.float32)
    lengths = rng.integers(0, t_v + 1, b)
    lengths[0] = 0
    fusion = LegacyFusionModule(d, d)
    fusion.load_state_dict(seeded_state_dict(fusion, SEED))
    legacy = []
    for device in (dev, cpu):
        fusion.to(device)
        with torch.no_grad():
            fused = fusion(torch.from_numpy(v).to(device),
                           torch.from_numpy(a).to(device))
            legacy.append([
                x.cpu().numpy() for x in (
                    fused, temporal_aggregation(fused),
                    temporal_aggregation(
                        fused, torch.from_numpy(lengths).to(device)))])
    legacy_err = [float(np.abs(c - h).max()) for c, h in zip(*legacy)]
    emit({"phase": "completion_legacy", "shape_visual": [b, t_v, d],
          "shape_audio": [b, t_a, d],
          "max_abs_card_vs_cpu": dict(zip(
              ("fusion", "aggregation", "aggregation_lengths"), legacy_err)),
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check(max(legacy_err) <= 1e-5, f"legacy modules card vs CPU {legacy_err}")
    shutil.rmtree(work, ignore_errors=True)
    return launches


@contextlib.contextmanager
def spans_around(timer, stages):
    """While open, each ``(span, owner, attribute)`` of ``stages`` runs
    inside ``timer.span(span)``."""
    saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in stages]
    for name, owner, attr in stages:
        def timed(*args, _fn=getattr(owner, attr), _name=name, **kwargs):
            with timer.span(_name):
                return _fn(*args, **kwargs)
        setattr(owner, attr, timed)
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


# Phase 12: the operational tools (``lipsync_tpu_torch/tools``) as
# run_synthetic_eval chains them: three disjoint splits of the synthetic
# generator's clips (envelope style, jitter, hard negatives, 3 s at 15 fps,
# seeds 1 / 7 / 13; its defaults of 300 / 60 / 100 per class cut to these),
# a trainer cut to 2 epochs of at most 4 steps at batch 8.
TOOLS_SPLITS = (("train", 8, 1), ("calib", 4, 7), ("test", 4, 13))
TOOLS_SECONDS = 3.0
TOOLS_EPOCHS, TOOLS_STEPS, TOOLS_BATCH = 2, 4, 8
# run_training's validation split (0.2) of the 16 training clips: the batch
# that its validation forward gives K2.
TOOLS_VAL_CLIPS = max(1, int(2 * TOOLS_SPLITS[0][1] * 0.2))
# The four test clips of video mode, two per class.
TOOLS_VIDEO = ("0_real/real_0000.avi", "0_real/real_0001.avi",
               "1_fake/fake_0000.avi", "1_fake/fake_0001.avi")


def tools_phase(dev, cfg, smi, record) -> dict:
    """The operational tools at ``ModelConfig()`` width, each through the
    entry point a user calls, on clips that
    ``tools/make_synthetic_dataset.py`` renders in memory (``INGEST`` says
    why) and serves at the paths of placeholder files, which
    ``discover_video_samples`` finds: ``precompute_training_tensors`` (zarr
    ``full_sequence`` on every split with the centre box; on the test split
    also npy through a ``FakeDetector`` holding that box, lmdb, and
    ``fixed_clip``), ``validate_preprocessed``, ``run_training``,
    ``fit_calibrator`` (temperature, Platt, isotonic), and
    ``validate_pipeline`` on the test split in preprocessed mode with the
    bf16 and int8 engines of its command line and an fp32 engine,
    Platt-calibrated, then in video mode on four test clips through
    ``Predictor.predict``. Checks: no failed clip, no error row; K1 once per
    clip precomputed and per ``predict``; K2 once per eval-mode forward; K3
    and K4 24 times per int8 forward; the stored tensors against the same
    tool run with ``--device cpu``; the calibrators against a CPU refit of
    the same logits; each ``metrics.json`` against its recomputation from
    ``predictions.csv``. Returns the kernels' launches over its main
    runs."""
    import csv
    import pickle

    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.calibration import Calibrator
    from lipsync_tpu_torch.inference.engine import load_engine
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing import video as video_mod
    from lipsync_tpu_torch.preprocessing.face_detection import (
        FakeDetector,
        center_crop_box,
    )
    from lipsync_tpu_torch.tools import fit_calibrator
    from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
    from lipsync_tpu_torch.tools import precompute_training_tensors as pre
    from lipsync_tpu_torch.tools import validate_pipeline
    from lipsync_tpu_torch.tools import validate_preprocessed
    from lipsync_tpu_torch.training import train as train_mod
    from lipsync_tpu_torch.training.data import LipSyncDataset

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    fps, sr = 15.0, 16000
    on_card = ["--device", str(dev)]
    memory = InMemoryClips(ingest, fps)

    # ── the splits, rendered in memory ────────────────────────────────────
    t0 = time.perf_counter()
    raw = {split: work / f"raw_{split}" for split, _, _ in TOOLS_SPLITS}
    for split, n, seed in TOOLS_SPLITS:
        for rel, frames, pcm in gen.envelope_clips(
                n, TOOLS_SECONDS, fps, sr, seed, jitter=True,
                hard_negatives=True):
            path = raw[split] / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.touch()
            memory.add(f"{split}_{path.stem}", frames, pcm, path=str(path))
    raw["video"] = work / "raw_video"
    for rel in TOOLS_VIDEO:
        path = raw["video"] / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
        memory.add(f"video_{path.stem}",
                   *memory.clips[str(raw["test"] / rel)], path=str(path))
    render_s = time.perf_counter() - t0
    box = center_crop_box(*frames.shape[1:3], 96)

    def detector():
        return FakeDetector(lambda i: [box])

    # name -> (split, directory, flags beyond the directories and device)
    stores = {f"{split}_zarr": (split, work / f"pre_{split}_zarr", [
        "--storage-format", "zarr", "--no-face-detection"])
        for split, _, _ in TOOLS_SPLITS}
    stores["test_npy_detector"] = ("test", work / "pre_test_npy",
                                   ["--storage-format", "npy"])
    stores["test_lmdb"] = ("test", work / "pre_test_lmdb", [
        "--storage-format", "lmdb", "--no-face-detection"])
    stores["test_fixed_clip"] = ("test", work / "pre_test_fixed", [
        "--storage-format", "npy", "--mode", "fixed_clip"])
    per_class = {split: n for split, n, _ in TOOLS_SPLITS}

    def n_of(name):
        return 2 * per_class[stores[name][0]]

    def precompute(name, out, device):
        split, _, flags = stores[name]
        backend = None if "--no-face-detection" in flags else detector()
        return pre.main(["--data-dir", str(raw[split]), "--output-dir",
                         str(out), *flags, "--device", str(device)],
                        backend=backend)

    def platt_flags():
        return ["--calibration-method", "platt",
                "--calibration-platt-a", repr(platt[0]),
                "--calibration-platt-b", repr(platt[1])]

    def eval_argv(out, *flags):
        return ["--preprocessed-dir", str(stores["test_zarr"][1]),
                "--model-path", str(best), "--output-dir", str(work / out),
                *platt_flags(), *flags, *on_card]

    clock = StageClock()
    clock.wrap(memory, "read_video", "ingest_stand_in")
    clock.wrap(memory, "read_audio", "ingest_stand_in")
    clock.wrap(pre, "crop_track_on_device", "crop")
    clock.wrap(video_mod, "crop_track_on_device", "crop")
    clock.wrap(pre, "preprocess_audio_pcm", "log_mel")
    clock.wrap(pre, "_store_sample", "store_write")
    forwards = {"eval": 0, "int8": 0}
    real_forward = LipSyncModel.forward

    def counted_forward(model, *args, **kwargs):
        if not model.training:
            forwards["eval"] += 1
            forwards["int8"] += model.config.conv_lowering == "int8"
        return real_forward(model, *args, **kwargs)

    counters = (k1, k2, k3, k4)
    per_stage, seconds = {}, {}

    def stage(name, fn):
        """``fn()`` as one stage: its launches (K1, K2, K3, K4, eval-mode
        forwards, int8 forwards) and its synchronised wall time."""
        before = [c.launches for c in counters] + list(forwards.values())
        sync()
        t1 = time.perf_counter()
        out = fn()
        sync()
        seconds[name] = time.perf_counter() - t1
        after = [c.launches for c in counters] + list(forwards.values())
        per_stage[name] = [a - b for a, b in zip(after, before)]
        return out

    # ── main runs ─────────────────────────────────────────────────────────
    counts = {}
    LipSyncModel.forward = counted_forward
    try:
        with record(), memory.installed():
            k1.launches = k2.launches = k3.launches = k4.launches = 0
            for name, (_, out, _) in stores.items():
                counts[name] = stage(f"precompute_{name}",
                                     lambda: precompute(name, out, dev))
            precompute_ms = dict(clock.ms)
            clock.restore()
            invalid = {name: validate_preprocessed.main(
                           ["--preprocessed-dir", str(out)])
                       for name, (_, out, _) in stores.items()}
            train_args = train_mod.build_argparser().parse_args([
                "--preprocessed-dir", str(stores["train_zarr"][1]),
                "--output-dir", str(work / "weights"),
                "--epochs", str(TOOLS_EPOCHS),
                "--max-steps-per-epoch", str(TOOLS_STEPS),
                "--batch-size", str(TOOLS_BATCH),
                "--video-frames", str(cfg.video_frames),
                "--audio-frames", str(cfg.audio_frames),
                "--crop-size", str(cfg.crop_size), *on_card])
            stage("train", lambda: train_mod.run_training(
                train_args, device=train_args.device))
            tf32_after_train = tf32_flags()
            best = work / "weights" / "best_model_accuracy"
            logits_npz = work / "calib_logits.npz"
            fitted = stage("fit_calibrator", lambda: fit_calibrator.main([
                "--preprocessed-dir", str(stores["calib_zarr"][1]),
                "--model-path", str(best), "--method", "all",
                "--isotonic-out", str(work / "isotonic.pkl"),
                "--save-logits", str(logits_npz), *on_card]))
            platt = (fitted["calibration_platt_a"],
                     fitted["calibration_platt_b"])
            metrics = {
                "bf16": stage("eval_bf16", lambda: validate_pipeline.main(
                    eval_argv("eval_bf16"))),
                "int8": stage("eval_int8", lambda: validate_pipeline.main(
                    eval_argv("eval_int8", "--quantized-int8")))}
            fp32 = load_engine(best, cfg, use_bfloat16=False, device=dev,
                               calibrator=Calibrator.from_config(
                                   "platt", platt_a=platt[0],
                                   platt_b=platt[1]))
            metrics["fp32"] = stage(
                "eval_fp32", lambda: validate_pipeline.run_preprocessed_mode(
                    validate_pipeline.build_argparser().parse_args(
                        eval_argv("eval_fp32")), engine=fp32))
            predictor = Predictor(
                model_path=best, config=PredictorConfig(), model_config=cfg,
                detector_backend=detector(), device=dev)
            video_args = validate_pipeline.build_argparser().parse_args([
                "--data-dir", str(raw["video"]), "--output-dir",
                str(work / "eval_video"), *on_card])
            metrics["video"] = stage(
                "eval_video", lambda: validate_pipeline.run_video_mode(
                    video_args, predictor=predictor))
        launches = {"log_mel": k1.launches, "hf_stem": k2.launches,
                    "int8_conv": k3.launches, "int8_quant": k4.launches}
    finally:
        LipSyncModel.forward = real_forward
        clock.restore()

    # ── the same tools on the CPU, and the readings ───────────────────────
    def stored(out):
        ds = LipSyncDataset(preprocessed_dir=out)
        return [ds._load_tensors(rec) for rec in ds._manifest]

    # K1 and its twin on the card against a float64 chain, on the test
    # split's PCM (phase 3's quiet-band bounds: the clips are silent
    # between syllables; these launches come after the main runs' counts
    # were read).
    from lipsync_tpu_torch.preprocessing import audio as audio_mod

    k1_vs_f64 = {"kernel_db": 0.0, "twin_db": 0.0, "kernel_vs_twin_db": 0.0}
    for rel in sorted(memory.clips):
        if rel.startswith(str(raw["test"])):
            pcm = memory.clips[rel][1]
            got = audio_mod.preprocess_audio_pcm(pcm, device=dev)
            saved = audio_mod.log_mel_spectrogram_fused
            audio_mod.log_mel_spectrogram_fused = plain_log_mel
            try:
                twin = audio_mod.preprocess_audio_pcm(pcm, device=dev)
            finally:
                audio_mod.log_mel_spectrogram_fused = saved
            ref = mel_float64(pcm)
            for key, d in (("kernel_db", got - ref), ("twin_db", twin - ref),
                           ("kernel_vs_twin_db", got - twin)):
                k1_vs_f64[key] = max(k1_vs_f64[key], float(np.abs(d).max()))

    cpu = torch.device("cpu")
    with memory.installed():
        tensor_err = {}
        for name in ("test_zarr", "test_npy_detector", "test_fixed_clip"):
            out = work / f"{name}_cpu"
            check(precompute(name, out, cpu)["failed"] == 0,
                  f"{name} on the CPU failed a clip")
            card, host = stored(stores[name][1]), stored(out)
            scale = 255.0 if name == "test_fixed_clip" else 1.0
            tensor_err[name] = {
                "clips": len(card),
                "visual_max_abs": max(float(np.abs(
                    c[0].astype(np.float64) - h[0]).max() * scale)
                    for c, h in zip(card, host)),
                "mel_max_abs_db": max(float(np.abs(c[1] - h[1]).max())
                                      for c, h in zip(card, host))}
            check(len(card) == len(host) == n_of(name), f"{name}: clips")
    t0 = time.perf_counter()
    refit = fit_calibrator.main([
        "--logits-in", str(logits_npz), "--method", "all",
        "--isotonic-out", str(work / "isotonic_cpu.pkl")])
    fit_ms = (time.perf_counter() - t0) * 1e3
    with open(work / "isotonic.pkl", "rb") as f:
        iso_card = pickle.load(f)
    with open(work / "isotonic_cpu.pkl", "rb") as f:
        iso_cpu = pickle.load(f)

    def rows_of(out):
        with (work / out / "predictions.csv").open() as f:
            return list(csv.DictReader(f))

    recomputed = {}
    for name in metrics:
        rows = rows_of(f"eval_{name}")
        (work / f"recompute_{name}").mkdir()
        again = validate_pipeline.finalize_metrics(
            rows, work / f"recompute_{name}", 0.5)
        written = json.loads((work / f"eval_{name}" / "metrics.json")
                             .read_text())
        recomputed[name] = {
            "rows": len(rows),
            "error_rows": sum(r["verdict"] == "error" for r in rows),
            "equal": json.loads(json.dumps(again)) == written}

    # Warm eval throughput per engine, in turns, median of 3 (not counted).
    engines = {
        "bf16": load_engine(best, cfg, device=dev),
        "fp32": fp32,
        "int8": load_engine(best, cfg, quantized_int8=True, device=dev)}
    windows = n_of("test_zarr")
    windows_per_s = {}
    for name, engine in engines.items():
        engine.calibrator = fp32.calibrator
        args = validate_pipeline.build_argparser().parse_args(
            eval_argv(f"timed_{name}"))
        times = []
        for _ in range(3):
            sync()
            t1 = time.perf_counter()
            validate_pipeline.run_preprocessed_mode(args, engine=engine)
            sync()
            times.append(time.perf_counter() - t1)
        windows_per_s[name] = windows / statistics.median(times)

    n_pre = sum(c["new"] for c in counts.values())
    n_predicts = len(TOOLS_VIDEO)
    readings = {
        "phase": "tools", "nvidia_smi": smi, "render_s": render_s,
        "clips_precomputed": n_pre,
        "precompute_ms_per_clip": {k: v / n_pre
                                   for k, v in precompute_ms.items()},
        "precompute_s": {k: v for k, v in seconds.items()
                         if k.startswith("precompute_")},
        "training_s": seconds["train"],
        "eval_windows_per_s": windows_per_s,
        "eval_s": {k: v for k, v in seconds.items()
                   if k.startswith("eval_")},
        "fit_calibrator_s": seconds["fit_calibrator"],
        "fit_ms_from_logits": fit_ms,
        "launches": launches,
        "per_stage_k1_k2_k3_k4_forwards_int8forwards": per_stage,
        "counts": counts, "invalid": invalid,
        "fitted": {k: v for k, v in fitted.items() if "path" not in k},
        "refit_cpu": {k: v for k, v in refit.items() if "path" not in k},
        "isotonic_thresholds": len(iso_card.x_thresholds),
        "card_vs_cpu": tensor_err, "k1_on_card_vs_float64": k1_vs_f64,
        "metrics_recomputed": recomputed,
        "metrics": {k: {m: v.get(m) for m in ("accuracy", "f1", "roc_auc",
                                              "errors")}
                    for k, v in metrics.items()},
        "tf32_after_train": tf32_after_train,
        "phase_s": time.perf_counter() - t_phase}
    emit(readings)

    # Every number is printed above before any is checked.
    for name, c in counts.items():
        check(c["failed"] == 0 and c["new"] == n_of(name),
              f"precompute {name}: {c}")
    check(not any(invalid.values()), f"validate_preprocessed: {invalid}")
    check(tf32_after_train == {"cudnn": False, "matmul": False},
          f"run_training left TF32 on: {tf32_after_train}")
    for name, r in recomputed.items():
        check(r["error_rows"] == 0 and metrics[name].get("errors") == 0,
              f"eval {name}: error rows {r}")
        check(r["equal"], f"eval {name}: metrics.json differs from its "
                          "recomputation from predictions.csv")
    check(launches["log_mel"] == n_pre + n_predicts,
          f"K1 {launches['log_mel']} launches for {n_pre} clips and "
          f"{n_predicts} predicts")
    n_eval, n_int8 = sum(s[4] for s in per_stage.values()), sum(
        s[5] for s in per_stage.values())
    check(launches["hf_stem"] == n_eval and n_eval > 0,
          f"K2 {launches['hf_stem']} launches for {n_eval} eval forwards")
    check(n_int8 > 0 and launches["int8_conv"] == 24 * n_int8
          and launches["int8_quant"] == 24 * n_int8,
          f"K3 {launches['int8_conv']}, K4 {launches['int8_quant']} for "
          f"{n_int8} int8 forwards")
    for name, s in per_stage.items():
        check(s[1] == s[4], f"{name}: K2 {s[1]} for {s[4]} eval forwards")
    check(per_stage["eval_video"][0] == n_predicts,
          f"video mode: K1 {per_stage['eval_video'][0]}")
    # The mel of clips with silent stretches has bands 75-80 dB down, where
    # every fp32 chain rounds differently: phase 3's quiet-band bounds (K1
    # no further from float64 than its twin + 2e-4 dB, and within the
    # 2.5e-3 dB fp32 floor), and the card's tensors within that floor of
    # the CPU's.
    check(k1_vs_f64["kernel_db"] <= k1_vs_f64["twin_db"] + 2e-4
          and k1_vs_f64["kernel_db"] <= 2.5e-3,
          f"K1 vs float64 on the test split's PCM: {k1_vs_f64}")
    for name, e in tensor_err.items():
        check(e["visual_max_abs"] <= 1.0,
              f"{name}: crops card vs CPU {e['visual_max_abs']} uint8 steps")
        check(e["mel_max_abs_db"] <= 2.5e-3,
              f"{name}: mel card vs CPU {e['mel_max_abs_db']} dB")
    for key, value in refit.items():
        if "path" not in key:
            check(value == fitted[key], f"{key}: card {fitted[key]}, CPU "
                                        f"refit {value}")
    check(np.array_equal(iso_card.x_thresholds, iso_cpu.x_thresholds)
          and np.array_equal(iso_card.y_thresholds, iso_cpu.y_thresholds),
          "isotonic: card and CPU refit differ")
    shutil.rmtree(work, ignore_errors=True)
    return launches


EVAL_SECONDS = 3.0
# Clips per class: each preprocessed tier (envelope, phoneme) and each of
# the nine fake constructions of eval_unseen_fakes.
EVAL_TIER_CLIPS, EVAL_UNSEEN_CLIPS = 3, 2
EVAL_CONSTRUCTIONS = ("shift", "swap", "scramble", "warp", "splice",
                      "freeze", "revoice", "retime", "composite")
# (scene, faces, seed) of the multi-face scenes: a synced speaker and a
# listener; a synced and a dubbed speaker beside a listener.
EVAL_SCENES = (("all_real", 2, 31), ("mixed", 3, 32))
EVAL_TRACKS, EVAL_TRACK_FRAMES, EVAL_FLIP_CLIPS = 3, 120, 4
EVAL_PROBE = ("--batch", "32", "--groups", "2", "--iters", "2")
# The robustness grid's cells without a codec (the card's machine has no
# FFmpeg, so a codec cell must raise there).
EVAL_GRID_CELLS = ("clean", "vis_noise_0.02", "vis_noise_0.05",
                   "vis_noise_0.10", "brightness_0.7", "brightness_1.3",
                   "mel_noise_2db", "mel_noise_5db", "av_shift_1f",
                   "av_shift_2f", "av_shift_4f", "av_shift_8f")
# The JSON keys of the JAX package's scripts, which the tools' outputs
# carry (tests/test_torch_tools_{harness,diagnose}.py hold them equal to
# the scripts' on the CPU).
EVAL_METRICS = {"roc_auc", "accuracy", "f1", "precision", "recall", "total"}
EVAL_KEYS = {
    "eval_cross_tier": {"model", "model_path", "tiers"},
    "eval_unseen_fakes": {"model", "model_path", "n_per_class",
                          "seen_in_training", "unseen_constructions",
                          "constructions"},
    "eval_robustness_grid": {"preprocessed_dir", "clips_scored",
                             "threshold", "seed", "timestamp", "cells"},
    "grid_cell": {"roc_auc", "accuracy", "real_flagged_fake",
                  "fake_flagged_fake", "mean_p_fake_real_clips"},
    "eval_shared_encoding": {"platform", "n_tracks", "n_frames_per_track",
                             "n_windows", "prob_abs_diff",
                             "windowed_s_per_track_p50",
                             "shared_s_per_track_p50", "speedup"},
    "eval_shared_encoding_flips": {"n_clips", "model_path", "data_dir",
                                   "verdict_flips", "flip_details",
                                   "confidence_abs_delta"},
    "eval_multiface": {"summary", "clips"},
    "multiface_group": {
        "clips", "face_recovery", "spurious_tracks_per_clip",
        "speaker_track_match_rate", "speaker_verdict_accuracy",
        "clip_verdict_accuracy", "clip_uncertain_rate",
        "speaker_case_accuracy", "policy_accuracy", "timeline_attribution",
        "timeline_windows", "listener_mean_speaking_activity",
        "speaker_mean_speaking_activity", "mean_elapsed_sec"},
    "multiface_clip": {
        "clip", "scene", "n_tracks", "faces_recovered", "n_faces",
        "spurious_tracks", "speaker_rows", "listener_rows", "clip_gt_fake",
        "clip_verdict", "clip_verdict_correct", "speaker_case_pred",
        "speaker_case_gt", "speaking_tracks_count", "gt_speaker_count",
        "policy_correct", "timeline_total", "timeline_correct",
        "turn_taking_detected", "elapsed_sec"},
    "measure_articulation_bands": {"midpoint_constant", "scale_constant",
                                   "families"},
    "bands_family": {"clips", "speaker_band", "listener_band",
                     "separation_min_speaker_minus_max_listener",
                     "speaker_above_midpoint_frac",
                     "listener_below_midpoint_frac"},
    "debug_clips": {"motion", "audio_energy", "alignment_score",
                    "mouth_check"},
    "diagnose_sync_signal": {"n_clips", "n_real", "n_fake", "corr_open_env",
                             "corr_motion_denv"},
    "eval_crop_agreement": {"n_faces", "iou_vs_landmark_analog",
                            "iou_vs_raw_lips", "refined_changed_frac",
                            "refine_ms_per_frame", "learned_ms_per_frame"},
    "diagnose_videos": {"path", "probe", "decode", "audio"},
}


class SceneBoxes(ClipBoxes):
    """A detector for multi-face scenes: every face's mouth box in each
    known frame, looked up by a hash of the whole frame (the scenes' frames
    differ in few pixels). Keeps no per-video state."""

    @staticmethod
    def key(frame) -> bytes:
        import hashlib

        return hashlib.blake2b(frame.tobytes(), digest_size=16).digest()

    def add(self, frames, boxes) -> None:
        for f, bs in zip(frames, boxes):
            self.boxes[self.key(f)] = [tuple(b) for b in bs]

    def detect(self, frame):
        from lipsync_tpu_torch.preprocessing.face_detection import Detection

        return [Detection(bbox=b, detector="fake")
                for b in self.boxes.get(self.key(frame), [])]


def scene_mouth_boxes(frames, geo, cell_w: int = 170):
    """Each face's mouth box per frame of a rendered scene: the face
    ellipse of ``render_multiface_clip`` (half axes 0.24 cell and 0.30
    height, times the face's scale, around its center in that frame)
    through the face-to-mouth heuristic that the cascade tier applies."""
    from lipsync_tpu_torch.preprocessing.face_detection import (
        face_bbox_to_mouth_bbox,
    )

    h, w = frames.shape[1:3]
    out = []
    for i in range(len(frames)):
        boxes = []
        for g in geo:
            cx, cy = g["centers"][i]
            hw, hh = cell_w * 0.24 * g["scale"], h * 0.30 * g["scale"]
            boxes.append(face_bbox_to_mouth_bbox(
                int(cx - hw), int(cy - hh), int(2 * hw), int(2 * hh), w, h))
        out.append(boxes)
    return out


def evaluation_phase(dev, cfg, smi, weights, record) -> dict:
    """The evaluation harnesses and the diagnostics at ``ModelConfig()``
    width, each through its ``main(argv)`` on the calibrated weights saved
    as a ``.pth``, on clips that ``tools/make_synthetic_dataset.py`` renders
    in memory (``INGEST`` says why) and ``precompute_training_tensors``
    writes on the card: ``eval_cross_tier`` over an envelope and a phoneme
    tier (in process, and once more through a ``validate_pipeline``
    subprocess), ``eval_unseen_fakes`` over the nine constructions,
    ``eval_robustness_grid`` over every cell without a codec (a codec cell
    must raise: no FFmpeg there) and with ``--quantized-int8`` on ``clean``,
    ``eval_shared_encoding``, ``eval_shared_encoding_flips``,
    ``eval_multiface`` and ``measure_articulation_bands`` on a 2-face and a
    3-face scene (a detector that knows every face's box, the real
    tracker), ``debug_clips``, ``diagnose_sync_signal``,
    ``inspect_preprocessed_window``, ``probe_link_engine``, ``check_epoch``,
    ``checking_threshold``, ``diagnose_videos`` (the port's own ingest on a
    garbage file and a missing one) and ``eval_crop_agreement``. Checks:
    every tool returns, no failed clip and no error row, each JSON output
    has the JAX script's keys, K1 once per clip precomputed, per track
    and per ``predict``, K2 once per eval-mode forward, K3 and K4 24 times
    per int8 forward and only in the int8 run, and a raising K2 or K1 ends
    ``eval_cross_tier`` and ``debug_clips``. Returns the kernels' launches
    over its main runs."""
    import argparse
    import csv
    import io

    import numpy as np
    import torch

    from lipsync_tpu_torch.models import artifact as artifact_mod
    from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import audio as audio_mod
    from lipsync_tpu_torch.preprocessing import ingest
    from lipsync_tpu_torch.preprocessing.face_detection import (
        FakeDetector,
        center_crop_box,
    )
    from lipsync_tpu_torch.tools import (
        check_epoch,
        checking_threshold,
        debug_clips,
        diagnose_sync_signal,
        diagnose_videos,
        eval_crop_agreement,
        eval_cross_tier,
        eval_multiface,
        eval_robustness_grid,
        eval_shared_encoding,
        eval_shared_encoding_flips,
        eval_unseen_fakes,
        inspect_preprocessed_window,
    )
    from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
    from lipsync_tpu_torch.tools import measure_articulation_bands as bands
    from lipsync_tpu_torch.tools import precompute_training_tensors as pre
    from lipsync_tpu_torch.tools import probe_link_engine
    from lipsync_tpu_torch.training.checkpoints import save_checkpoint

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    fps, sr = 15.0, 16000
    on_card = ["--device", str(dev)]
    memory = InMemoryClips(ingest, fps)
    model_path = work / "bn_calibrated.pth"
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, model_path)

    # ── the clips, rendered in memory ─────────────────────────────────────
    t0 = time.perf_counter()

    def serve(path: Path, frames, pcm) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
        memory.add(str(path.relative_to(work)), frames, pcm, path=str(path))

    raw = {"envelope": work / "raw_envelope", "phoneme": work / "raw_phoneme"}
    for rel, frames, pcm in gen.envelope_clips(
            EVAL_TIER_CLIPS, EVAL_SECONDS, fps, sr, 41, jitter=True,
            hard_negatives=True):
        serve(raw["envelope"] / rel, frames, pcm)
    gen_args = argparse.Namespace(sr=sr, fps=fps, seconds=EVAL_SECONDS,
                                  jitter=True, no_head_motion=False)

    def phoneme_split(out: Path, n: int, seed: int, modes) -> None:
        rng = np.random.RandomState(seed)
        for i in range(n):
            real, fake = gen.phoneme_pair(gen_args, rng, i, modes)
            serve(out / "0_real" / f"real_{i:04d}.avi", *real)
            serve(out / "1_fake" / f"fake_{i:04d}.avi", *fake)

    phoneme_split(raw["phoneme"], EVAL_TIER_CLIPS, 42,
                  ("shift", "swap", "scramble"))
    unseen = work / "unseen"
    for k, c in enumerate(EVAL_CONSTRUCTIONS):
        phoneme_split(unseen / f"raw_{c}", EVAL_UNSEEN_CLIPS, 101 + k, (c,))
    scene_boxes = SceneBoxes()
    scene_dirs = {"two": work / "scenes_2f", "three": work / "scenes_3f"}
    for (scene, n_faces, seed), family in zip(EVAL_SCENES, scene_dirs):
        frames, pcm, truth, geo = gen.multiface_scene(
            scene, n_faces, EVAL_SECONDS, fps, sr,
            np.random.RandomState(seed))
        scene_boxes.add(frames, scene_mouth_boxes(frames, geo))
        for d in (scene_dirs[family], work / "scenes"):
            serve(d / f"{scene}_0000.avi", frames, pcm)
            (d / f"{scene}_0000.json").write_text(json.dumps(truth))
    flips = work / "flips"
    for rel in ("0_real/real_0000.avi", "0_real/real_0001.avi",
                "1_fake/fake_0000.avi", "1_fake/fake_0001.avi"):
        serve(flips / rel, *memory.clips[str(raw["envelope"] / rel)])
    debug_clip = raw["envelope"] / "0_real" / "real_0000.avi"
    render_s = time.perf_counter() - t0
    box = center_crop_box(*memory.clips[str(debug_clip)][0].shape[1:3], 96)

    def detector():
        return FakeDetector(lambda i: [box])

    # ── launches and seconds per tool ─────────────────────────────────────
    # An eval-mode forward is a ``score_encoded`` call: ``forward`` makes
    # one, and the shared-encoding engine calls it after encoding a track.
    forwards = {"eval": 0, "int8": 0}
    real_scoring = LipSyncModel.score_encoded

    def counted_scoring(model, *args, **kwargs):
        if not model.training:
            forwards["eval"] += 1
            forwards["int8"] += model.config.conv_lowering == "int8"
        return real_scoring(model, *args, **kwargs)

    counters = (k1, k2, k3, k4)
    per_stage, seconds, printed = {}, {}, {}

    def stage(name, fn):
        """``fn()`` as one tool run: its launches (K1, K2, K3, K4, eval-mode
        forwards, int8 forwards), its synchronised wall time and what it
        printed."""
        before = [c.launches for c in counters] + list(forwards.values())
        out = io.StringIO()
        sync()
        t1 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                result = fn()
        except BaseException:
            print(out.getvalue()[-3000:], flush=True)
            raise
        sync()
        seconds[name] = time.perf_counter() - t1
        after = [c.launches for c in counters] + list(forwards.values())
        per_stage[name] = [a - b for a, b in zip(after, before)]
        printed[name] = out.getvalue()
        return result

    # eval_cross_tier scores each tier in a temporary directory; keep the
    # in-process run's predictions for checking_threshold.
    kept = work / "cross_tier_predictions"
    real_score_tier = eval_cross_tier.score_tier

    def keeping_score_tier(model_path, pre_dir, out_dir, *args, **kwargs):
        m = real_score_tier(model_path, pre_dir, out_dir, *args, **kwargs)
        if kwargs.get("engine") is not None:
            kept.mkdir(exist_ok=True)
            shutil.copy(Path(out_dir) / "predictions.csv",
                        kept / f"{Path(pre_dir).name}.csv")
        return m

    pre_dirs = {t: work / f"pre_{t}" for t in raw}
    tier_argv = [arg for t in raw for arg in
                 ("--test-dir", f"{t}={pre_dirs[t]}")]
    platt = ["--calibration-platt-a", "1.3", "--calibration-platt-b", "0.1"]
    outputs, counts = {}, {}
    ckpt = work / "weights" / "best_model_accuracy"
    save_checkpoint(ckpt, weights, metadata={
        "epoch": 3, "phase": 2, "model_config": {
            "video_frames": cfg.video_frames, "crop_size": cfg.crop_size,
            "audio_frames": cfg.audio_frames}})

    def grid(out, *flags):
        return stage(out, lambda: eval_robustness_grid.main([
            "--preprocessed-dir", str(pre_dirs["envelope"]), "--model-path",
            str(model_path), "--output", str(work / f"{out}.json"), *flags,
            *on_card]))

    LipSyncModel.score_encoded = counted_scoring
    eval_cross_tier.score_tier = keeping_score_tier
    eval_unseen_fakes.score_tier = keeping_score_tier
    try:
        with record(), memory.installed():
            k1.launches = k2.launches = k3.launches = k4.launches = 0
            for name, src, dst in (
                    *((t, raw[t], pre_dirs[t]) for t in raw),
                    *((c, unseen / f"raw_{c}", unseen / f"pre_{c}")
                      for c in EVAL_CONSTRUCTIONS)):
                counts[name] = stage(f"precompute_{name}", lambda: pre.main([
                    "--data-dir", str(src), "--output-dir", str(dst),
                    "--mode", "full_sequence", "--storage-format", "zarr",
                    "--no-face-detection", *on_card]))
            outputs["eval_cross_tier"] = stage(
                "eval_cross_tier", lambda: eval_cross_tier.main([
                    "--model-path", str(model_path), *tier_argv, *platt,
                    "--in-process", "--output",
                    str(work / "cross_tier.json"), *on_card]))
            outputs["eval_cross_tier_subprocess"] = stage(
                "eval_cross_tier_subprocess", lambda: eval_cross_tier.main([
                    "--model-path", str(model_path), "--test-dir",
                    f"envelope={pre_dirs['envelope']}", *platt, "--output",
                    str(work / "cross_tier_subprocess.json"), *on_card]))
            outputs["eval_unseen_fakes"] = stage(
                "eval_unseen_fakes", lambda: eval_unseen_fakes.main([
                    "--model-path", str(model_path), "--work-dir",
                    str(unseen), "--n-per-class", str(EVAL_UNSEEN_CLIPS),
                    "--skip-generate", "--skip-precompute", "--in-process",
                    *platt, "--output", str(work / "unseen.json"),
                    *on_card]))
            outputs["eval_robustness_grid"] = grid(
                "grid", "--cells", ",".join(EVAL_GRID_CELLS))
            try:
                grid("grid_codec", "--cells", "codec_crf23")
                codec_error = None
            except Exception as e:  # the codec cell must raise here
                codec_error = f"{type(e).__name__}: {e}"[:300]
            outputs["eval_robustness_grid_int8"] = grid(
                "grid_int8", "--cells", "clean", "--quantized-int8")
            outputs["eval_shared_encoding"] = stage(
                "eval_shared_encoding", lambda: eval_shared_encoding.main([
                    "--n-tracks", str(EVAL_TRACKS), "--n-frames",
                    str(EVAL_TRACK_FRAMES), "--out",
                    str(work / "shared.json"), *on_card]))
            outputs["eval_shared_encoding_flips"] = stage(
                "eval_shared_encoding_flips",
                lambda: eval_shared_encoding_flips.main([
                    "--data-dir", str(flips), "--model-path",
                    str(model_path), "--limit", str(EVAL_FLIP_CLIPS),
                    "--out", str(work / "flips.json"), *on_card],
                    detector_backend=detector()))
            outputs["eval_multiface"] = stage(
                "eval_multiface", lambda: eval_multiface.main([
                    "--data-dir", str(work / "scenes"), "--model-path",
                    str(model_path), "--speaking-score-mode", "articulation",
                    "--output", str(work / "multiface.json"), *on_card],
                    detector_backend=scene_boxes))
            outputs["measure_articulation_bands"] = stage(
                "measure_articulation_bands", lambda: bands.main([
                    *(a for f, d in scene_dirs.items()
                      for a in ("--data-dir", f"{f}={d}")),
                    "--out", str(work / "bands.json"), *on_card],
                    backend=scene_boxes))
            outputs["debug_clips"] = stage(
                "debug_clips", lambda: debug_clips.main([
                    "--video", str(debug_clip), "--out",
                    str(work / "debug.png"), *on_card], backend=detector()))
            outputs["diagnose_sync_signal"] = stage(
                "diagnose_sync_signal", lambda: diagnose_sync_signal.main([
                    "--preprocessed-dir", str(pre_dirs["envelope"]),
                    "--json-out", str(work / "sync.json")]))
            outputs["inspect_preprocessed_window"] = stage(
                "inspect_preprocessed_window",
                lambda: inspect_preprocessed_window.main([
                    "--preprocessed-dir", str(pre_dirs["phoneme"]),
                    "--index", "1", "--out", str(work / "window.png")]))
            outputs["probe_link_engine"] = stage(
                "probe_link_engine",
                lambda: probe_link_engine.main([*EVAL_PROBE, *on_card]))
            outputs["check_epoch"] = stage(
                "check_epoch", lambda: check_epoch.main(
                    [str(ckpt), str(work / "weights" / "missing")]))
            outputs["checking_threshold"] = stage(
                "checking_threshold", lambda: checking_threshold.main(
                    [str(kept / "pre_envelope.csv")]))
        launches = {"log_mel": k1.launches, "hf_stem": k2.launches,
                    "int8_conv": k3.launches, "int8_quant": k4.launches}
    finally:
        LipSyncModel.score_encoded = real_scoring
        eval_cross_tier.score_tier = real_score_tier
        eval_unseen_fakes.score_tier = real_score_tier

    # The host-only tools, on the port's own ingest (no stand-in).
    bad = work / "bad_videos"
    bad.mkdir()
    (bad / "garbage.mp4").write_bytes(b"\x00 not a video " * 64)
    (bad / "missing.avi").symlink_to(work / "gone.avi")
    outputs["diagnose_videos"] = stage(
        "diagnose_videos", lambda: diagnose_videos.main(
            ["--data-dir", str(bad)]))
    outputs["eval_crop_agreement"] = stage(
        "eval_crop_agreement", lambda: eval_crop_agreement.main(
            ["--n", "50", "--out", str(work / "crops.json")]))

    # A raising kernel wrapper ends the harness: K2 in eval_cross_tier (its
    # tiers are preprocessed, so K2 is the kernel it runs), K1 in
    # debug_clips. Launches after the main runs' counts were read.
    def raising(what):
        def fn(*args, **kwargs):
            raise RuntimeError(f"{what} kernel launch failed (injected)")
        return fn

    injected = {}
    with memory.installed():
        for name, owner, attr, fn in (
                ("eval_cross_tier", artifact_mod, "hf_stem",
                 lambda: eval_cross_tier.main([
                     "--model-path", str(model_path), *tier_argv,
                     "--in-process", *on_card])),
                ("debug_clips", audio_mod, "log_mel_spectrogram_fused",
                 lambda: debug_clips.main([
                     "--video", str(debug_clip), "--out",
                     str(work / "debug_failed.png"), *on_card],
                     backend=detector()))):
            saved = getattr(owner, attr)
            setattr(owner, attr, raising(attr))
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    fn()
                injected[name] = None
            except RuntimeError as e:
                injected[name] = str(e)
            finally:
                setattr(owner, attr, saved)

    # ── readings ──────────────────────────────────────────────────────────
    def read_json(name):
        return json.loads((work / name).read_text())

    cross = read_json("cross_tier.json")
    sub = read_json("cross_tier_subprocess.json")
    unseen_out = read_json("unseen.json")
    grid_out, grid8 = read_json("grid.json"), read_json("grid_int8.json")
    shared, flips_out = read_json("shared.json"), read_json("flips.json")
    mface, bands_out = read_json("multiface.json"), read_json("bands.json")
    sync_out, crops = read_json("sync.json"), read_json("crops.json")
    with (kept / "pre_envelope.csv").open() as f:
        kept_rows = {"envelope": list(csv.DictReader(f))}
    with (kept / "pre_phoneme.csv").open() as f:
        kept_rows["phoneme"] = list(csv.DictReader(f))
    tier_windows = 2 * EVAL_TIER_CLIPS
    windows = {
        "eval_cross_tier": 2 * tier_windows,
        "eval_cross_tier_subprocess": tier_windows,
        "eval_unseen_fakes": 2 * EVAL_UNSEEN_CLIPS * len(EVAL_CONSTRUCTIONS),
        "grid": len(EVAL_GRID_CELLS) * tier_windows,
        "grid_int8": tier_windows,
        "eval_shared_encoding": shared["n_windows"]}
    probe = outputs["probe_link_engine"]
    readings = {
        "phase": "evaluation", "nvidia_smi": smi, "render_s": render_s,
        "tool_s": {k: v for k, v in seconds.items()
                   if not k.startswith("precompute_")},
        "precompute_s": sum(v for k, v in seconds.items()
                            if k.startswith("precompute_")),
        "windows_per_s": {k: n / seconds[k] for k, n in windows.items()},
        "predicts_per_s": {
            "eval_shared_encoding_flips":
                2 * EVAL_FLIP_CLIPS / seconds["eval_shared_encoding_flips"],
            "eval_multiface": len(EVAL_SCENES) / seconds["eval_multiface"]},
        "probe_link_engine": probe,
        "launches": launches,
        "per_stage_k1_k2_k3_k4_forwards_int8forwards": per_stage,
        "precompute_counts": counts,
        "cross_tier": cross["tiers"], "cross_tier_subprocess": sub["tiers"],
        "unseen": {c: {k: m.get(k) for k in ("roc_auc", "recall", "total")}
                   for c, m in unseen_out["constructions"].items()},
        "grid_clean": grid_out["cells"]["clean"],
        "grid_int8_clean": grid8["cells"]["clean"],
        "codec_cell_error": codec_error,
        "shared_encoding": shared,
        "flips": {k: flips_out[k] for k in ("n_clips", "verdict_flips",
                                            "confidence_abs_delta")},
        "multiface_overall": mface["summary"]["overall"],
        "bands": bands_out["families"],
        "debug_clips": {
            "alignment_score": float(outputs["debug_clips"][
                "alignment_score"]),
            "mouth_check": str(outputs["debug_clips"]["mouth_check"])[:200]},
        "sync_signal": sync_out,
        "crop_agreement": crops["iou_vs_landmark_analog"],
        "diagnose_videos": [{k: r[k] for k in ("decode", "audio")}
                            for r in outputs["diagnose_videos"]],
        "injected_failures": injected,
        "phase_s": time.perf_counter() - t_phase}
    emit(readings)

    # Every number is printed above before any is checked.
    for name in ("eval_cross_tier", "eval_cross_tier_subprocess",
                 "eval_unseen_fakes", "eval_shared_encoding",
                 "eval_shared_encoding_flips", "eval_multiface",
                 "measure_articulation_bands", "check_epoch"):
        check(outputs[name] == 0, f"{name} returned {outputs[name]}")
    for name, c in counts.items():
        n = 2 * (EVAL_TIER_CLIPS if name in raw else EVAL_UNSEEN_CLIPS)
        check(c["failed"] == 0 and c["new"] == n,
              f"precompute {name}: {c}")
    for out, key in ((cross, "eval_cross_tier"), (sub, "eval_cross_tier"),
                     (unseen_out, "eval_unseen_fakes"),
                     (grid_out, "eval_robustness_grid"),
                     (grid8, "eval_robustness_grid"),
                     (shared, "eval_shared_encoding"),
                     (flips_out, "eval_shared_encoding_flips"),
                     (mface, "eval_multiface"),
                     (bands_out, "measure_articulation_bands"),
                     (outputs["debug_clips"], "debug_clips"),
                     (sync_out, "diagnose_sync_signal"),
                     (crops, "eval_crop_agreement")):
        check(set(out) == EVAL_KEYS[key], f"{key} keys {sorted(out)}")
    for tiers, n in ((cross["tiers"], 2), (sub["tiers"], 1)):
        check(len(tiers) == n and all(
            set(m) == EVAL_METRICS and m["total"] == tier_windows
            for m in tiers.values()), f"cross-tier metrics {tiers}")
    for tier, rows in kept_rows.items():
        check(len(rows) == tier_windows
              and not any(r["verdict"] == "error" for r in rows),
              f"cross-tier {tier}: error rows")
    check(set(unseen_out["constructions"]) == set(EVAL_CONSTRUCTIONS)
          and all(set(m) == EVAL_METRICS | {"unseen"}
                  and m["total"] == 2 * EVAL_UNSEEN_CLIPS
                  and m["unseen"] == (c not in ("shift", "swap", "scramble"))
                  for c, m in unseen_out["constructions"].items()),
          f"unseen constructions {unseen_out['constructions']}")
    check(list(grid_out["cells"]) == list(EVAL_GRID_CELLS)
          and list(grid8["cells"]) == ["clean"]
          and grid_out["clips_scored"] == grid8["clips_scored"] == tier_windows
          and all(set(c) == EVAL_KEYS["grid_cell"]
                  for c in [*grid_out["cells"].values(),
                            *grid8["cells"].values()]),
          "robustness grid cells")
    check(codec_error is not None, "a codec cell ran without FFmpeg")
    check(shared["platform"] == dev.type
          and shared["n_windows"] == EVAL_TRACKS * (
              (EVAL_TRACK_FRAMES - cfg.video_frames) // STRIDE + 1)
          and all(np.isfinite(v) for v in shared["prob_abs_diff"].values()),
          f"shared encoding {shared}")
    check(flips_out["n_clips"] == EVAL_FLIP_CLIPS
          and all(np.isfinite(v)
                  for v in flips_out["confidence_abs_delta"].values()),
          f"flips {flips_out}")
    check(len(mface["clips"]) == len(EVAL_SCENES)
          and all(set(r) == EVAL_KEYS["multiface_clip"]
                  for r in mface["clips"])
          and all(set(g) == EVAL_KEYS["multiface_group"]
                  for g in mface["summary"].values())
          and mface["summary"]["overall"]["face_recovery"] == 1.0,
          f"multiface {mface['summary']['overall']}")
    check(all(f["clips"] == 1 and set(f) == EVAL_KEYS["bands_family"]
              for f in bands_out["families"].values()),
          f"articulation bands {bands_out['families']}")
    check(sync_out["n_clips"] == tier_windows, f"sync signal {sync_out}")
    window = outputs["inspect_preprocessed_window"]
    check(tuple(np.asarray(window[0]).shape) == (
        cfg.video_frames, cfg.crop_size, cfg.crop_size, 3),
        "inspect_preprocessed_window")
    check(len(probe["iters"]) == 2 and all(
        it["link_mb_per_s"] > 0 and it["engine_windows_per_s"] > 0
        for it in probe["iters"]), f"probe {probe}")
    check('"epoch": 3' in printed["check_epoch"]
          and "(no metadata)" in printed["check_epoch"], "check_epoch")
    check(len(outputs["checking_threshold"]) == 19, "checking_threshold")
    check(len(outputs["diagnose_videos"]) == 2 and all(
        set(r) == EVAL_KEYS["diagnose_videos"]
        and r["decode"].startswith("FAILED")
        for r in outputs["diagnose_videos"]), "diagnose_videos")
    check(crops["n_faces"] == 50, "eval_crop_agreement")
    check(all(v is not None and "injected" in v for v in injected.values()),
          f"an injected kernel failure did not end the run: {injected}")
    # Launches per tool: K1 once per clip precomputed, per track and per
    # predict, and nowhere else; K2 once per eval-mode forward, in every
    # tool that runs the model; K3 and K4 24 times per int8 forward, only
    # in the int8 grid.
    k1_expected = {"eval_shared_encoding": EVAL_TRACKS,
                   "eval_shared_encoding_flips": 2 * EVAL_FLIP_CLIPS,
                   "eval_multiface": len(EVAL_SCENES), "debug_clips": 1}
    engine_tools = {"eval_cross_tier", "eval_unseen_fakes", "grid",
                    "grid_int8", "eval_shared_encoding",
                    "eval_shared_encoding_flips", "eval_multiface",
                    "probe_link_engine"}
    for name, s in per_stage.items():
        if name.startswith("precompute_"):
            want_k1 = counts[name.removeprefix("precompute_")]["new"]
        else:
            want_k1 = k1_expected.get(name, 0)
        check(s[0] == want_k1, f"{name}: K1 {s[0]}, expected {want_k1}")
        check(s[1] == s[4] and (s[4] > 0) == (name in engine_tools),
              f"{name}: K2 {s[1]} for {s[4]} eval forwards")
        check(s[2] == s[3] == 24 * s[5] and (s[5] > 0) == (
            name == "grid_int8"),
            f"{name}: K3 {s[2]}, K4 {s[3]} for {s[5]} int8 forwards")
    shutil.rmtree(work, ignore_errors=True)
    return launches


# Phase 14: the rest of the scripts tier (``lipsync_tpu_torch/tools``): the
# launchers, which start the port's tools and trainers as child processes,
# the profilers and the benchmarks. The card's machine has no FFmpeg and no
# OpenCV cascade files (``INGEST``), so every Python process of the phase,
# children included, runs with the host stand-in of :func:`file_clips`:
# clips are written and read as ``.npz`` payloads at their ``.avi`` paths,
# and the face detector is :class:`CenterBoxes`. Everything from the frames
# onward is the port's own code on the card.
SCRIPTS_SMOKE_ENV = {"NPC_TRAIN": "4", "NPC_CALIB": "2", "EPOCHS": "1",
                     "MF_PER_KIND": "1", "UNSEEN_NPC": "2",
                     "INTF_NPC": "2", "INTF_NPC_CAL": "2", "INTF_EPOCHS": "1"}
SCRIPTS_FORWARD = ("--batch", "128", "--iters", "5", "--artifact-detail")
SCRIPTS_HOST = ("--seconds", "3", "--repeats", "3")
SCRIPTS_AB = ("--batch", "128", "--iters", "5")
SCRIPTS_DIAG = ("--batch", "16", "--iters", "3")
# 1024 cannot fit in 80 GB (batch 32 trains in 9.65 GB); 128 comes after it,
# so the sweep must go on past the out-of-memory row.
SCRIPTS_SCALING = ("--batches", "32,1024,128", "--iters", "3")
SCRIPTS_CLIPS = ("--n-clips", "2", "--clip-seconds", "3")
SCRIPTS_REQUESTS = ("--requests", "8", "--concurrency", "2", "--n-clips",
                    "2", "--clip-seconds", "2")
SCRIPTS_COALESCE = ("--requests", "16", "--concurrencies", "1,4")
STAND_IN_ENV = "CHIP_SMOKE_STAND_IN"
STAND_IN_LOG_ENV = "CHIP_SMOKE_STAND_IN_LOG"

# Put in a directory first on PYTHONPATH: every Python process that the
# launchers start (and those that they start) installs the stand-in. A
# sitecustomize that this one shadows runs first.
SITECUSTOMIZE = '''\
import importlib.machinery
import importlib.util
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize",
    [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _shadowed = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shadowed)
if os.environ.get("CHIP_SMOKE_STAND_IN"):
    sys.path.insert(0, os.environ["CHIP_SMOKE_STAND_IN"])
    import chip_smoke
    chip_smoke.child_stand_in(os.environ["CHIP_SMOKE_STAND_IN_LOG"])
'''


class CenterBoxes:
    """The phase's face detector: the centre 96-pixel box of every frame
    (``center_crop_box``), in place of the cascade ladder whose data files
    the card's machine lacks. Stateless, so threads can share it."""

    name = "center_box_stand_in"

    def reset(self) -> None:
        pass

    def detect(self, frame):
        from lipsync_tpu_torch.preprocessing.face_detection import (
            Detection,
            center_crop_box,
        )

        return [Detection(bbox=center_crop_box(*frame.shape[:2], 96),
                          detector=self.name)]


class FileClips:
    """``mux.write_video`` and ``ingest.probe`` / ``read_video`` /
    ``read_audio`` over ``.npz`` payloads (frames, PCM, rates) written at
    the clip's own path; a file that holds no payload raises as ingest
    does for a file it cannot read."""

    @staticmethod
    def write_video(path, frames, fps=15.0, pcm=None, sample_rate=16000,
                    vcodec="mpeg4", vcodec_opts=None):
        import numpy as np

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            np.savez(f, frames=np.asarray(frames, np.uint8),
                     pcm=np.zeros(0, np.float32) if pcm is None
                     else np.asarray(pcm, np.float32),
                     fps=float(fps), sr=int(sample_rate))
        return path

    @staticmethod
    def _load(path):
        import numpy as np

        from lipsync_tpu_torch.preprocessing import ingest

        if not Path(path).is_file():
            raise FileNotFoundError(str(path))
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:
            raise ingest.HostStageError(f"not a clip payload: {path}") from e

    def probe(self, path):
        from lipsync_tpu_torch.preprocessing import ingest

        z = self._load(path)
        n, h, w = z["frames"].shape[:3]
        fps = float(z["fps"])
        return ingest.MediaInfo(width=w, height=h, fps=fps,
                                duration_sec=n / fps, nb_frames=n,
                                has_audio=len(z["pcm"]) > 0,
                                sample_rate=int(z["sr"]))

    def read_video(self, path, target_fps=15.0, max_total_frames=None,
                   out_size=None):
        z = self._load(path)
        check(abs(float(z["fps"]) - target_fps) < 1e-6 and out_size is None,
              "the stand-in's clips are stored at the target rate and size")
        return z["frames"][:max_total_frames].copy()

    def read_audio(self, path, sr=16000):
        z = self._load(path)
        check(int(z["sr"]) == sr, "the stand-in's clips hold 16 kHz PCM")
        return z["pcm"].copy()


@contextlib.contextmanager
def file_clips():
    """While open, the port's muxer, ingest readers and default detector
    are :class:`FileClips` and :class:`CenterBoxes`; ``check_setup``'s
    ingest, muxer and cascade lines name the stand-in."""
    from lipsync_tpu_torch.preprocessing import face_detection as fd
    from lipsync_tpu_torch.preprocessing import haar, ingest, mux
    from lipsync_tpu_torch.tools import make_synthetic_dataset as gen

    clips = FileClips()

    class StandInCascade:
        def __init__(self, path):
            self.data = type("Data", (), {"stage_thresholds": []})()

    saved = [(mux, "write_video"), (ingest, "probe"),
             (ingest, "read_video"), (ingest, "read_audio"),
             (ingest, "get_native_lib"), (mux, "_get_lib"),
             (haar, "find_cascade_file"), (haar, "HaarCascade"),
             (fd, "_default_backend"), (gen, "write_video")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    mux.write_video = gen.write_video = clips.write_video
    ingest.probe = clips.probe
    ingest.read_video = clips.read_video
    ingest.read_audio = clips.read_audio
    ingest.get_native_lib = lambda: "npz file-clip stand-in"
    mux._get_lib = lambda: "npz file-clip stand-in"
    haar.find_cascade_file = lambda name: Path(f"{CenterBoxes.name}.xml")
    haar.HaarCascade = StandInCascade
    fd._default_backend = CenterBoxes()
    try:
        yield clips
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def _as_key(v):
    return tuple(_as_key(x) for x in v) if isinstance(v, list) else v


_CHILD_CONTEXTS = []


def child_stand_in(log: str) -> None:
    """A child process of phase 14: the stand-in for its whole life, its
    kernel inputs recorded, and at exit one line appended to ``log`` with
    its command, the four launch counts and those inputs."""
    import atexit

    seen = {}
    # Kept open for the process's life: a context manager that is
    # collected closes, and would put the real functions back.
    _CHILD_CONTEXTS.extend([file_clips(), kernel_inputs(seen)])
    for ctx in _CHILD_CONTEXTS:
        ctx.__enter__()

    started = time.perf_counter()

    def dump():
        from lipsync_tpu_torch.ops.kernels import hf_stem as k2
        from lipsync_tpu_torch.ops.kernels import int8_conv as k3
        from lipsync_tpu_torch.ops.kernels import int8_quant as k4
        from lipsync_tpu_torch.ops.kernels import mel as k1

        with open(log, "a") as f:
            f.write(json.dumps({
                "argv": sys.argv,
                "seconds": time.perf_counter() - started,
                "launches": [k1.launches, k2.launches, k3.launches,
                             k4.launches],
                "seen": {k: sorted(v) for k, v in seen.items()}}) + "\n")

    atexit.register(dump)


def scripts_phase(dev, cfg, smi, weights, record) -> dict:
    """The scripts tier at ``ModelConfig()`` width, each through the entry
    point a user calls: ``smoke_interference.sh`` at tiny sizes (it drives
    ``train_interference_r4.sh``: the generator, precompute, training with
    the device cache, finetune, the merge, ``fit_calibrator``,
    ``eval_multiface``, ``eval_unseen_fakes`` and the in-line replay, each a
    child process); ``run_finetune_jenkins.sh`` (``check_setup``,
    ``run_finetune.sh`` on the smoke's checkpoint, ``validate_pipeline`` on
    clips); ``run_finetune_strict_venv`` without a ``./venv``; and in this
    process ``profile_forward``, ``profile_host``, ``bench_int8``,
    ``bench_fold``, ``diagnose_int8``, ``bench_train_scaling``,
    ``bench_predictor``, ``bench_serving`` (stub and model) and
    ``bench_coalesce_r5``. ``bench_haar`` is host only and needs the
    cascade files: not run here. Returns the kernels' launches over the
    in-process runs and, apart, the children's."""
    import io

    import numpy as np
    import torch

    from lipsync_tpu_torch.inference.engine import load_engine
    from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.tools import make_synthetic_dataset as gen
    from lipsync_tpu_torch.tools import (
        bench_coalesce_r5,
        bench_fold,
        bench_int8,
        bench_predictor,
        bench_serving,
        bench_train_scaling,
        diagnose_int8,
        profile_forward,
        profile_host,
        run_finetune_strict_venv,
    )

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_scripts_"))
    pth = work / "calibrated.pth"
    torch.save(weights, pth)
    on_card = ["--device", str(dev)]

    # The children: ``python`` first on PATH is this interpreter, and the
    # stand-in's sitecustomize first on PYTHONPATH.
    (work / "bin").mkdir()
    (work / "site").mkdir()
    shim = work / "bin" / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    (work / "site" / "sitecustomize.py").write_text(SITECUSTOMIZE)
    child_env = {
        **os.environ,
        "PATH": f"{work / 'bin'}:{os.environ.get('PATH', '')}",
        "PYTHONPATH": ":".join(filter(None, [
            str(work / "site"), str(ROOT), os.environ.get("PYTHONPATH", "")])),
        STAND_IN_ENV: str(ROOT)}
    launcher_lines = []

    def run_launcher(name, env, timeout):
        """Runs ``lipsync_tpu_torch/tools/<name>.sh`` from the checkout's
        root; its seconds and its children's records (they append to a log
        of their own)."""
        log = work / f"{name}.children.jsonl"
        t_start = time.perf_counter()
        proc = subprocess.run(
            ["bash", str(ROOT / "lipsync_tpu_torch" / "tools"
                         / f"{name}.sh")],
            cwd=ROOT, env={**child_env, STAND_IN_LOG_ENV: str(log), **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=timeout)
        launcher_lines.extend(
            f"{name}: {line}" for line in proc.stdout.splitlines()
            if re.match(r"\[\d\d:\d\d:\d\d\]", line))
        check(proc.returncode == 0,
              f"{name}.sh exited {proc.returncode}:\n{proc.stdout[-8000:]}")
        return {"seconds": time.perf_counter() - t_start,
                "children": [json.loads(line) for line in
                             log.read_text().splitlines()]
                if log.exists() else []}

    forwards = {"eval": 0, "int8": 0, "folded": 0}
    real_forward = LipSyncModel.forward

    def counted_forward(model, *args, **kwargs):
        if not model.training:
            forwards["eval"] += 1
            forwards["int8"] += model.config.conv_lowering == "int8"
            forwards["folded"] += bool(model.config.hf_stem_fold)
        return real_forward(model, *args, **kwargs)

    counters = (k1, k2, k3, k4)
    per_tool, seconds = {}, {}

    def tool(name, fn):
        """``fn()`` as one tool run: its launches (K1, K2, K3, K4, eval
        forwards, int8 forwards, folded forwards) and its synchronised wall
        time."""
        before = [c.launches for c in counters] + list(forwards.values())
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t1
        after = [c.launches for c in counters] + list(forwards.values())
        per_tool[name] = [a - b for a, b in zip(after, before)]
        return out

    def quiet(fn):
        """``fn()`` with its standard output kept, not printed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        return out, buf.getvalue()

    smoke = work / "smoke"
    LipSyncModel.forward = counted_forward
    try:
        with record(), file_clips():
            # run_finetune_jenkins.sh on raw clips of its own, the
            # calibrated weights as its base checkpoint: raw-video finetune
            # and evaluation. (Run beside the smoke, both took longer than
            # one after the other: each child's start is CPU-bound.)
            gen.main(["--output-dir", str(work / "jraw"), "--style",
                      "phoneme", "--n-per-class", "2", "--seed", "21"])
            k1.launches = k2.launches = k3.launches = k4.launches = 0
            launchers = {
                "smoke_interference": tool(
                    "smoke_interference", lambda: run_launcher(
                        "smoke_interference",
                        {"S": str(smoke), **SCRIPTS_SMOKE_ENV}, 600)),
                "run_finetune_jenkins": tool(
                    "run_finetune_jenkins", lambda: run_launcher(
                        "run_finetune_jenkins", {
                            "WORKSPACE": str(work / "ws"),
                            "DATA_DIR": str(work / "jraw"),
                            "CHECKPOINT": str(pth), "EPOCHS": "1",
                            "FROZEN_EPOCHS": "1", "BATCH_SIZE": "8",
                            "EVAL_DATA_DIR": str(work / "jraw")}, 300))}
            strict_rc, strict_out = tool(
                "run_finetune_strict_venv",
                lambda: quiet(lambda: run_finetune_strict_venv.main([])))
            fwd, _ = tool("profile_forward", lambda: quiet(
                lambda: profile_forward.main([*SCRIPTS_FORWARD, *on_card])))
            host, _ = tool("profile_host", lambda: quiet(
                lambda: profile_host.main([*SCRIPTS_HOST, *on_card],
                                          backend=CenterBoxes())))
            int8_ab, _ = tool("bench_int8", lambda: quiet(
                lambda: bench_int8.main([*SCRIPTS_AB, *on_card])))
            fold_ab, _ = tool("bench_fold", lambda: quiet(
                lambda: bench_fold.main([*SCRIPTS_AB, *on_card])))
            diag, _ = tool("diagnose_int8", lambda: quiet(
                lambda: diagnose_int8.main([
                    *SCRIPTS_DIAG, "--out", str(work / "diag.json"),
                    *on_card])))
            torch.cuda.empty_cache()
            scaling, _ = tool("bench_train_scaling", lambda: quiet(
                lambda: bench_train_scaling.main([*SCRIPTS_SCALING,
                                                  *on_card])))
            torch.cuda.empty_cache()
            predictor, _ = tool("bench_predictor", lambda: quiet(
                lambda: bench_predictor.main(
                    ["--model-path", str(pth), *SCRIPTS_CLIPS, *on_card],
                    detector_backend=CenterBoxes())))
            serving_stub, _ = tool("bench_serving_stub", lambda: quiet(
                lambda: bench_serving.main(["--stub-model",
                                            *SCRIPTS_REQUESTS])))
            serving_model, _ = tool("bench_serving_model", lambda: quiet(
                lambda: bench_serving.main(
                    ["--model-path", str(pth), *SCRIPTS_REQUESTS,
                     *on_card], detector_backend=CenterBoxes())))
            engine = load_engine(pth, cfg, device=dev)
            coalesce, _ = tool("bench_coalesce_r5", lambda: quiet(
                lambda: bench_coalesce_r5.main(
                    [*SCRIPTS_COALESCE, "--out", str(work / "coal.json"),
                     *on_card], engine=engine)))
        launches = {"log_mel": k1.launches, "hf_stem": k2.launches,
                    "int8_conv": k3.launches, "int8_quant": k4.launches}
    finally:
        LipSyncModel.forward = real_forward

    # The children's kernel inputs join the main path's.
    kids = [c for r in launchers.values() for c in r["children"]]
    child_seen = {}
    for c in kids:
        for name, keys in c["seen"].items():
            child_seen.setdefault(name, set()).update(
                _as_key(k) for k in keys)
    child_launches = [sum(c["launches"][i] for c in kids) for i in range(4)]

    out_dir = smoke / "out"
    artifacts = {p.name: sorted(json.loads(p.read_text()))
                 for p in sorted(out_dir.glob("*.json"))}
    forgetting = smoke / "intf" / "seen_forgetting.json"
    eval_metrics = work / "ws" / "eval_out" / "metrics.json"
    n_int8 = per_tool["bench_int8"][5]
    readings = {
        "phase": "scripts", "nvidia_smi": smi,
        "stand_in": "ingest, muxer and detector: FileClips + CenterBoxes "
                    "(no FFmpeg or cascade files on the card's machine); the "
                    "profile_host and bench detectors too",
        "seconds": seconds,
        "per_tool_k1_k2_k3_k4_eval_int8_folded": per_tool,
        "launches": launches,
        "children": {"processes": len(kids),
                     "seconds_in_python": sum(c["seconds"] for c in kids),
                     "launches_k1_k2_k3_k4": child_launches,
                     "per_command": [[c["argv"][0].rsplit("/", 1)[-1],
                                      round(c["seconds"], 2), c["launches"]]
                                     for c in kids]},
        "launcher_log": launcher_lines,
        "smoke_artifacts": artifacts,
        "profile_forward": fwd, "profile_host": host,
        "bench_int8": int8_ab, "bench_fold": fold_ab,
        "diagnose_int8": diag, "bench_train_scaling": scaling,
        "bench_predictor": predictor,
        "bench_serving_stub": serving_stub,
        "bench_serving_model": serving_model,
        "bench_coalesce_r5": {k: v for k, v in coalesce.items()
                              if k != "model_path"},
        "bench_haar": "not run: host only, and the card's machine has no "
                      "OpenCV cascade files (tests/test_torch_tools_bench.py "
                      "holds it on the CPU)",
        "strict_venv": {"rc": strict_rc, "output": strict_out},
        "phase_s": time.perf_counter() - t_phase}
    emit(readings)

    # Every number is printed above before any is checked.
    for name in ("multiface_2f_smoke_base.json", "multiface_3f_smoke_base.json",
                 "unseen_smoke_base.json", "multiface_2f_r4_intf_smoke.json",
                 "multiface_3f_r4_intf_smoke.json"):
        check(name in artifacts, f"smoke_interference wrote no {name}")
    check(forgetting.is_file() and eval_metrics.is_file(),
          "the launchers' final reports are missing")
    check(child_launches[0] > 0 and child_launches[1] > 0,
          f"the launchers' children launched K1/K2 {child_launches}")
    check(strict_rc == 1 and "venv Python not found" in strict_out,
          f"run_finetune_strict_venv without ./venv: {strict_rc}")
    stages = dict(fwd["stages"], full={"ms": fwd["full_forward_ms"],
                                       "mfu": fwd["full_mfu"]})
    for name, s in stages.items():
        check(s["ms"] > 0 and s["mfu"] is not None and 0 < s["mfu"] <= 1.0,
              f"profile_forward {name}: {s}")
    iters = int(SCRIPTS_FORWARD[3])
    check(per_tool["profile_forward"][1] == 3 * (iters + 1),
          f"profile_forward: K2 {per_tool['profile_forward'][1]} for "
          f"{iters + 1} calls of the artifact, high_freq and full stages")
    check(per_tool["profile_host"][0] == int(SCRIPTS_HOST[3]),
          f"profile_host: K1 {per_tool['profile_host'][0]} for "
          f"{SCRIPTS_HOST[3]} repeats")
    check("crop_device" in host["stage_ms"], f"profile_host: {host}")
    check(int8_ab["max_dprob"] <= 5e-3,
          f"bench_int8 |dprob| {int8_ab['max_dprob']}")
    check(n_int8 > 0 and per_tool["bench_int8"][2] == 24 * n_int8
          and per_tool["bench_int8"][3] == 24 * n_int8,
          f"bench_int8: K3/K4 {per_tool['bench_int8'][2:4]} for {n_int8} "
          "int8 forwards")
    check(fold_ab["max_dprob"] <= 1e-3,
          f"bench_fold |dprob| {fold_ab['max_dprob']}")
    n_eval, n_fold = per_tool["bench_fold"][4], per_tool["bench_fold"][6]
    check(n_fold > 0 and per_tool["bench_fold"][1] == n_eval - n_fold,
          f"bench_fold: K2 {per_tool['bench_fold'][1]} for "
          f"{n_eval - n_fold} unfolded and {n_fold} folded forwards")
    check(all(r["int8_acc_equals_twin"] for r in diag["conv"]["rows"])
          and len(diag["conv"]["rows"]) == len(diagnose_int8.CONV_SHAPES)
          and len(diag["gemm"]["rows"]) == 3
          and len(diag["quant"]["rows"]) == 4,
          "diagnose_int8: K3's accumulators differ from its twin's, or a "
          "stage is short")
    rows = scaling["rows"]
    check([r["batch"] for r in rows] == [32, 1024, 128]
          and "out of memory" in rows[1].get("error", "").lower()
          and all("step_ms" in rows[i] for i in (0, 2)),
          f"bench_train_scaling: {rows}")
    n_predict = 2 * (1 + int(SCRIPTS_CLIPS[1]))
    check(per_tool["bench_predictor"][0] >= n_predict
          and per_tool["bench_predictor"][1] >= n_predict
          and len(predictor["verdicts"]["pipelined"]) == int(SCRIPTS_CLIPS[1]),
          f"bench_predictor: {per_tool['bench_predictor']}")
    for name, res in (("stub", serving_stub), ("model", serving_model)):
        check(res["requests"] == 8 and res["errors"] == 0,
              f"bench_serving {name}: {res}")
    # K1 once per request (and the warm one); K2 once per eval forward,
    # which the coalescing engine shares between concurrent requests.
    served = per_tool["bench_serving_model"]
    check(served[0] >= 9 and 0 < served[1] == served[4]
          and per_tool["bench_serving_stub"][:4] == [0, 0, 0, 0],
          f"bench_serving launches {served}, "
          f"stub {per_tool['bench_serving_stub']}")
    check(len(coalesce["cells"]) == 4
          and all(c["requests"] == 16 for c in coalesce["cells"]),
          f"bench_coalesce_r5: {coalesce['cells']}")
    shutil.rmtree(work, ignore_errors=True)
    return {**launches, "children": dict(zip(
        ("log_mel", "hf_stem", "int8_conv", "int8_quant"), child_launches)),
        "child_seen": child_seen}


# The layer forms of phase 4c: the JAX package's (lo, hi) padding pairs,
# unequal, and its shift_matmul lowering.
UNEQUAL_PAD = ((0, 1), (2, 1), (1, 0))


K5_KERNELS = ("av_stem_kernel",)
# K5 at the AV-HuBERT bulk cell's group (B, T, H, W) and at ragged shapes:
# partial tiles at the bottom and right, odd widths (its pixel-by-pixel
# staging), one frame, frames of a few pixels.
K5_MAIN = (256, 32, 88, 88)
K5_ODD = ((3, 5, 17, 23), (1, 1, 9, 9), (2, 3, 40, 50), (1, 4, 31, 7))
K5_ENGINE_GROUPS = 2


def k5_phase(dev, time_ms) -> dict:
    """Phase 4d: K5 against the module chain it replaces, and its times at
    ``K5_MAIN`` (see the module's docstring). Returns the main shape's
    row, with the launches of this phase's own calls."""
    import torch

    from lipsync_tpu_torch.models.avhubert import ResEncoder
    from lipsync_tpu_torch.ops.kernels import av_stem as k5
    from lipsync_tpu_torch.utils.device import card_peaks

    card = card_peaks(torch.cuda.get_device_name(dev))[1]
    mem_bw, bf16_peak = card.bytes_per_s, card.bf16
    per_sm = {"aligned": k5.blocks_per_sm(True),
              "pixelwise": k5.blocks_per_sm(False)}
    check(min(per_sm.values()) >= 2, f"K5 fits < 2 blocks per SM: {per_sm}")
    gen = torch.Generator().manual_seed(SEED)
    launches_before = k5.launches

    def stem(dyadic):
        enc = ResEncoder()
        conv, bn, prelu, _ = enc.frontend3D
        with torch.no_grad():
            w = (torch.randint(-4, 5, k5.WEIGHT_SHAPE, generator=gen) / 16
                 if dyadic else
                 torch.randn(k5.WEIGHT_SHAPE, generator=gen) / 16)
            conv.weight.copy_(w)
            bn.running_mean.copy_(torch.randn(64, generator=gen) * 0.5)
            bn.running_var.copy_(torch.rand(64, generator=gen) * 2 + 0.05)
            bn.weight.copy_(torch.randn(64, generator=gen) * 0.5 + 1)
            bn.bias.copy_(torch.randn(64, generator=gen) * 0.2)
            prelu.weight.copy_(torch.rand(64, generator=gen) * 0.5)
        conv.to(torch.bfloat16)
        prelu.to(torch.bfloat16)
        return enc.eval().to(dev)

    def pixels(shape, dyadic):
        b, t, h, w = shape
        if dyadic:
            x = torch.randint(-8, 9, (b, 1, t, h, w), generator=gen) / 8
        else:
            x = (torch.rand(b, 1, t, h, w, generator=gen) - 0.421) / 0.165
        return x.to(torch.bfloat16).to(dev)

    exact, rand = stem(True), stem(False)
    exact_ops = k5.operands(exact.frontend3D)
    ops = k5.operands(rand.frontend3D)
    rows = {}
    with torch.inference_mode():
        for shape in (K5_MAIN, *K5_ODD):
            x = pixels(shape, True)
            check(torch.equal(k5.av_stem(x, *exact_ops), exact.frontend3D(x)),
                  f"K5 vs the chain on exact sums at {shape}")
            # Random inputs: the sums' order moves a conv output across a
            # bf16 rounding boundary now and then (the card test's
            # tolerance, av_stem.sum_order_bound).
            x = pixels(shape, False)
            got, want = k5.av_stem(x, *ops), rand.frontend3D(x)
            diff = (got.float() - want.float()).abs()
            del got, want
            used = (diff / k5.sum_order_bound(x, *ops)).max()
            row = {"shape": list(shape), "exact_sums_bit_equal": True,
                   "share_differing": float((diff > 0).float().mean()),
                   "widest_diff": float(diff.max()),
                   "tolerance_used": float(used)}
            del diff
            check(row["share_differing"] <= 1e-3
                  and row["tolerance_used"] <= 1.0,
                  f"K5 vs the chain on random inputs at {shape}: {row}")
            rows[shape] = row
            emit({"phase": "k5_av_stem", **row})

        b, t, h, w = K5_MAIN
        x = pixels(K5_MAIN, False)
        ho, wo = k5.out_size(h), k5.out_size(w)
        hp, wp = k5.out_size(ho), k5.out_size(wo)
        flops = 2 * 245 * 64 * b * t * ho * wo
        n_bytes = 2 * (b * t * h * w + b * t * 64 * hp * wp)
        bound_ms = 1e3 * max(n_bytes / mem_bw, flops / bf16_peak)

        def kernel():
            return k5.av_stem(x, *ops)

        def twin():
            return k5.av_stem_plain(x, *ops)

        def library():  # the chain and the copy into the trunk's frames
            return rand.frontend3D(x).transpose(1, 2).reshape(
                b * t, 64, hp, wp)

        k_ms = time_ms(kernel, iters=10)
        p_ms, l_ms = time_ms(twin, iters=10), time_ms(library, iters=10)
        row = rows[K5_MAIN]
        row.update({
            "blocks_per_sm": per_sm, "gflop": flops / 1e9,
            "mbytes": n_bytes / 1e6, "bound_ms": bound_ms,
            "bound_by": ("bytes" if n_bytes / mem_bw >= flops / bf16_peak
                         else "operations"),
            "bound_basis": "bf16 tensor cores",
            "timer": "cuda events per call, host launch included",
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_share": bound_ms / k_ms,
            "kernel_device_ms": device_ms(kernel, K5_KERNELS, iters=5),
            "library_device_ms": device_ms(library, None, iters=5),
            "tflops": flops / k_ms / 1e9})
        row["device_bound_share"] = bound_ms / row["kernel_device_ms"]
    row["phase_launches"] = k5.launches - launches_before
    emit({"phase": "k5_av_stem_main", **row})
    return row


def k5_engine_phase(dev) -> dict:
    """Phase 4e: K5 on the AV-HuBERT bulk cell's path. ``ScoringEngine``
    with ``AVHubertConfig()`` (LARGE, bf16 on the card, groups of
    ``K5_MAIN[0]``) on seeded weights whose BatchNorm statistics are one
    fp32 training-mode forward's over 32 of the windows scores
    ``K5_ENGINE_GROUPS`` groups of windows made as the cell makes them
    (grey uint8 crops darkened per window, dB log-mel): K5's launch count,
    set to 0 just before, rises by one a group, and the logits lie within
    two bf16 steps (0.03125; the logits are of order 1-4) of the same
    engine's with the module chain in K5's place."""
    import numpy as np
    import torch
    import torch.nn as nn

    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models import avhubert as avhubert_mod
    from lipsync_tpu_torch.models import seeded_state_dict
    from lipsync_tpu_torch.ops.kernels import av_stem as k5

    cfg = avhubert_mod.AVHubertConfig()
    group = K5_MAIN[0]
    n = K5_ENGINE_GROUPS * group
    rng = np.random.default_rng(SEED)
    shape = (n, cfg.video_frames, cfg.crop_size, cfg.crop_size)
    level = rng.integers(64, 257, (n, 1, 1, 1))
    visual = (rng.integers(0, 256, shape) * level // 256).astype(np.uint8)
    mel = (-80 * rng.random((n, cfg.mel_bins, cfg.audio_frames))).astype(
        np.float32)

    model = avhubert_mod.AVHubert(cfg)
    model.load_state_dict(seeded_state_dict(model, SEED))
    model.to(dev)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
            m.momentum = None  # cumulative: one batch gives its statistics
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(visual[:32]).to(dev).float() / 255,
              torch.from_numpy(mel[:32]).to(dev))
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()

    engine = ScoringEngine(weights, cfg, max_batch=group, device=dev)
    k5.launches = 0
    got = engine.score_logits(visual, mel)
    launches = k5.launches
    kernel_takes = avhubert_mod.stem_takes_kernel
    avhubert_mod.stem_takes_kernel = lambda x, module: False
    try:
        want = engine.score_logits(visual, mel)
    finally:
        avhubert_mod.stem_takes_kernel = kernel_takes
    row = {"groups": K5_ENGINE_GROUPS, "windows": n, "launches": launches,
           "chain_launches": k5.launches - launches,
           "logit_gap": float(np.abs(got - want).max()),
           "share_differing": float(np.mean(got != want)),
           "logit_range": [float(want.min()), float(want.max())]}
    del engine
    torch.cuda.empty_cache()
    emit({"phase": "k5_engine", **row})
    check(launches == K5_ENGINE_GROUPS and row["chain_launches"] == 0,
          f"K5 launches on the engine's path: {row}")
    check(row["logit_gap"] <= 0.03125,
          f"AV-HuBERT logits with K5 vs the chain: {row}")
    return row


def layer_forms_phase(dev) -> dict:
    """Phase 4c: the layer forms that the JAX package's building blocks
    take, on the card against the same modules on the CPU (seeded weights):
    ``ConvBNAct`` with ``lowering="shift_matmul"`` (the plain convolution
    at stride 1) and with unequal ``(lo, hi)`` padding pairs (padded
    explicitly, then a convolution without padding), ``ResidualBlockND``
    with the lowering (3-d with the 1x1 shortcut, 2-d without), and
    ``max_pool_same`` at unequal pairs and past half its window (padded
    with -inf). In float64 within 1e-6: the same function; in fp32 (TF32
    off) within 1e-5, the JAX package's bound for the shift_matmul
    lowering: cuDNN and the CPU sum a convolution's products in other
    orders, a few fp32 steps apart at outputs of a few units."""
    import torch

    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.models import seeded_state_dict

    gen = torch.Generator().manual_seed(SEED)
    modules = {
        "conv_shift_matmul": (lambda: layers_mod.ConvBNAct(
            8, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1), bias=True,
            lowering="shift_matmul"), (2, 8, 8, 12, 12)),
        "conv_unequal_pairs": (lambda: layers_mod.ConvBNAct(
            4, 16, (3, 3, 3), (1, 2, 2), UNEQUAL_PAD, bias=True),
            (2, 4, 6, 13, 11)),
        "conv_unequal_pairs_shift_matmul": (lambda: layers_mod.ConvBNAct(
            4, 16, (3, 3, 3), (1, 1, 1), UNEQUAL_PAD, bias=True,
            lowering="shift_matmul"), (2, 4, 6, 13, 11)),
        "residual_shift_matmul": (lambda: layers_mod.ResidualBlockND(
            8, 16, (3, 3, 3), (1, 1, 1), lowering="shift_matmul"),
            (2, 8, 6, 6, 6)),
        "residual_2d_shift_matmul": (lambda: layers_mod.ResidualBlockND(
            8, 8, (3, 3), (1, 1), lowering="shift_matmul"), (2, 8, 20, 16)),
    }
    pools = {"pool_unequal_3d": ((2, 3, 5, 9, 8), (2, 3, 3), (1, 2, 2),
                                 UNEQUAL_PAD),
             "pool_unequal_2d": ((2, 4, 9, 10), (3, 3), (2, 2),
                                 ((0, 2), (1, 0))),
             "pool_past_half_window": ((2, 3, 7, 7), (3, 3), (2, 2),
                                       ((2, 2), (1, 1)))}
    rows = {}
    for name, (make, shape) in modules.items():
        module = make().eval()
        module.load_state_dict(seeded_state_dict(module, SEED))
        x = torch.randn(*shape, generator=gen)
        row = {"x": list(shape)}
        for dt in (torch.float32, torch.float64):
            module.to("cpu", dt)
            with torch.no_grad():
                want = module(x.to(dt))
                got = module.to(dev)(x.to(dev, dt)).cpu()
            row["out"] = list(got.shape)
            row[f"max_abs_vs_cpu_{str(dt)[6:]}"] = float(
                (got - want).abs().max())
        rows[name] = row
    for name, (shape, window, strides, padding) in pools.items():
        x = torch.randn(*shape, generator=gen)
        row = {"x": list(shape)}
        for dt in (torch.float32, torch.float64):
            want = layers_mod.max_pool_same(x.to(dt), window, strides,
                                            padding)
            got = layers_mod.max_pool_same(x.to(dev, dt), window, strides,
                                           padding).cpu()
            row["out"] = list(got.shape)
            row[f"max_abs_vs_cpu_{str(dt)[6:]}"] = float(
                (got - want).abs().max())
        rows[name] = row
    emit({"phase": "layer_forms", "rows": rows})
    for name, r in rows.items():
        check(r["max_abs_vs_cpu_float64"] <= 1e-6
              and r["max_abs_vs_cpu_float32"] <= 1e-5,
              f"layer form {name}: card vs CPU {r}")
    return rows


def zero_counts() -> None:
    """Every kernel's launch count set to 0."""
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1

    k1.launches = k2.launches = k3.launches = k4.launches = 0


def counts() -> dict:
    """Every kernel's launch count, by the name of the kernels line."""
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1

    return {"log_mel": k1.launches, "hf_stem": k2.launches,
            "int8_conv": k3.launches, "int8_quant": k4.launches}


def root_bench_keys() -> set:
    """The keys of the JSON line that the repo's root ``bench.py`` (the
    JAX driver) prints, read with ``ast``: the dict literal with a
    ``"metric"`` key and the one nested in it."""
    import ast

    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return {k.value for sub in ast.walk(node)
                    if isinstance(sub, ast.Dict) for k in sub.keys
                    if isinstance(k, ast.Constant)}
    raise RuntimeError("no printed dict in bench.py")


def smi_query(query: str, fields: str) -> list:
    """``nvidia-smi --query-<query>=<fields>`` as lists of strings."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-{query}={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [[v.strip() for v in ln.split(",")]
            for ln in out.strip().splitlines() if ln.strip()]


def bench_phase(dev, record) -> dict:
    """Phase 13b: the port's benchmark driver, ``tools/bench.py::run``, in
    this process at the root driver's card sizes (``bench.CARD``: the model
    path at 1024 windows, the engine under its pinned 4 x 128-window
    payload, the track and shared paths, the train step at batch 32). Its
    dict is this phase's line; a second line gives the seconds, peak
    memory and launches of each path (read at each of ``run``'s progress
    marks, with the allocator's retries and the card's clock, power and
    temperature there), and what shares the card as the phase starts, after
    a garbage collection (free memory, the processes on it, this process's
    threads). Checks: the keys
    are the root driver's less ``note``, every number finite, ``platform``
    "cuda"; K2 launched on the model, engine, track and shared paths and by
    no train step; no other kernel launched."""
    import gc
    import math
    import threading

    import torch

    from lipsync_tpu_torch.models import ModelConfig
    from lipsync_tpu_torch.tools import bench

    marks = []

    def progress(msg):
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        marks.append((msg, time.perf_counter(), counts(),
                      torch.cuda.max_memory_allocated() / 1e9,
                      {k: stats.get(k, 0) for k in ("num_alloc_retries",
                                                    "num_ooms")},
                      smi_query("gpu", "clocks.sm,power.draw,"
                                       "temperature.gpu")[0]))
        torch.cuda.reset_peak_memory_stats()
        bench._progress(msg)

    before_gc = torch.cuda.memory_allocated() / 1e9
    gc.collect()  # cycles left by earlier phases that hold device tensors
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    sharing = {"allocated_gb_before_gc": before_gc,
               "free_gb": free / 1e9, "total_gb": total / 1e9,
               "reserved_gb": torch.cuda.memory_reserved() / 1e9,
               "allocated_gb": torch.cuda.memory_allocated() / 1e9,
               "compute_apps": smi_query("compute-apps",
                                         "pid,used_memory"),
               "threads": sorted(t.name for t in threading.enumerate())}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with record():
        out = bench.run(ModelConfig(), dev, bench.CARD, progress=progress)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    emit({"phase": "bench", **out})
    paths = {}
    for (name, t_a, c_a, _, r_a, _), (_, t_b, c_b, peak, r_b, smi) in zip(
            marks, marks[1:]):
        paths[name] = {"seconds": t_b - t_a, "peak_gb": peak,
                       "launches": {k: c_b[k] - c_a[k] for k in c_a},
                       "allocator": {k: r_b[k] - r_a[k] for k in r_a},
                       "sm_mhz_w_c_at_end": smi}
    emit({"phase": "bench_paths", "seconds": seconds, "paths": paths,
          "launches": launches, "sharing_at_start": sharing})
    check(set(out) == root_bench_keys() - {"note"},
          f"bench keys differ from the root driver's: {sorted(out)}")
    bad = [k for k, v in out.items() if isinstance(v, (int, float))
           and not math.isfinite(v)]
    check(not bad, f"bench: non-finite {bad}")
    check(out["platform"] == "cuda" and out["dtype"] == "bfloat16"
          and out["model_batch"] == bench.CARD.model_batch
          and out["engine_batch"] == 128,
          f"bench: {out['platform']} {out['dtype']} {out['model_batch']}")
    for name in ("single-window path", "batch path", "engine path",
                 "track gather path", "track shared-encoding path"):
        check(paths[name]["launches"]["hf_stem"] >= 1,
              f"bench {name} launched no K2: {paths[name]}")
    check(paths["train step"]["launches"]["hf_stem"] == 0,
          f"a bench train step launched K2: {paths['train step']}")
    check(launches["log_mel"] == launches["int8_conv"]
          == launches["int8_quant"] == 0, f"bench launches: {launches}")
    return launches


def graft_phase(dev, plain_kernels, record) -> dict:
    """Phase 13c: the port's entry points, ``tools/graft_entry.py``.
    ``entry()``'s fp32 forward of ``ModelConfig()`` at batch 8 on its
    example (zero) inputs and on a seeded batch of the same shapes, each
    within 1e-3 of the same forward with the twins in the kernels' places;
    then ``dryrun_multichip(2)``: its train step on two gloo ranks on the
    CPU (one card: NCCL refuses two ranks on it), and its serving paths
    over ``[cuda:0, cuda:0]`` within 2e-5 of one device (ragged
    ``score_logits`` and ``dispatch_track_logits``) and 1e-4 (shared
    encoding). K2 launched by both; no other kernel."""
    import numpy as np
    import torch

    from lipsync_tpu_torch.tools import graft_entry

    fn, (visual, audio) = graft_entry.entry()
    rng = np.random.RandomState(SEED)
    seeded = (torch.from_numpy(rng.rand(*visual.shape).astype(np.float32))
              .to(dev),
              torch.from_numpy((rng.rand(*audio.shape) * 80 - 80)
                               .astype(np.float32)).to(dev))
    zero_counts()
    t0 = time.perf_counter()
    with record():
        logits = [fn(visual, audio), fn(*seeded)]
        torch.cuda.synchronize()
        entry_launches = counts()
        report = graft_entry.dryrun_multichip(2)
    seconds = time.perf_counter() - t0
    launches = counts()
    with plain_kernels():
        plain = [fn(visual, audio), fn(*seeded)]
    check(counts() == launches, "the twin forward launched a kernel")
    entry_rows = {
        name: {"shape": list(got.shape),
               "finite": bool(torch.isfinite(got).all()),
               "max_abs_vs_twins": float((got - want).abs().max())}
        for name, got, want in zip(("example_inputs", "seeded_batch"),
                                   logits, plain)}
    out = {"entry": entry_rows, "entry_launches": entry_launches,
           "dryrun_multichip": report, "launches": launches,
           "seconds": seconds}
    emit({"phase": "graft", **out})
    for name, r in entry_rows.items():
        check(r["shape"] == [8] and r["finite"]
              and r["max_abs_vs_twins"] <= 1e-3, f"entry {name}: {r}")
    step, serving = report["train_step"], report["serving"]
    check(step["backend"] == "gloo" and step["step"] == 1
          and np.isfinite(step["loss"]), f"dryrun train step: {step}")
    check(serving["devices"] == ["cuda:0", "cuda:0"]
          and serving["score_logits"]["max_abs_vs_one_device"] <= 2e-5
          and serving["dispatch_track_logits"]["max_abs_vs_one_device"]
          <= 2e-5
          and serving["shared_score_track_logits"]["max_abs_vs_one_device"]
          <= 1e-4, f"dryrun serving: {serving}")
    check(entry_launches["hf_stem"] == 2
          and launches["hf_stem"] > entry_launches["hf_stem"]
          and launches["log_mel"] == launches["int8_conv"]
          == launches["int8_quant"] == 0, f"graft launches: {launches}")
    return launches


def world_of_one(work: Path) -> None:
    """The child of phase 10 (c), started by ``torch.distributed.run`` with
    one process: join its NCCL group, then one host-fed and one
    device-cache train step through the group against the same step without
    it (on one activation pattern), a short ``run_training`` and
    ``run_finetune`` through the group, and step times with and without
    it. Writes ``world_of_one.json`` into ``work``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
    from lipsync_tpu_torch.models import seeded_state_dict
    from lipsync_tpu_torch.parallel import mesh as mesh_lib
    from lipsync_tpu_torch.training import finetune as finetune_mod
    from lipsync_tpu_torch.training import steps
    from lipsync_tpu_torch.training import train as train_mod
    from lipsync_tpu_torch.training.data import BatchLoader, LipSyncDataset
    from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache
    from lipsync_tpu_torch.utils import synthetic

    from lipsync_tpu_torch.utils.device import disable_tf32

    dev = mesh_lib.join_from_environment("cuda")
    shard = mesh_lib.process_shard()
    disable_tf32()  # the steps below run as run_training runs them
    out = {"backend": dist.get_backend(), "world": shard.world,
           "rank": shard.rank, "device": str(dev)}
    # The cost of one small collective here: what every BatchNorm of a
    # group step pays twice per forward it runs (once forward, once back).
    x = torch.zeros(513, device=dev)
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t0) / 200 * 1e6
    cfg = ModelConfig()
    corpus = synthetic.write_corpus(work / "corpus", n_clips=16,
                                    n_frames=CORPUS_FRAMES,
                                    crop_size=cfg.crop_size, seed=SEED,
                                    device=dev)
    dataset = LipSyncDataset(preprocessed_dir=corpus,
                             video_frames=cfg.video_frames,
                             audio_frames=cfg.audio_frames,
                             uint8_visual=True, device=dev)
    host = next(iter(BatchLoader(dataset, batch_size=4, shuffle=False,
                                 train_mode_override=True)))
    host = mesh_lib.pad_batch_to_multiple(host, shard.world)
    cache = DeviceDatasetCache(dataset, mesh=shard, device=dev)
    cached = next(iter(cache.batches(range(16), 4,
                                     rng=np.random.RandomState(SEED))))
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    weights = seeded_state_dict(LipSyncModel(cfg0), SEED)
    zero = conv_biases_before_batchnorm(LipSyncModel(cfg0))

    def step_once(group, batch, tape, replay):
        model = LipSyncModel(cfg0)
        model.load_state_dict(weights)
        model.to(dev)
        state = steps.create_train_state(model, SGD1(model), SEED, group)
        seen = {}
        with activation_pattern(tape, replay, seen):
            metrics = steps.make_train_step(steps.LossConfig())(
                state, train_mod.to_device(batch, dev), shift=5)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()},
                {n: b.detach().cpu() for n, b in model.named_buffers()
                 if "running" in n}, seen)

    out["parity"] = {}
    for feed, batch in (("host_fed", host), ("device_cache", cached)):
        tape = []
        alone = step_once(None, batch, tape, False)
        grouped = step_once(shard, batch, tape, True)
        grad_rel = {n: float((grouped[1][n] - g).abs().max()
                             / g.abs().max())
                    for n, g in alone[1].items() if n not in zero}
        worst = sorted(((v, n) for n, v in grad_rel.items()),
                       reverse=True)[:5]
        out["parity"][feed] = {
            "metric_rel": {k: abs(grouped[0][k] - v) / max(abs(v), 1e-6)
                           for k, v in alone[0].items()},
            "stat_rel_max": max(
                float((grouped[2][n] - s).abs().max()
                      / max(1.0, float(s.abs().max())))
                for n, s in alone[2].items()),
            "grad_rel_max": worst[0][0], "grad_rel_worst5": worst,
            "replay": grouped[3], "zero_grads": len(zero)}

    # Step times at batch 8 from the device cache, with and without the
    # group, full width, fp32, TF32 off: median of 5 warm steps, in turns
    # (group, none, none, group); then one profiled group step.
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer

    def stepper(group):
        model = LipSyncModel(cfg).to(dev)
        state = steps.create_train_state(
            model, PhaseOptimizer(model.named_parameters(), 3, 1e-4, 1e-5),
            SEED, group)
        step = steps.make_train_step(steps.LossConfig())
        batch = next(iter(cache.batches(range(16), 8,
                                        rng=np.random.RandomState(SEED))))
        return lambda: step(state, batch)

    def step_ms(run):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    runs = {"group_of_one": stepper(shard), "no_group": stepper(None)}
    out["step_ms_batch8"] = {k: [] for k in runs}
    for name in ("group_of_one", "no_group", "no_group", "group_of_one"):
        out["step_ms_batch8"][name].append(step_ms(runs[name]))
    from torch.profiler import ProfilerActivity, profile

    for name, run in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        nccl = sum(e.self_device_time_total for e in kernels
                   if "nccl" in e.key.lower()) / 1e3
        out.setdefault("step_profile", {})[name] = {
            "wall_ms": wall, "device_busy_ms": busy, "nccl_ms": nccl,
            "device_kernels": sum(e.count for e in kernels),
            "all_reduce_calls": sum(e.count for e in prof.key_averages()
                                    if e.key == "c10d::allreduce_")}
    del runs

    geometry = ["--video-frames", str(cfg.video_frames),
                "--crop-size", str(cfg.crop_size),
                "--audio-frames", str(cfg.audio_frames)]
    base = ["--preprocessed-dir", str(corpus), "--batch-size", "8",
            "--max-steps-per-epoch", "2", *geometry]
    out["histories"], out["seconds"], out["tf32_after"] = {}, {}, {}
    out["peak_gib"] = {}
    for name, entry, args in (
            ("run_training", train_mod.run_training,
             train_mod.build_argparser().parse_args(
                 base + ["--output-dir", str(work / "w"), "--epochs", "1",
                         "--device-cache"])),
            ("run_finetune", finetune_mod.run_finetune,
             finetune_mod.build_argparser().parse_args(
                 base + ["--output-dir", str(work / "ft"), "--epochs", "1",
                         "--checkpoint", str(work / "w" / "latest")]))):
        tf32_on()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out["histories"][name] = entry(args, device=dev)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["peak_gib"][name] = torch.cuda.max_memory_allocated(dev) / 2**30
        out["tf32_after"][name] = tf32_flags()
    (work / "world_of_one.json").write_text(json.dumps(out))
    mesh_lib.leave_group()


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--world-of-one"]:  # phase 10's child
        world_of_one(Path(sys.argv[2]))
        return
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
    from lipsync_tpu_torch.models import layers as layers_mod
    from lipsync_tpu_torch.ops.kernels import hf_stem as k2
    from lipsync_tpu_torch.ops.kernels import int8_conv as k3
    from lipsync_tpu_torch.ops.kernels import int8_quant as k4
    from lipsync_tpu_torch.ops.kernels import mel as k1
    from lipsync_tpu_torch.preprocessing import audio as audio_mod
    from lipsync_tpu_torch.preprocessing.video import crop_track_on_device
    from lipsync_tpu_torch.utils import synthetic

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peak_key, (mem_bw, fp32_peak, tf32_peak, int8_peak) = peaks(kind)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_of": peak_key,
          "tf32_at_start": tf32_flags()})

    # The script sets no precision switch itself: the entry points turn
    # TF32 off (utils/device.disable_tf32), and every phase runs with what
    # they set. load_engine is the first entry point called.
    from lipsync_tpu_torch.inference.engine import load_engine

    tf32_on()
    small = ModelConfig(visual_feature_dim=64, audio_feature_dim=64,
                        embed_dim=64, video_frames=8, crop_size=32,
                        audio_frames=32)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(LipSyncModel(small).state_dict(), Path(tmp) / "w.pth")
        load_engine(Path(tmp) / "w.pth", small, device=dev)
    emit({"phase": "tf32_entry_points",
          "after_load_engine": tf32_flags()})
    check(tf32_flags() == {"cudnn": False, "matmul": False},
          f"load_engine left TF32 on: {tf32_flags()}")

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
    serialized = [ln for log in logs.values() for ln in log.splitlines()
                  if "wgmma" in ln and "serializ" in ln]
    check(not serialized, f"ptxas serialised wgmma: {serialized}")
    check(k2.blocks_per_sm(torch.bfloat16) >= 2
          and k2.blocks_per_sm(torch.float32) >= 2,
          "K2 fits fewer than 2 blocks per SM")

    def bound_ms(n_bytes: float, flops: float, basis: str = SIMT):
        t_bytes = n_bytes / mem_bw
        t_ops = flops / {TENSOR: tf32_peak, INT8: int8_peak}.get(basis,
                                                                 fp32_peak)
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

    k1_rows = {}
    checked = {"log_mel": set(), "hf_stem": set(), "int8_conv": set(),
               "int8_quant": set()}
    for n in (16384, 32768, 65536, 262144, 1 << 20):
        y2 = torch.from_numpy(synthetic.pcm(rng, n)).to(dev)[None]
        t = k1.n_frames_for(n)
        got = k1.finish_db(k1.log_mel_db(y2))
        want = k1.finish_db(k1.log_mel_db_plain(y2))
        lib = mel_ops.log_mel_spectrogram(y2[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_lib = float((got[0] - lib).abs().max())
        check(err < 1e-3, f"K1 vs twin at n={n}: {err} dB")
        checked["log_mel"].add(k1_key(y2))
        flops = k1_flops(t, k1.N_FFT, support)
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
    for n in K1_EXTRA_SAMPLES:  # held against the twin, untimed
        y2 = torch.from_numpy(synthetic.pcm(rng, n)).to(dev)[None]
        err = float((k1.finish_db(k1.log_mel_db(y2))
                     - k1.finish_db(k1.log_mel_db_plain(y2))).abs().max())
        check(err < 1e-3, f"K1 vs twin at n={n}: {err} dB")
        checked["log_mel"].add(k1_key(y2))
        emit({"phase": "k1_mel", "n": n, "max_abs_err_db": err})

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
    ref = mel_float64(yq)
    quiet = {"kernel_vs_f64_db": float(np.abs(got - ref).max()),
             "twin_vs_f64_db": float(np.abs(twin - ref).max())}
    emit({"phase": "k1_quiet_band", "n": n, **quiet})
    check(quiet["kernel_vs_f64_db"] <= quiet["twin_vs_f64_db"] + 2e-4,
          f"K1 rounds worse than its twin at quiet bands: {quiet}")
    check(quiet["kernel_vs_f64_db"] <= 2.5e-3,
          f"K1 rounds past the fp32 floor at quiet bands: {quiet}")

    # ── 3b. K1 at every parameter set; the routes around it ──────────
    k1_sets = k1_param_phase(dev, rng, time_ms, in_turns, bound_ms, checked)

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
        against the fp32 result on the same (bf16) input (<= 1 passes).
        Each dtype's outputs are freed before the next (the bench's batch
        of 1024 has 9.7 GB of fp32 output)."""
        v16 = video.to(torch.bfloat16)
        got = k2.hf_stem(video, *stem_args)
        want = k2.hf_stem_plain(video, *stem_args)
        err32 = float((got - want).abs().max())
        del got, want
        got16 = k2.hf_stem(v16, *stem_args).float()
        want16 = k2.hf_stem_plain(v16.float(), *stem_args)
        torch.cuda.synchronize()
        err16 = (got16 - want16).abs_()
        del got16
        err16_max = float(err16.max())
        used16 = float((err16 / (8e-3 * want16.abs() + 1e-5)).max())
        del err16, want16
        shape = tuple(video.shape)
        check(err32 <= 2e-5, f"K2 fp32 vs twin at {shape}: {err32}")
        check(used16 <= 1.0, f"K2 bf16 vs fp32 result at {shape}: "
                             f"tolerance used {used16}")
        checked["hf_stem"].update({shape_key(video), shape_key(v16)})
        return err32, err16_max, used16

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

    # An odd shape with partial output tiles, the refinement's three half
    # windows of clip S (phase 6) in their bucket of 4 and in its halves on
    # two shards (phase 10), the training phases' validation batches
    # (phases 7 and 12) and the serving phase's warmup and coalesced
    # buckets (phase 8).
    for shape in ((2, 4, 15, 10, 3), (4, 16, 96, 96, 3), (2, 16, 96, 96, 3),
                  (VAL_CLIPS, 32, 96, 96, 3), (TOOLS_VAL_CLIPS, 32, 96, 96, 3),
                  *((b, 32, 96, 96, 3) for b in K2_EXTRA_BATCHES),
                  *GRAFT_K2_SHAPES):
        video = torch.rand(*shape, generator=gen).to(dev)
        err32, _, used16 = k2_errors(video)
        emit({"phase": "k2_hf_stem", "shape": list(shape),
              "max_abs_err": err32, "bf16_tolerance_used": used16})
        del video
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
        audio_mod.log_mel_spectrogram_fused = plain_log_mel
        artifact_mod.hf_stem = k2.hf_stem_plain
        try:
            with plain_int8():
                yield
        finally:
            audio_mod.log_mel_spectrogram_fused, artifact_mod.hf_stem = saved

    @contextlib.contextmanager
    def plain_int8():
        """The int8 lowering with the twins in K3's and K4's places."""
        saved = (layers_mod.int8_conv_dequant, layers_mod.int8_conv_int32,
                 layers_mod.absmax, layers_mod.quantize,
                 layers_mod.absmax_quantize)
        layers_mod.int8_conv_dequant = k3.int8_conv_dequant_plain
        layers_mod.int8_conv_int32 = k3.int8_conv_plain
        layers_mod.absmax = k4.absmax_plain
        layers_mod.quantize = k4.quantize_plain
        layers_mod.absmax_quantize = k4.absmax_quantize_plain
        try:
            yield
        finally:
            (layers_mod.int8_conv_dequant, layers_mod.int8_conv_int32,
             layers_mod.absmax, layers_mod.quantize,
             layers_mod.absmax_quantize) = saved

    def track_inputs(req):
        """A track request's crops and aligned mel windows, as ``serve``
        makes them."""
        frames, boxes, y, _ = req
        crops = crop_track_on_device(frames, boxes, 0, cfg.crop_size)
        mel = audio_mod.preprocess_audio_pcm(y)
        n = len(crops)
        return crops, np.stack([
            align_audio_chunk(mel, s, n, cfg.audio_frames, cfg.video_frames)
            for s in range(0, n - cfg.video_frames + 1, STRIDE)])

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

    # ── 4b. K3 vs its twin at every int8 encoder convolution ──────────
    k3_rows, k3_summary = k3_phase(dev, cfg, seeded, time_ms, bound_ms,
                                   checked, plain_int8)

    # ── 4c. the layer forms: shift_matmul, (lo, hi) padding pairs ─────
    layer_forms_phase(dev)

    # ── 4d. K5, AV-HuBERT's 3D stem, vs the module chain ──────────────
    torch.cuda.empty_cache()
    k5m = k5_phase(dev, time_ms)
    torch.cuda.empty_cache()

    # ── 4e. K5 on the AV-HuBERT bulk cell's path ──────────────────────
    k5e = k5_engine_phase(dev)

    engines = {name: (ScoringEngine(w, cfg),  # bf16 on CUDA by default
                      ScoringEngine(w, cfg, use_bfloat16=False))
               for name, w in weight_sets.items()}
    eng16, eng32 = engines["bn_calibrated"]
    check(eng16.model.dtype == torch.bfloat16, "served engine is not bf16")

    # The main path: every count set to 0, the three requests served once.
    seen = {}
    k1.launches = k2.launches = 0
    served, per_request = {}, {}
    with kernel_inputs(seen):
        for name, req in requests.items():
            before = (k1.launches, k2.launches)
            served[name] = serve(eng16, *req)
            torch.cuda.synchronize()
            per_request[name] = (k1.launches - before[0],
                                 k2.launches - before[1])
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

    # ── 5b. the engine's streaming and transfer options on R2 ─────────
    engine_options_phase(
        dev, cfg, weight_sets["bn_calibrated"], eng32,
        track_inputs(requests["R2"]))

    # ── 6. the predictor: a clip in, a verdict out ────────────────────
    predictor_launches = predictor_phase(
        eng16, eng32, cfg, profile_served, plain_kernels,
        lambda: kernel_inputs(seen))

    # ── 7. the trainer ────────────────────────────────────────────────
    torch.cuda.empty_cache()
    training_launches = training_phase(
        dev, cfg, profile_served, lambda: kernel_inputs(seen))

    # ── 8. the HTTP service ───────────────────────────────────────────
    torch.cuda.empty_cache()
    serving_launches = serving_phase(dev, cfg, weight_sets["bn_calibrated"],
                                     lambda: kernel_inputs(seen))

    # ── 9. the single-card options ────────────────────────────────────
    option_launches = options_phase(
        dev, cfg, weight_sets, requests, serve, eng32, engines["seeded"][1],
        track_inputs, plain_int8, lambda: kernel_inputs(seen))

    # ── 10. data parallelism ──────────────────────────────────────────
    torch.cuda.empty_cache()
    dp_launches = data_parallel_phase(
        dev, cfg, weight_sets["bn_calibrated"], requests, track_inputs,
        lambda: kernel_inputs(seen))

    # ── 11. the modules that complete the port ────────────────────────
    torch.cuda.empty_cache()
    completion_launches = completion_phase(dev, cfg, eng32, smi,
                                           lambda: kernel_inputs(seen))

    # ── 12. the operational tools ─────────────────────────────────────
    torch.cuda.empty_cache()
    tools_launches = tools_phase(dev, cfg, smi, lambda: kernel_inputs(seen))

    # ── 13. the evaluation harnesses and the diagnostics ──────────────
    torch.cuda.empty_cache()
    evaluation_launches = evaluation_phase(
        dev, cfg, smi, weight_sets["bn_calibrated"],
        lambda: kernel_inputs(seen))

    # ── 13b. the benchmark driver (before phase 14: see its docstring) ─
    torch.cuda.empty_cache()
    bench_launches = bench_phase(dev, lambda: kernel_inputs(seen))

    # ── 13c. the entry points and the multi-device dry run ────────────
    torch.cuda.empty_cache()
    graft_launches = graft_phase(dev, plain_kernels,
                                 lambda: kernel_inputs(seen))

    # ── 14. the scripts tier: launchers, profilers, benchmarks ─────────
    torch.cuda.empty_cache()
    scripts_launches = scripts_phase(dev, cfg, smi,
                                     weight_sets["bn_calibrated"],
                                     lambda: kernel_inputs(seen))
    for name, keys in scripts_launches.pop("child_seen").items():
        seen.setdefault(name, set()).update(keys)

    # Every input shape that the main runs gave a kernel was checked above.
    unchecked = {name: sorted(shapes - checked[name])
                 for name, shapes in seen.items()}
    emit({"phase": "main_path_shapes",
          "seen": {name: sorted(v) for name, v in seen.items()},
          "unchecked": unchecked})
    check(not any(unchecked.values()),
          f"main-path kernel inputs not held against the twin: {unchecked}")

    # ── 15. kernels ───────────────────────────────────────────────────
    r1_n = 1 << (len(requests["R1"][2]) - 1).bit_length()
    m = k1_rows[max(r1_n, 1 << 14)]
    k2m = k2_rows[16]  # R2's bucket, fp32 as in the earlier slice
    # K3 at R2's bucket, on the encoder convolution with the most work (the
    # visual stem, on the halo loop), and on the wgmma geometry with the
    # most work.
    k3_16 = [r for (_, b), r in k3_rows.items() if b == 16]
    k3m, k3w = (max(rows, key=lambda r: r["m"] * r["n"] * r["k"])
                for rows in (k3_16, [r for r in k3_16
                                     if r["main_loop"] == "wgmma"]))

    def k3_device(r):
        """K3's profiler times in row ``r`` (the kernels line's ``device``),
        with the bound's share of the int32 entry's."""
        return {"timer": "torch.profiler kernel time",
                "ms": r["device_ms"], "bound_share": r["device_bound_share"],
                **{k: r[f"{k}_device_ms"] for k in (
                    "plain", "int_mm", "bf16_cudnn", "fused_float32",
                    "fused_bfloat16")},
                "fused_float32_bound_ms": r["fused_float32_bound_ms"]}

    emit({"kernels": [
        {"name": "log_mel", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/mel.cu",
         "replaces": "lipsync_tpu/ops/pallas/mel_kernel.py:65",
         "launches": main_launches["log_mel"],
         "launches_predictor": predictor_launches["log_mel"],
         "launches_training": training_launches["log_mel"],
         "launches_serving": serving_launches["log_mel"],
         "launches_options": option_launches["log_mel"],
         "launches_data_parallel": dp_launches["log_mel"],
         "launches_data_parallel_by_device":
             dp_launches["by_device"]["log_mel"],
         "launches_completion": completion_launches["log_mel"],
         "launches_tools": tools_launches["log_mel"],
         "launches_evaluation": evaluation_launches["log_mel"],
         "launches_scripts": scripts_launches["log_mel"],
         "launches_scripts_children":
             scripts_launches["children"]["log_mel"],
         "launches_bench": bench_launches["log_mel"],
         "launches_graft": graft_launches["log_mel"],
         "max_abs_err": m["max_abs_err_db"], "ms": m["kernel_ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "bound_basis": m["bound_basis"],
         "library_ms": m["library_ms"],
         # phase 3b: every parameter set at 65536 samples; at the defaults
         # the fixed kernel (n_fft = 400 at compile time) against the
         # run-time-sized one, in turns
         "param_sets": [
             {"set": r["set"], "params": r["params"],
              "max_abs_err": r["max_abs_err_db"], "ms": r["kernel_ms"],
              "device_ms": r["kernel_device_ms"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
             for r in k1_sets["rows"]],
         "defaults_fixed_ms": k1_sets["rows"][0]["fixed_ms"],
         "defaults_general_ms": k1_sets["rows"][0]["general_ms"],
         "defaults_general_device_ms":
             k1_sets["rows"][0]["general_device_ms"]},
        {"name": "hf_stem", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/hf_stem.cu",
         "replaces": "lipsync_tpu/ops/pallas/hf_stem.py:174",
         "launches": main_launches["hf_stem"],
         "launches_predictor": predictor_launches["hf_stem"],
         "launches_training": training_launches["hf_stem"],
         "launches_serving": serving_launches["hf_stem"],
         "launches_options": option_launches["hf_stem"],
         "launches_data_parallel": dp_launches["hf_stem"],
         "launches_data_parallel_by_device":
             dp_launches["by_device"]["hf_stem"],
         "launches_completion": completion_launches["hf_stem"],
         "launches_tools": tools_launches["hf_stem"],
         "launches_evaluation": evaluation_launches["hf_stem"],
         "launches_scripts": scripts_launches["hf_stem"],
         "launches_scripts_children":
             scripts_launches["children"]["hf_stem"],
         "launches_bench": bench_launches["hf_stem"],
         "launches_graft": graft_launches["hf_stem"],
         # under the fold (one cuDNN conv in K2's place): checked to be 0
         "launches_fold": option_launches["hf_stem_fold"],
         "max_abs_err": k2m["max_abs_err"], "ms": k2m["kernel_ms"],
         "plain_ms": k2m["plain_ms"], "bound_ms": k2m["bound_ms"],
         "bound_by": k2m["bound_by"], "bound_basis": k2m["bound_basis"],
         "library_ms": None},
        {"name": "int8_conv", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/int8_conv.cu",
         # no Pallas counterpart: the XLA int8 conv of Int8Conv
         "replaces": "lipsync_tpu/models/layers.py:140",
         "launches": option_launches["int8_conv"],
         "launches_per_forward": option_launches["int8_conv_per_forward"],
         "launches_data_parallel": dp_launches["int8_conv"],
         "launches_data_parallel_by_device":
             dp_launches["by_device"]["int8_conv"],
         "launches_completion": completion_launches["int8_conv"],
         "launches_tools": tools_launches["int8_conv"],
         "launches_evaluation": evaluation_launches["int8_conv"],
         "launches_scripts": scripts_launches["int8_conv"],
         "launches_scripts_children":
             scripts_launches["children"]["int8_conv"],
         "launches_bench": bench_launches["int8_conv"],
         "launches_graft": graft_launches["int8_conv"],
         "shape": {k: k3m[k] for k in ("x", "w", "stride", "padding",
                                       "main_loop")},
         # ms, plain_ms and library_ms per call from CUDA events on the
         # int32 entry, as K1 and K2 above; the profiler's kernel times of
         # the same calls and of the dequantizing entries under "device"
         "timer": "cuda events per call, host launch included",
         "max_abs_err": k3m["max_abs_err"], "ms": k3m["kernel_ms"],
         "plain_ms": k3m["plain_ms"], "bound_ms": k3m["bound_ms"],
         "bound_by": k3m["bound_by"], "bound_basis": k3m["bound_basis"],
         "library_ms": k3m["int_mm_ms"],
         "library": "im2col + torch._int_mm (cuBLASLt int8, int32 out)",
         "bf16_cudnn_ms": k3m["bf16_cudnn_ms"],
         "fused_float32_ms": k3m["fused_float32_ms"],
         "fused_bfloat16_ms": k3m["fused_bfloat16_ms"],
         "device": k3_device(k3m),
         "wgmma": {**{k: k3w[k] for k in (
             "x", "w", "stride", "padding", "kernel_ms", "plain_ms",
             "bound_ms", "int_mm_ms", "bf16_cudnn_ms", "fused_float32_ms",
             "fused_bfloat16_ms")}, "device": k3_device(k3w)}},
        {"name": "int8_quant", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/int8_quant.cu",
         # no Pallas counterpart: the XLA elementwise quantize of Int8Conv
         "replaces": "lipsync_tpu/models/layers.py:132",
         "launches": option_launches["int8_quant"],
         "launches_per_forward": option_launches["int8_quant_per_forward"],
         "launches_data_parallel": dp_launches["int8_quant"],
         "launches_data_parallel_by_device":
             dp_launches["by_device"]["int8_quant"],
         "launches_completion": completion_launches["int8_quant"],
         "launches_tools": tools_launches["int8_quant"],
         "launches_evaluation": evaluation_launches["int8_quant"],
         "launches_scripts": scripts_launches["int8_quant"],
         "launches_scripts_children":
             scripts_launches["children"]["int8_quant"],
         "launches_bench": bench_launches["int8_quant"],
         "launches_graft": graft_launches["int8_quant"],
         # the single launch on K3's input above, fp32 channels-last; the
         # old absmax + quantize pair in turns with it under "pair_ms"
         "shape": [k3m["x"][0], k3m["x"][-1], *k3m["x"][1:-1]],
         "max_abs_err": max(v["max_abs_err"]
                            for v in k3m["k4_equal"].values()),
         "timer": "cuda events per call, host launch included",
         "ms": k3m["k4_ms"], "plain_ms": k3m["k4_plain_ms"],
         "pair_ms": k3m["k4_pair_ms"],
         "bound_ms": k3m["k4_bound_ms"], "bound_by": k3m["k4_bound_by"],
         "bound_basis": SIMT,
         "device": {"timer": "torch.profiler kernel time",
                    "ms": k3m["k4_device_ms"],
                    "plain_ms": k3m["k4_plain_device_ms"],
                    "pair_ms": k3m["k4_pair_device_ms"],
                    "bound_share": k3m["k4_device_bound_share"],
                    # over the 24 int8 convolutions of one forward, B = 16
                    "per_forward_ms": k3_summary["k4_device_ms_per_forward"],
                    "pair_per_forward_ms":
                        k3_summary["k4_pair_device_ms_per_forward"],
                    "bound_per_forward_ms":
                        k3_summary["k4_bound_ms_per_forward"]},
         # no single PyTorch call; plain_ms is the torch chain it replaces
         "library_ms": None},
        {"name": "av_stem", "route": "cuda",
         "source": "lipsync_tpu_torch/csrc/av_stem.cu",
         # no TPU counterpart: AV-HuBERT exists only in the port
         "replaces": "lipsync_tpu_torch/models/avhubert.py::ResEncoder."
                     "frontend3D (cuDNN conv, BatchNorm, PReLU, max-pool)",
         # phase 4e's engine run, one a group; phase 4d's own calls apart
         "launches": k5e["launches"], "groups": k5e["groups"],
         "check_launches": k5m["phase_launches"],
         "shape": k5m["shape"], "timer": k5m["timer"],
         "share_differing": k5m["share_differing"],
         "widest_diff": k5m["widest_diff"],
         "ms": k5m["kernel_ms"], "plain_ms": k5m["plain_ms"],
         "bound_ms": k5m["bound_ms"], "bound_by": k5m["bound_by"],
         "bound_basis": k5m["bound_basis"],
         "library_ms": k5m["library_ms"],
         "library": "ResEncoder.frontend3D and the copy into (B * T, 64, "
                    "Hp, Wp)",
         "device": {"timer": "torch.profiler kernel time",
                    "ms": k5m["kernel_device_ms"],
                    "library_ms": k5m["library_device_ms"],
                    "bound_share": k5m["device_bound_share"]}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
