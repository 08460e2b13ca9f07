"""Generate a synthetic lip-sync dataset for end-to-end pipeline checks.

    python -m lipsync_tpu_torch.tools.make_synthetic_dataset \
        --output-dir data/synth --n-per-class 40 --seconds 3

The port's counterpart of the JAX package's
``scripts/make_synthetic_dataset.py``, draw for draw: the same renderers,
seeds and flags, written through the port's muxer
(``preprocessing/mux.py``).

REAL clips: the mouth opening tracks the audio amplitude envelope frame by
frame (in sync). FAKE clips: the mouth follows an independent envelope
(the audio-swap manipulation the detector exists to catch). Output is a
``0_real/`` + ``1_fake/`` tree of .avi files (native muxer) that the whole
stack — discovery, precompute, training, eval — consumes like real data.
The render functions return arrays, so a caller can render in memory
without FFmpeg (:func:`envelope_clips`, :func:`phoneme_pair`).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from lipsync_tpu_torch.preprocessing.mux import write_video


def speech_envelope(seconds: float, sr: int, rng) -> np.ndarray:
    """Random syllable-rate (2-5 Hz) amplitude envelope in [0, 1]."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = np.zeros(n)
    for _ in range(3):
        f = rng.uniform(1.5, 5.0)
        phase = rng.uniform(0, 2 * np.pi)
        env += np.clip(np.sin(2 * np.pi * f * t + phase), 0, 1)
    env = env / max(env.max(), 1e-6)
    return env


# ── phoneme-style articulation (round-3 generator v2) ───────────────────
#
# Vowel inventory: each vowel fixes BOTH the mouth geometry (relative
# height, width, lip rounding) and the spectral envelope (formants F1/F2).
# The audio-visual correspondence is therefore shape <-> spectrum, not just
# openness <-> loudness — a detector must read articulation, and fakes can
# be built that match loudness perfectly while mismatching the phonetics
# (``vowel-scramble``), the failure mode envelope-only synthesis can't
# express. Formant values are the classic Peterson-Barney style averages.
VOWELS = {
    #        height width round   F1    F2
    "a": (1.00, 0.75, 0.0, 800.0, 1200.0),
    "e": (0.55, 0.90, 0.0, 500.0, 1900.0),
    "i": (0.25, 1.00, 0.0, 300.0, 2300.0),
    "o": (0.65, 0.55, 0.6, 500.0, 900.0),
    "u": (0.30, 0.45, 1.0, 320.0, 800.0),
}


def sample_syllables(seconds: float, rng) -> list:
    """Random syllable stream: (t_start, t_end, vowel, stress) tuples with
    150-350 ms nuclei separated by 40-150 ms closures."""
    out = []
    t = rng.uniform(0.02, 0.2)
    vowel_names = sorted(VOWELS)
    while t < seconds - 0.1:
        dur = rng.uniform(0.15, 0.35)
        v = vowel_names[rng.randint(len(vowel_names))]
        stress = rng.uniform(0.6, 1.0)
        out.append((t, min(t + dur, seconds), v, stress))
        t += dur + rng.uniform(0.04, 0.15)
    return out


def phoneme_tracks(
    syllables: list, seconds: float, sr: int, rng
) -> tuple:
    """Per-sample articulation tracks at audio rate.

    Returns (openness, width, rounding, f1, f2, voiced) arrays of length
    ``seconds * sr``: openness/width drive the mouth drawing, f1/f2 the
    spectral envelope, voiced the amplitude. Onsets/offsets are smoothed
    ~30 ms so both modalities move continuously (coarticulation blur).
    """
    n = int(seconds * sr)
    t = np.arange(n) / sr
    openness = np.zeros(n)
    width = np.full(n, 0.6)
    rounding = np.zeros(n)
    f1 = np.full(n, 500.0)
    f2 = np.full(n, 1500.0)
    voiced = np.zeros(n)
    for (t0, t1, v, stress) in syllables:
        h, w, r, ff1, ff2 = VOWELS[v]
        mask = (t >= t0) & (t < t1)
        # Rise/fall within the syllable nucleus.
        local = (t[mask] - t0) / max(t1 - t0, 1e-6)
        bump = np.sin(np.pi * np.clip(local, 0, 1))
        openness[mask] = h * stress * (0.35 + 0.65 * bump)
        width[mask] = w
        rounding[mask] = r
        f1[mask] = ff1
        f2[mask] = ff2
        voiced[mask] = stress * (0.25 + 0.75 * bump)
    # ~30 ms box smoothing: coarticulation + continuous mouth motion.
    k = max(1, int(0.03 * sr))
    kernel = np.ones(k) / k
    sm = lambda x: np.convolve(x, kernel, mode="same")  # noqa: E731
    return sm(openness), sm(width), sm(rounding), sm(f1), sm(f2), sm(voiced)


def synth_phoneme_audio(
    f1: np.ndarray, f2: np.ndarray, voiced: np.ndarray, sr: int, rng
) -> np.ndarray:
    """Formant-weighted harmonic stack: each harmonic of a vibrato'd f0 is
    weighted by Gaussian formant bumps at the (time-varying) F1/F2."""
    n = len(voiced)
    t = np.arange(n) / sr
    f0 = rng.uniform(110, 220) * (
        1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t
                            + rng.uniform(0, 6))
    )
    phase = 2 * np.pi * np.cumsum(f0) / sr
    pcm = np.zeros(n)
    for k in range(1, 13):
        fk = k * f0
        w = (
            np.exp(-0.5 * ((fk - f1) / 130.0) ** 2)
            + 0.7 * np.exp(-0.5 * ((fk - f2) / 180.0) ** 2)
            + 0.08 / k
        )
        pcm += w * np.sin(k * phase)
    pcm = pcm / max(np.abs(pcm).max(), 1e-6)
    pcm = (pcm * voiced * 0.5).astype(np.float32)
    pcm += rng.randn(n).astype(np.float32) * 5e-4
    return pcm


def render_phoneme_clip(
    openness: np.ndarray,
    width: np.ndarray,
    rounding: np.ndarray,
    pcm: np.ndarray,
    seconds: float,
    fps: float,
    sr: int,
    rng,
    h: int = 140,
    w: int = 180,
    jitter: bool = False,
    head_motion: bool = True,
    return_mouth_boxes: bool = False,
) -> np.ndarray:
    """Frames whose mouth SHAPE follows the articulation tracks: tall/open
    for /a/, wide/flat for /i/, small/round for /u/. Optional slow head
    drift exercises the tracker and breaks static-pixel memorization.

    ``return_mouth_boxes=True`` also returns per-frame (x1, y1, x2, y2)
    lip-region boxes (the ``composite`` fake construction needs ground
    truth to place its blending artifacts)."""
    n_frames = int(seconds * fps)
    n_samples = len(openness)
    yy, xx = np.mgrid[0:h, 0:w]
    if jitter:
        cy0 = h // 2 + int(rng.uniform(-0.10, 0.10) * h)
        cx0 = w // 2 + int(rng.uniform(-0.12, 0.12) * w)
        scale = rng.uniform(0.75, 1.2)
        skin = np.asarray((200, 168, 150)) * rng.uniform(0.6, 1.1)
        lip = np.asarray((80, 25, 25)) * rng.uniform(0.7, 1.3)
        noise_hi = rng.randint(15, 45)
    else:
        cy0, cx0, scale = h // 2, w // 2, 1.0
        skin, lip = np.asarray((200, 168, 150)), np.asarray((80, 25, 25))
        noise_hi = 30
    skin = tuple(int(c) for c in skin)
    lip = tuple(int(c) for c in lip)
    mouth_interior = tuple(int(c * 0.4) for c in lip)
    drift_f = rng.uniform(0.1, 0.4)
    drift_ph = rng.uniform(0, 2 * np.pi, size=2)
    drift_amp = (0.03 * w, 0.02 * h) if head_motion else (0.0, 0.0)

    frames = np.empty((n_frames, h, w, 3), np.uint8)
    mouth_boxes = np.zeros((n_frames, 4), np.int32)
    base = rng.randint(0, noise_hi, size=(h, w, 3)).astype(np.uint8)
    idx = np.minimum(
        (np.arange(n_frames) * sr / fps).astype(int), n_samples - 1
    )
    eye_dx = int(w * scale) // 9
    for i in range(n_frames):
        ft = i / fps
        cx = cx0 + int(drift_amp[0] * np.sin(2 * np.pi * drift_f * ft
                                             + drift_ph[0]))
        cy = cy0 + int(drift_amp[1] * np.sin(2 * np.pi * drift_f * 0.7 * ft
                                             + drift_ph[1]))
        img = base.copy()
        face = (
            ((yy - cy) / (h * 0.32 * scale)) ** 2
            + ((xx - cx) / (w * 0.24 * scale)) ** 2
        ) < 1
        img[face] = skin
        for ex in (cx - eye_dx, cx + eye_dx):
            eye = (
                (yy - (cy - int(h * scale) // 7)) ** 2 + (xx - ex) ** 2
            ) < (h * 0.035 * scale) ** 2
            img[eye] = (40, 30, 30)
        o, ww, rr = openness[idx[i]], width[idx[i]], rounding[idx[i]]
        my = cy + int(h * scale) // 5
        # Lip ellipse: half-axes from articulation (round vowels narrow).
        ax = max(3.0, w * scale * (0.055 + 0.075 * ww) * (1.0 - 0.35 * rr))
        ay = max(2.0, h * scale * (0.018 + 0.085 * o))
        lips = (((yy - my) / ay) ** 2 + ((xx - cx) / ax) ** 2) < 1
        img[lips] = lip
        # Open-mouth interior: darker inner ellipse when open enough.
        if o > 0.18:
            iy = max(1.0, ay * 0.55)
            ix = max(2.0, ax * 0.7)
            inner = (((yy - my) / iy) ** 2 + ((xx - cx) / ix) ** 2) < 1
            img[inner] = mouth_interior
        # Generous lip-region box (max articulation extent + margin).
        bx = int(w * scale * 0.13) + 6
        by = int(h * scale * 0.11) + 6
        mouth_boxes[i] = (max(0, cx - bx), max(0, my - by),
                          min(w, cx + bx), min(h, my + by))
        frames[i] = img
    if return_mouth_boxes:
        return frames, mouth_boxes
    return frames


def render_clip(
    envelope_video: np.ndarray,
    envelope_audio: np.ndarray,
    seconds: float,
    fps: float,
    sr: int,
    rng,
    h: int = 140,
    w: int = 180,
    jitter: bool = False,
) -> tuple:
    """Frames whose mouth opening follows envelope_video; PCM voiced by
    envelope_audio.

    ``jitter=True`` randomizes face position/scale/skin/lip color per clip
    so the classifier must use audio-visual SYNC, not pixel idiosyncrasies
    (round-2 hardening; see BENCHMARKS.md synthetic eval).
    """
    n_frames = int(seconds * fps)
    n_samples = int(seconds * sr)
    t = np.arange(n_samples) / sr
    f0 = 150 + 40 * np.sin(2 * np.pi * 0.6 * t + rng.uniform(0, 6))
    carrier = sum(
        (0.5 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
        for k in range(1, 5)
    )
    pcm = (carrier * envelope_audio * 0.4).astype(np.float32)
    pcm += rng.randn(n_samples).astype(np.float32) * 5e-4

    yy, xx = np.mgrid[0:h, 0:w]
    if jitter:
        cy = h // 2 + int(rng.uniform(-0.10, 0.10) * h)
        cx = w // 2 + int(rng.uniform(-0.12, 0.12) * w)
        scale = rng.uniform(0.75, 1.2)
        skin = tuple(
            int(c) for c in np.asarray((200, 168, 150)) * rng.uniform(0.6, 1.1)
        )
        lip = tuple(
            int(c) for c in np.asarray((80, 25, 25)) * rng.uniform(0.7, 1.3)
        )
        noise_hi = rng.randint(15, 45)
    else:
        cy, cx, scale, skin, lip, noise_hi = (
            h // 2, w // 2, 1.0, (200, 168, 150), (80, 25, 25), 30
        )
    face = (
        ((yy - cy) / (h * 0.32 * scale)) ** 2
        + ((xx - cx) / (w * 0.24 * scale)) ** 2
    ) < 1
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    base = rng.randint(0, noise_hi, size=(h, w, 3)).astype(np.uint8)
    env_at_frame = envelope_video[
        np.minimum((np.arange(n_frames) * sr / fps).astype(int), n_samples - 1)
    ]
    eye_dx = int(w * scale) // 9
    for i in range(n_frames):
        img = base.copy()
        img[face] = skin
        for ex in (cx - eye_dx, cx + eye_dx):
            eye = (
                (yy - (cy - int(h * scale) // 7)) ** 2 + (xx - ex) ** 2
            ) < (h * 0.035 * scale) ** 2
            img[eye] = (40, 30, 30)
        openness = env_at_frame[i]
        mh = max(1, int(h * scale * (0.012 + 0.06 * openness)))
        mouth = (
            (np.abs(yy - (cy + int(h * scale) // 5)) < mh)
            & (np.abs(xx - cx) < w * 0.10 * scale)
        )
        img[mouth] = lip
        frames[i] = img
    return frames, pcm


def _scramble_vowels(syllables: list, rng) -> list:
    """Same timing/stress, different vowels — matches loudness exactly
    while mismatching shapes and spectra (the pure-phonetic fake)."""
    names = sorted(VOWELS)
    out = []
    for (t0, t1, v, stress) in syllables:
        others = [x for x in names if x != v]
        out.append((t0, t1, others[rng.randint(len(others))], stress))
    return out


PHONEME_FAKE_MODES = ("shift", "swap", "scramble", "warp", "splice",
                      "freeze", "revoice", "retime", "composite")


def _warp_time_map(n: int, sr: int, rng) -> np.ndarray:
    """Smooth local time-warp map in samples: tau(t) = t + d(t), with
    d a sum of two slow sinusoids whose peak deviation is 0.15-0.3 s.

    Unlike the GLOBAL 0.25-0.8 s shifts the training fakes use, a warp
    drifts in and out of sync WITHIN the clip — some windows are
    perfectly aligned, others are off by up to ~300 ms — so it probes
    generalization to a misalignment structure never seen in training.
    """
    t = np.arange(n) / sr
    amp = rng.uniform(0.15, 0.30)
    a1 = amp * rng.uniform(0.6, 1.0)
    a2 = amp - a1 if amp > a1 else 0.0
    f1_, f2_ = rng.uniform(0.25, 0.6), rng.uniform(0.7, 1.2)
    # Keep tau monotone (no reversed mouth motion): |d'| <= sum a_k*2*pi*f_k
    # must stay < 1; scale the deviation down if the sampled combo exceeds
    # a 0.8 slope budget.
    slope = 2 * np.pi * (a1 * f1_ + a2 * f2_)
    if slope > 0.8:
        a1, a2 = a1 * 0.8 / slope, a2 * 0.8 / slope
    d = a1 * np.sin(2 * np.pi * f1_ * t + rng.uniform(0, 2 * np.pi))
    d += a2 * np.sin(2 * np.pi * f2_ * t + rng.uniform(0, 2 * np.pi))
    return np.clip((t + d) * sr, 0, n - 1)


def _splice_audio(pcm: np.ndarray, pcm_other: np.ndarray, sr: int,
                  rng) -> np.ndarray:
    """Replace the middle ~third of ``pcm`` with the same span of
    ``pcm_other``, 30 ms crossfaded at both seams so the splice leaves
    no click (the detector must key on A/V desync inside the spliced
    span, not on an audio artifact). Partial fakes exercise the
    clip-verdict aggregation policy (reference confidence weighting,
    app/inference/predictor.py — see inference/policy.py):
    2/3 of the windows remain genuinely synced."""
    n = len(pcm)
    start = int(n * rng.uniform(0.30, 0.38))
    end = int(n * rng.uniform(0.62, 0.70))
    k = int(0.03 * sr)
    out = pcm.copy()
    out[start:end] = pcm_other[start:end]
    ramp = np.linspace(0.0, 1.0, k, dtype=pcm.dtype)
    out[start:start + k] = (pcm[start:start + k] * (1 - ramp)
                            + pcm_other[start:start + k] * ramp)
    out[end - k:end] = (pcm_other[end - k:end] * (1 - ramp)
                        + pcm[end - k:end] * ramp)
    return out


def _box_blur_rgb(patch: np.ndarray, k: int = 3, passes: int = 2
                  ) -> np.ndarray:
    """Small separable box blur (no cv2/scipy needed at generation time)."""
    out = patch.astype(np.float32)
    for _ in range(passes):
        for axis in (0, 1):
            pad = k // 2
            padded = np.concatenate(
                [np.repeat(out.take([0], axis=axis), pad, axis=axis), out,
                 np.repeat(out.take([-1], axis=axis), pad, axis=axis)],
                axis=axis,
            )
            cum = np.cumsum(padded, axis=axis)
            zero = np.zeros_like(cum.take([0], axis=axis))
            cum = np.concatenate([zero, cum], axis=axis)
            out = (cum.take(range(k, k + out.shape[axis]), axis=axis)
                   - cum.take(range(out.shape[axis]), axis=axis)) / k
    return out


def _composite_lips(frames: np.ndarray, boxes: np.ndarray, rng
                    ) -> np.ndarray:
    """Face-swap blending artifacts on a perfectly synced clip: the lip
    region is blurred, color-shifted toward its mean (~the classic
    blend-color mismatch), and pasted back with a hard seam plus +-1 px
    per-frame placement shimmer (temporal inconsistency for the delta
    branch). The A/V sync itself stays intact."""
    out = frames.copy()
    h, w = frames.shape[1:3]
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        if x2 - x1 < 4 or y2 - y1 < 4:
            continue
        patch = _box_blur_rgb(frames[i, y1:y2, x1:x2])
        patch = patch * 0.9 + patch.mean(axis=(0, 1), keepdims=True) * 0.1
        jx = int(rng.randint(-1, 2))
        jy = int(rng.randint(-1, 2))
        px1 = min(max(0, x1 + jx), w - (x2 - x1))
        py1 = min(max(0, y1 + jy), h - (y2 - y1))
        out[i, py1:py1 + (y2 - y1), px1:px1 + (x2 - x1)] = np.clip(
            patch + 0.5, 0, 255
        ).astype(np.uint8)
    return out


def write_phoneme_pair(
    args, rng, real_dir: Path, fake_dir: Path, i: int,
    modes: tuple = ("shift", "swap", "scramble"),
) -> None:
    """One real + one fake phoneme-style clip (:func:`phoneme_pair`),
    written as ``real_dir/real_<i>.avi`` and ``fake_dir/fake_<i>.avi``."""
    (frames, pcm), (frames_f, pcm_f) = phoneme_pair(args, rng, i, modes)
    write_video(real_dir / f"real_{i:04d}.avi", frames, args.fps, pcm,
                args.sr)
    write_video(fake_dir / f"fake_{i:04d}.avi", frames_f, args.fps, pcm_f,
                args.sr)


def phoneme_pair(args, rng, i: int,
                 modes: tuple = ("shift", "swap", "scramble")) -> tuple:
    """``((frames, pcm) real, (frames, pcm) fake)`` of one phoneme-style
    pair. Fake constructions (the pair's mode is ``modes[i % len(modes)]``):

    - ``shift``: same articulation, audio delayed 0.25-0.8 s globally
    - ``swap``: audio from an independent articulation stream
    - ``scramble``: same timing/stress, different vowels (loudness-matched)
    - ``warp``: smooth LOCAL time-warp of the visual tracks (peak
      0.15-0.3 s, drifting in and out of sync within the clip) — held
      out of training as an unseen construction
    - ``splice``: fully real clip whose middle ~third of AUDIO is an
      independent clip's (30 ms crossfade; partial fake) — held out of
      training as an unseen construction
    - ``freeze``: visual articulation holds still for a 0.5-1.0 s span
      mid-clip while the audio continues (the classic face-swap
      dropped-frames artifact; partial fake) — held out of training as
      an unseen construction
    - ``revoice``: video fully real; AUDIO re-synthesized from the same
      syllable timing/stress with scrambled vowels — loudness envelope
      matches exactly, formants mismatch the visible mouth shapes (a
      prosody-preserving voice-conversion re-dub); held out of training
    - ``retime``: video fully real but uniformly time-stretched 0.85-0.93x
      or 1.08-1.18x (fps-mismatch artifact): sync drifts LINEARLY from 0
      to ~0.2-0.5 s across the clip; held out of training
    - ``composite``: perfectly synced A/V, but the lip region is pasted
      back with face-swap blending artifacts — box blur, a hard seam, and
      per-frame +-1 px placement shimmer. Zero sync signal: only the
      artifact branch (reference artifact_detector.py Laplacian/delta
      paths) can catch it; held out of training
    """
    sr, fps, seconds = args.sr, args.fps, args.seconds

    def _maybe_interfere(pcm_in: np.ndarray) -> np.ndarray:
        """Cocktail-party augmentation: mix an INDEPENDENT speech stream
        under the clip's own audio (label unchanged). Guarded so the rng
        sequence of existing seeds is untouched when the knob is off."""
        prob = float(getattr(args, "interference_prob", 0.0) or 0.0)
        if prob <= 0.0 or rng.rand() >= prob:
            return pcm_in
        syl_i = sample_syllables(seconds, rng)
        _, _, _, f1i, f2i, vi = phoneme_tracks(syl_i, seconds, sr, rng)
        lo, hi = getattr(args, "interference_gain", (0.35, 0.65))
        mixed = pcm_in + float(rng.uniform(lo, hi)) * synth_phoneme_audio(
            f1i, f2i, vi, sr, rng
        )
        peak = float(np.abs(mixed).max())
        return (mixed / peak if peak > 1.0 else mixed).astype(np.float32)

    syl = sample_syllables(seconds, rng)
    o, w_, r, f1, f2, voiced = phoneme_tracks(syl, seconds, sr, rng)
    pcm = _maybe_interfere(synth_phoneme_audio(f1, f2, voiced, sr, rng))
    frames = render_phoneme_clip(
        o, w_, r, pcm, seconds, fps, sr, rng,
        jitter=args.jitter, head_motion=not args.no_head_motion,
    )
    real = (frames, pcm)

    mode = modes[i % len(modes)]
    syl_a = sample_syllables(seconds, rng)
    oa, wa, ra, f1a, f2a, va = phoneme_tracks(syl_a, seconds, sr, rng)
    pcm_a = synth_phoneme_audio(f1a, f2a, va, sr, rng)
    pcm_f = pcm_a
    if mode == "shift":
        shift = int(rng.uniform(0.25, 0.8) * sr)
        ov, wv, rv = (np.roll(x, shift) for x in (oa, wa, ra))
    elif mode == "scramble":
        ov, wv, rv, _, _, _ = phoneme_tracks(
            _scramble_vowels(syl_a, rng), seconds, sr, rng
        )
    elif mode == "warp":
        tau = _warp_time_map(len(oa), sr, rng)
        base = np.arange(len(oa))
        ov, wv, rv = (np.interp(tau, base, x) for x in (oa, wa, ra))
    elif mode == "splice":
        ov, wv, rv = oa, wa, ra
        syl_c = sample_syllables(seconds, rng)
        _, _, _, f1c, f2c, vc = phoneme_tracks(syl_c, seconds, sr, rng)
        pcm_f = _splice_audio(
            pcm_a, synth_phoneme_audio(f1c, f2c, vc, sr, rng), sr, rng
        )
    elif mode == "freeze":
        n = len(oa)
        start = int(n * rng.uniform(0.25, 0.5))
        end = min(start + int(rng.uniform(0.5, 1.0) * sr), n)
        ov, wv, rv = (x.copy() for x in (oa, wa, ra))
        for x in (ov, wv, rv):
            x[start:end] = x[start]
    elif mode == "revoice":
        # Video fully real; audio re-synthesized with scrambled vowels on
        # the SAME timing/stress and the ORIGINAL voiced envelope —
        # loudness matches exactly, formants mismatch the mouth shapes.
        ov, wv, rv = oa, wa, ra
        _, _, _, f1s, f2s, _ = phoneme_tracks(
            _scramble_vowels(syl_a, rng), seconds, sr, rng
        )
        pcm_f = synth_phoneme_audio(f1s, f2s, va, sr, rng)
    elif mode == "retime":
        # Uniform visual time-stretch: sync drift grows linearly from 0
        # to ~|1-rate|*seconds across the clip (fps-mismatch artifact).
        rate = (rng.uniform(0.85, 0.93) if rng.rand() < 0.5
                else rng.uniform(1.08, 1.18))
        n = len(oa)
        base = np.arange(n)
        tau = np.clip(base * rate, 0, n - 1)
        ov, wv, rv = (np.interp(tau, base, x) for x in (oa, wa, ra))
    elif mode == "composite":
        ov, wv, rv = oa, wa, ra  # synced; artifacts added after render
    else:  # swap: visual from an independent articulation stream
        syl_b = sample_syllables(seconds, rng)
        ov, wv, rv, _, _, _ = phoneme_tracks(syl_b, seconds, sr, rng)

    pcm_f = _maybe_interfere(pcm_f)
    if mode == "composite":
        # Perfectly synced A/V; the manipulation is pure pixel-blending
        # artifacts in the lip region (no sync signal at all).
        frames, boxes = render_phoneme_clip(
            ov, wv, rv, pcm_f, seconds, fps, sr, rng,
            jitter=args.jitter, head_motion=not args.no_head_motion,
            return_mouth_boxes=True,
        )
        frames = _composite_lips(frames, boxes, rng)
    else:
        frames = render_phoneme_clip(
            ov, wv, rv, pcm_f, seconds, fps, sr, rng,
            jitter=args.jitter, head_motion=not args.no_head_motion,
        )
    return real, (frames, pcm_f)


# ── Multi-face scenes (round 4) ──────────────────────────────────────────
#
# The reference's marquee production feature is multi-face tracking +
# speaker timeline + per-track verdicts
# (the reference's app/inference/predictor.py:1538-1631,
# app/preprocessing/face_detection.py:668-1101). These scenes exercise that
# path end-to-end: 2-3 faces side by side, each with a ground-truth role —
# synced speaker, dubbed speaker (mouth follows an articulation stream
# independent of the audio), or silent listener. A sidecar JSON per clip
# records roles + nominal face centers so an eval can attribute recovered
# tracks to subjects (the JAX package's scripts/eval_multiface.py).

MULTIFACE_SCENES = (
    "all_real",        # one synced speaker + listeners
    "all_fake",        # one dubbed speaker + listeners
    "mixed",           # synced speaker + dubbed speaker (simultaneous)
    "turn_taking",     # two synced speakers alternating (all real)
    "turn_taking_dub", # speaker A synced, then speaker B dubbed
)


def sample_phrased_syllables(seconds: float, rng) -> list:
    """Syllables grouped into 2-5-syllable phrases separated by
    0.3-0.8 s pauses — natural speech pausing. The reference's speaking
    score correlates mouth-MOTION against audio ENERGY
    (predictor.py:333-370): without speech/silence contrast inside a
    2.13 s window the correlation is ~0 for genuinely synced speakers
    (measured: 0.46 continuous vs 0.67 with a pause), so continuous
    syllable streams make the speaking-track filter blind by
    construction, not by model failure."""
    out = []
    t = rng.uniform(0.02, 0.15)
    vowel_names = sorted(VOWELS)
    while t < seconds - 0.1:
        for _ in range(rng.randint(2, 6)):  # one phrase
            if t >= seconds - 0.1:
                break
            dur = rng.uniform(0.15, 0.35)
            v = vowel_names[rng.randint(len(vowel_names))]
            out.append((t, min(t + dur, seconds), v,
                        rng.uniform(0.6, 1.0)))
            t += dur + rng.uniform(0.04, 0.15)
        t += rng.uniform(0.30, 0.80)  # inter-phrase pause
    return out


def _span_tracks(span, seconds: float, sr: int, rng):
    """Phoneme articulation confined to ``span=(t0, t1)``: phrased
    syllables are sampled inside the span; tracks are zero (mouth closed,
    voice silent) outside it."""
    t0, t1 = span
    syl = [
        (s + t0, min(e + t0, t1), v, st)
        for (s, e, v, st) in sample_phrased_syllables(t1 - t0, rng)
    ]
    return phoneme_tracks(syl, seconds, sr, rng)


def _listener_tracks(seconds: float, sr: int, rng):
    """Near-still mouth: tiny slow 'breathing' openness so motion energy is
    near-zero but not exactly zero (a real listener's face)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f = rng.uniform(0.2, 0.45)
    openness = 0.02 + 0.015 * (1 + np.sin(2 * np.pi * f * t
                                          + rng.uniform(0, 6))) / 2
    width = np.full(n, 0.6)
    rounding = np.zeros(n)
    return openness, width, rounding


def build_multiface_scene(scene: str, n_faces: int, seconds: float,
                          sr: int, rng):
    """Returns (faces, pcm) where ``faces`` is a list of dicts with
    articulation arrays + ground-truth ``role``/``speaking`` spans and
    ``pcm`` is the mixed scene audio."""
    n = int(seconds * sr)
    pcm = np.zeros(n, np.float32)
    faces = []

    if scene in ("turn_taking", "turn_taking_dub"):
        n_faces = 2
        half = seconds / 2.0
        spans = [(0.05, half - 0.1), (half + 0.1, seconds - 0.05)]
        roles = ["speaker_synced",
                 "speaker_dubbed" if scene == "turn_taking_dub"
                 else "speaker_synced"]
    else:
        spans = [(0.05, seconds - 0.05)] + [None] * (n_faces - 1)
        if scene == "all_real":
            roles = ["speaker_synced"] + ["listener"] * (n_faces - 1)
        elif scene == "all_fake":
            roles = ["speaker_dubbed"] + ["listener"] * (n_faces - 1)
        elif scene == "mixed":
            spans = [(0.05, seconds - 0.05), (0.05, seconds - 0.05)]
            spans += [None] * (n_faces - 2)
            roles = ["speaker_synced", "speaker_dubbed"]
            roles += ["listener"] * (n_faces - 2)
        else:
            raise ValueError(f"unknown scene {scene!r}")

    for slot in range(n_faces):
        role = roles[slot]
        if role == "listener":
            o, w_, r = _listener_tracks(seconds, sr, rng)
            faces.append({"role": role, "speaking": [],
                          "openness": o, "width": w_, "rounding": r})
            continue
        span = spans[slot]
        # The AUDIBLE stream for this speaker's span.
        oa, wa, ra, f1a, f2a, va = _span_tracks(span, seconds, sr, rng)
        pcm += synth_phoneme_audio(f1a, f2a, va, sr, rng)
        if role == "speaker_dubbed":
            # Visible articulation: an INDEPENDENT stream in the same span.
            ov, wv, rv, _, _, _ = _span_tracks(span, seconds, sr, rng)
        else:
            ov, wv, rv = oa, wa, ra
        faces.append({"role": role, "speaking": [list(span)],
                      "openness": ov, "width": wv, "rounding": rv})

    peak = float(np.abs(pcm).max())
    if peak > 1.0:
        pcm = pcm / peak
    pcm += rng.randn(n).astype(np.float32) * 5e-4
    return faces, pcm.astype(np.float32)


def render_multiface_clip(faces, seconds: float, fps: float, sr: int, rng,
                          cell_w: int = 170, h: int = 150,
                          articulation_gain: float = 1.0) -> np.ndarray:
    """Render 2-3 faces side by side, each a phoneme-style face in its own
    horizontal cell with per-face identity jitter + slow head drift (the
    single-face render_phoneme_clip drawing, composited per frame)."""
    n_faces = len(faces)
    w = cell_w * n_faces
    n_frames = int(seconds * fps)
    n_samples = int(seconds * sr)
    yy, xx = np.mgrid[0:h, 0:w]
    idx = np.minimum((np.arange(n_frames) * sr / fps).astype(int),
                     n_samples - 1)

    # Per-face geometry + identity.
    geo = []
    for slot in range(n_faces):
        cx0 = int((slot + 0.5) * cell_w + rng.uniform(-8, 8))
        cy0 = int(h / 2 + rng.uniform(-6, 6))
        scale = rng.uniform(0.85, 1.05)
        skin = tuple(int(c) for c in
                     np.asarray((200, 168, 150)) * rng.uniform(0.7, 1.1))
        lip = tuple(int(c) for c in
                    np.asarray((80, 25, 25)) * rng.uniform(0.7, 1.3))
        geo.append({
            "cx0": cx0, "cy0": cy0, "scale": scale, "skin": skin,
            "lip": lip,
            "interior": tuple(int(c * 0.4) for c in lip),
            "drift_f": rng.uniform(0.1, 0.35),
            "drift_ph": rng.uniform(0, 2 * np.pi, size=2),
            "drift_amp": (0.018 * cell_w, 0.015 * h),
        })

    frames = np.empty((n_frames, h, w, 3), np.uint8)
    base = rng.randint(0, 30, size=(h, w, 3)).astype(np.uint8)
    for i in range(n_frames):
        ft = i / fps
        img = base.copy()
        for face, g in zip(faces, geo):
            scale = g["scale"]
            cx = g["cx0"] + int(g["drift_amp"][0] * np.sin(
                2 * np.pi * g["drift_f"] * ft + g["drift_ph"][0]))
            cy = g["cy0"] + int(g["drift_amp"][1] * np.sin(
                2 * np.pi * g["drift_f"] * 0.7 * ft + g["drift_ph"][1]))
            ellipse = (
                ((yy - cy) / (h * 0.30 * scale)) ** 2
                + ((xx - cx) / (cell_w * 0.24 * scale)) ** 2
            ) < 1
            img[ellipse] = g["skin"]
            eye_dx = int(cell_w * scale) // 9
            for ex in (cx - eye_dx, cx + eye_dx):
                eye = ((yy - (cy - int(h * scale) // 7)) ** 2
                       + (xx - ex) ** 2) < (h * 0.035 * scale) ** 2
                img[eye] = (40, 30, 30)
            o = face["openness"][idx[i]] * articulation_gain
            ww = face["width"][idx[i]] * articulation_gain
            rr = face["rounding"][idx[i]]
            my = cy + int(h * scale) // 5
            ax = max(3.0, cell_w * scale * (0.055 + 0.075 * ww)
                     * (1.0 - 0.35 * rr))
            ay = max(2.0, h * scale * (0.018 + 0.085 * o))
            lips = (((yy - my) / ay) ** 2 + ((xx - cx) / ax) ** 2) < 1
            img[lips] = g["lip"]
            if o > 0.18:
                iy = max(1.0, ay * 0.55)
                ix = max(2.0, ax * 0.7)
                inner = (((yy - my) / iy) ** 2
                         + ((xx - cx) / ix) ** 2) < 1
                img[inner] = g["interior"]
            g.setdefault("centers", []).append((cx, cy))
        frames[i] = img
    return frames, geo


def multiface_scene(scene: str, n_faces: int, seconds: float, fps: float,
                    sr: int, rng, articulation_gain: float = 1.0):
    """One scene in memory: ``(frames, pcm, truth, geo)``, where ``truth``
    is the ground-truth sidecar (roles, speaking spans, mean face centers)
    and ``geo`` the per-face render geometry (``centers`` per frame,
    ``scale``)."""
    faces, pcm = build_multiface_scene(scene, n_faces, seconds, sr, rng)
    frames, geo = render_multiface_clip(
        faces, seconds, fps, sr, rng, articulation_gain=articulation_gain)
    truth = {
        "scene": scene,
        "n_faces": len(faces),
        "seconds": seconds,
        "fps": fps,
        "clip_is_fake": any(f["role"] == "speaker_dubbed" for f in faces),
        "frame_height": int(frames.shape[1]),
        "frame_width": int(frames.shape[2]),
        "faces": [
            {
                "slot": s,
                "role": f["role"],
                "speaking": f["speaking"],
                "cx": float(np.mean([c[0] for c in g["centers"]])),
                "cy": float(np.mean([c[1] for c in g["centers"]])),
            }
            for s, (f, g) in enumerate(zip(faces, geo))
        ],
    }
    return frames, pcm, truth, geo


def write_multiface_scene(out_dir: Path, i: int, scene: str, n_faces: int,
                          seconds: float, fps: float, sr: int, rng,
                          articulation_gain: float = 1.0) -> None:
    """One scene clip + ground-truth sidecar JSON (same stem)."""
    import json

    frames, pcm, truth, _ = multiface_scene(
        scene, n_faces, seconds, fps, sr, rng,
        articulation_gain=articulation_gain)
    stem = f"{scene}_{i:04d}"
    write_video(out_dir / f"{stem}.avi", frames, fps, pcm, sr)
    (out_dir / f"{stem}.json").write_text(json.dumps(truth, indent=1))


def envelope_clips(
    n_per_class: int, seconds: float, fps: float, sr: int, seed: int,
    jitter: bool = False, hard_negatives: bool = False,
) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """The envelope style's clips in the order ``main`` writes them:
    ``(relative path, frames (N, H, W, 3) uint8, pcm float32)``, a real
    clip then a fake one per index, from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    for i in range(n_per_class):
        env = speech_envelope(seconds, sr, rng)
        frames, pcm = render_clip(env, env, seconds, fps, sr, rng,
                                  jitter=jitter)
        yield f"0_real/real_{i:04d}.avi", frames, pcm

        env_a = speech_envelope(seconds, sr, rng)
        if hard_negatives and i % 2 == 0:
            # Time-shifted same envelope: correlated but out of sync.
            shift = int(rng.uniform(0.25, 0.8) * sr)
            env_v = np.roll(env_a, shift)
        else:
            env_v = speech_envelope(seconds, sr, rng)
        frames, pcm = render_clip(env_v, env_a, seconds, fps, sr, rng,
                                  jitter=jitter)
        yield f"1_fake/fake_{i:04d}.avi", frames, pcm


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--n-per-class", type=int, default=40)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fps", type=float, default=15.0)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jitter", action="store_true",
                   help="Randomize face position/scale/colors per clip")
    p.add_argument("--hard-negatives", action="store_true",
                   help="envelope style: half the fakes use the SAME "
                        "envelope time-shifted 0.25-0.8 s. phoneme style: "
                        "fakes cycle shift/swap/vowel-scramble modes")
    p.add_argument("--style", choices=("envelope", "phoneme", "multiface"),
                   default="envelope",
                   help="envelope: mouth height tracks loudness (round-2 "
                        "generator). phoneme: vowel-structured articulation"
                        " — mouth SHAPE tracks formant content (round-3). "
                        "multiface: 2-3 face scenes with per-face roles + "
                        "ground-truth sidecars (round-4; --n-per-class "
                        "scenes PER SCENE KIND, flat layout, no class dirs)")
    p.add_argument("--articulation-gain", type=float, default=1.0,
                   help="multiface style: scales the mouth open/width "
                        "modulation amplitude (a VARIANT articulation "
                        "style for the activity-band stability check of "
                        "the JAX package's "
                        "scripts/measure_articulation_bands.py)")
    p.add_argument("--n-faces", type=int, default=2, choices=(2, 3),
                   help="multiface style: faces per scene (turn-taking "
                        "scenes always use 2)")
    p.add_argument("--scenes", default=None,
                   help="multiface style: comma list of scene kinds "
                        f"({','.join(MULTIFACE_SCENES)}); default all")
    p.add_argument("--no-head-motion", action="store_true",
                   help="phoneme style: disable the slow head drift")
    p.add_argument("--interference-prob", type=float, default=0.0,
                   help="phoneme style: probability a clip's audio gets an "
                        "independent background-speech stream mixed in "
                        "(cocktail-party condition; labels unchanged — the "
                        "face still matches/mismatches its OWN component). "
                        "Targets the multiface mixed-scene residual "
                        "(BENCHMARKS.md 'Multi-face production replay')")
    p.add_argument("--interference-gain", type=float, nargs=2,
                   default=(0.35, 0.65), metavar=("LO", "HI"),
                   help="relative gain range of the interfering stream")
    p.add_argument("--fake-modes", default=None,
                   help="phoneme style: comma list of fake constructions "
                        f"to cycle ({','.join(PHONEME_FAKE_MODES)}). "
                        "Default: shift,swap,scramble with "
                        "--hard-negatives, else swap. warp/splice are "
                        "reserved for unseen-construction evals "
                        "(the JAX package's scripts/eval_unseen_fakes.py)")
    args = p.parse_args(argv)

    if args.style == "multiface":
        scenes = (tuple(s.strip() for s in args.scenes.split(","))
                  if args.scenes else MULTIFACE_SCENES)
        bad = [s for s in scenes if s not in MULTIFACE_SCENES]
        if bad:
            p.error(f"unknown scene kind(s) {bad}; "
                    f"choose from {MULTIFACE_SCENES}")
        args.output_dir.mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(args.seed)
        for scene in scenes:
            for i in range(args.n_per_class):
                write_multiface_scene(
                    args.output_dir, i, scene, args.n_faces,
                    args.seconds, args.fps, args.sr, rng,
                    articulation_gain=args.articulation_gain,
                )
        print(f"Wrote {args.n_per_class} x {len(scenes)} multiface scenes "
              f"({args.n_faces} faces) to {args.output_dir}")
        return 0

    real_dir = args.output_dir / "0_real"
    fake_dir = args.output_dir / "1_fake"
    real_dir.mkdir(parents=True, exist_ok=True)
    fake_dir.mkdir(parents=True, exist_ok=True)

    if args.style == "phoneme":
        rng = np.random.RandomState(args.seed)
        if args.fake_modes:
            modes = tuple(m.strip() for m in args.fake_modes.split(","))
            bad = [m for m in modes if m not in PHONEME_FAKE_MODES]
            if bad:
                p.error(f"unknown fake mode(s) {bad}; "
                        f"choose from {PHONEME_FAKE_MODES}")
        elif args.hard_negatives:
            modes = ("shift", "swap", "scramble")
        else:
            modes = ("swap",)
        for i in range(args.n_per_class):
            write_phoneme_pair(args, rng, real_dir, fake_dir, i,
                               modes=modes)
        print(f"Wrote {args.n_per_class} real + {args.n_per_class} fake "
              f"phoneme-style clips to {args.output_dir} "
              f"(fake modes: {','.join(modes)})")
        return 0

    for rel, frames, pcm in envelope_clips(
            args.n_per_class, args.seconds, args.fps, args.sr, args.seed,
            jitter=args.jitter, hard_negatives=args.hard_negatives):
        write_video(args.output_dir / rel, frames, args.fps, pcm, args.sr)
    print(f"Wrote {args.n_per_class} real + {args.n_per_class} fake clips "
          f"to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
