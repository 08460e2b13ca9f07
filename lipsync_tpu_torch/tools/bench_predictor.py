"""Predictor end-to-end latency: pipelined vs serialized long-video path.

    python -m lipsync_tpu_torch.tools.bench_predictor --model-path FILE \
        [--n-clips 6 --clip-seconds 6 --repeats 2] [--device cuda:0]

The port's counterpart of the JAX package's script ``bench_predictor``,
with its flags and report keys. The same clips (written with
``preprocessing/mux.py``) are scored twice through ``Predictor.predict``,
once with ``pipelined_long_video=True`` (host face detection overlapped
with the device's scoring, ``inference/pipelined.py``) and once with the
serialized path (detect ALL frames, then score), on ``--device`` (cuda:0
unless asked; K1 and K2 in every ``predict``). Each predictor is warmed
on the first clip. ``main(..., detector_backend=)`` gives both
predictors a face detector in place of the default ladder; the report
also holds each arm's verdicts (``verdicts``), clip by clip.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from lipsync_tpu_torch.tools.common import add_device_argument


def main(argv: Optional[List[str]] = None, detector_backend=None) -> dict:
    from lipsync_tpu_torch.inference.predictor import (
        Predictor,
        PredictorConfig,
    )
    from lipsync_tpu_torch.preprocessing import mux
    from lipsync_tpu_torch.utils.synthetic import (
        speechish_pcm,
        synthetic_frames,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--model-path", type=Path, required=True)
    p.add_argument("--n-clips", type=int, default=6)
    p.add_argument("--clip-seconds", type=float, default=6.0)
    p.add_argument("--repeats", type=int, default=2)
    add_device_argument(p)
    args = p.parse_args(argv)

    tmp = Path(tempfile.mkdtemp())
    clips = []
    for i in range(args.n_clips):
        frames = synthetic_frames(int(args.clip_seconds * 15), seed=i)
        pcm = speechish_pcm(args.clip_seconds, seed=i)
        clips.append(mux.write_video(tmp / f"clip_{i}.avi", frames, 15.0,
                                     pcm, 16000))

    results = {}
    verdicts = {}
    predictors = {}
    for name, flag in (("pipelined", True), ("serialized", False)):
        cfg = PredictorConfig(pipelined_long_video=flag)
        pred = predictors[name] = Predictor(
            model_path=args.model_path, config=cfg,
            detector_backend=detector_backend, device=args.device)
        pred.predict(clips[0])  # warm: kernel builds, allocations
        lats = []
        for _ in range(args.repeats):
            verdicts[name] = []
            for c in clips:
                t0 = time.perf_counter()
                res = pred.predict(c)
                lats.append(time.perf_counter() - t0)
                verdicts[name].append(res["verdict"])
        lat = np.sort(np.asarray(lats))
        results[name] = {
            "p50_s": float(np.percentile(lat, 50)),
            "p90_s": float(np.percentile(lat, 90)),
            "mean_s": float(lat.mean()),
            "n": len(lats),
        }
    for pred in predictors.values():
        pred.close()

    out = {
        "metric": "predict_p50_s",
        "value": results["pipelined"]["p50_s"],
        "unit": "s/clip",
        "clip_seconds": args.clip_seconds,
        "pipelined": results["pipelined"],
        "serialized": results["serialized"],
        "speedup_p50": (results["serialized"]["p50_s"]
                        / max(results["pipelined"]["p50_s"], 1e-9)),
        "verdicts": verdicts,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
