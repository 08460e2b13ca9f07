"""Environment preflight for training and serving on the card.

    python -m lipsync_tpu_torch.tools.check_setup [--data-dir data/train]

The port's counterpart of the JAX package's ``scripts/check_setup.py``.
Checks, one line each: CUDA and the card's name; the four kernels built
from ``csrc/`` (``ops/kernels/build.py``); the native ingest, haar and mux
libraries (``utils/native.py``); the face detector's cascade file; the data
directory's counts; one forward of ``ModelConfig()`` on ``--device``. A
missing piece is a failed check; the exit code is the number of failures.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.tools.common import add_device_argument


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", type=Path, default=None)
    add_device_argument(p)
    args = p.parse_args(argv)
    failures = 0

    def check(name, fn):
        nonlocal failures
        try:
            detail = fn()
            print(f"[ok]   {name}: {detail}")
        except Exception as e:
            failures += 1
            print(f"[FAIL] {name}: {e}")

    def cuda_check():
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        return (f"{torch.cuda.device_count()}x "
                f"{torch.cuda.get_device_name(0)} (torch {torch.__version__}"
                f", CUDA {torch.version.cuda})")

    def kernels_check():
        from lipsync_tpu_torch.ops.kernels import build

        build.build()
        for name in build.KERNELS:
            build.library(name)
        return f"{', '.join(build.KERNELS)} loaded from {build.BUILD_DIR}"

    def ingest_check():
        from lipsync_tpu_torch.preprocessing import ingest

        if ingest.get_native_lib() is None:
            raise RuntimeError("native ingest library failed to build")
        return "libingest loaded"

    def haar_check():
        from lipsync_tpu_torch.preprocessing.haar import (
            HaarCascade,
            find_cascade_file,
        )

        path = find_cascade_file("haarcascade_frontalface_default.xml")
        if path is None:
            raise RuntimeError("no frontal cascade data file found")
        hc = HaarCascade(path)
        return f"{path.name}: {len(hc.data.stage_thresholds)} stages"

    def mux_check():
        from lipsync_tpu_torch.preprocessing.mux import _get_lib

        _get_lib()
        return "libmux loaded"

    def model_check():
        import torch

        from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
        from lipsync_tpu_torch.utils.device import get_device

        dev = get_device(args.device)
        cfg = ModelConfig()
        model = LipSyncModel(cfg).eval().to(dev)
        with torch.no_grad():
            logits = model(
                torch.zeros(1, cfg.video_frames, cfg.crop_size,
                            cfg.crop_size, 3, device=dev),
                torch.zeros(1, cfg.mel_bins, cfg.audio_frames, 1,
                            device=dev))
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite logits {logits}")
        n = sum(p.numel() for p in model.parameters())
        return f"{n/1e6:.1f}M params, one forward on {dev}"

    check("cuda", cuda_check)
    check("kernels", kernels_check)
    check("native ingest", ingest_check)
    check("haar cascades", haar_check)
    check("native muxer", mux_check)
    check("model forward", model_check)

    if args.data_dir is not None:
        def data_check():
            from lipsync_tpu_torch.training.data import discover_video_samples

            samples = discover_video_samples(args.data_dir)
            real = sum(1 for _, l in samples if l == 1)
            fake = len(samples) - real
            if not samples:
                raise RuntimeError(f"no videos under {args.data_dir}")
            return f"{len(samples)} videos ({real} real / {fake} fake)"

        check("data dir", data_check)

    print(("PREFLIGHT FAILED" if failures else "ALL CHECKS PASSED"))
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
