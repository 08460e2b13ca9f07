"""K1's time at the defaults, against another checkout of the repository.

    python3 -m lipsync_tpu_torch.tools.k1_params [--parent DIR]

Times K1 (``ops/kernels/mel.py::log_mel_db``) at the defaults (16 kHz,
n_fft 400, hop 160, 80 mels) at 16384, 65536 (R1's bucket) and 262144
samples, by ``torch.profiler`` device time (the median of three traces)
and by CUDA events per call (host launch included), and where the package
has it, the run-time-sized kernel at the same inputs beside the fixed one
(n_fft = 400 at compile time). Prints one JSON line per size and the
card's name and power limit.

Needs ``nvcc`` and a card (cuda:0). ``--parent DIR`` runs the same in
another checkout (``git archive`` of a parent commit unpacked in ``DIR``),
building its own kernels, and in this one, in turns: parent, this, this,
parent, each in a process of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lipsync_tpu_torch.ops.kernels import mel as k1
from lipsync_tpu_torch.tools.k3_stem_phases import device_ms, event_ms

SAMPLES = (16384, 65536, 262144)


def default_times(dev) -> None:
    """K1 at the defaults as the imported package builds it."""
    rng = np.random.default_rng(0)
    launch = getattr(k1, "_launch", None)  # absent before the sizes
    for n in SAMPLES:
        y = torch.from_numpy(
            (0.2 * rng.standard_normal(n)).astype(np.float32)).to(dev)[None]
        row = {"package": str(Path(k1.__file__).parents[3]), "n": n}
        fns = {"fixed": lambda: k1.log_mel_db(y)}
        if launch is not None:
            t = k1.n_frames_for(n)
            params = dict(sr=k1.SR, n_fft=k1.N_FFT, hop_length=k1.HOP,
                          win_length=k1.N_FFT, n_mels=k1.N_MELS, center=True)
            fns["general"] = lambda: launch(y, params, t, general=True)
            row["general_vs_fixed_db"] = float(
                (fns["general"]() - fns["fixed"]()).abs().max())
        for tag, fn in fns.items():
            row[f"{tag}_device_ms"] = device_ms(fn, kernel="log_mel_kernel")
            row[f"{tag}_ms"] = event_ms(fn)
        print(json.dumps(row), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_params: CUDA is not available")
    dev = torch.device("cuda", 0)
    if args.one:
        default_times(dev)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    if args.parent is None:
        default_times(dev)
        return
    here = Path(__file__).resolve().parents[2]
    for root in (args.parent, here, here, args.parent):
        subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one"],
            cwd=root, check=True,
            env={**os.environ, "PYTHONPATH": str(root.resolve())})


if __name__ == "__main__":
    main()
