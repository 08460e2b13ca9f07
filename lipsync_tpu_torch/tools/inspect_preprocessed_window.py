"""Visualize sampled training windows from a precomputed tensor dir.

    python -m lipsync_tpu_torch.tools.inspect_preprocessed_window \
        --preprocessed-dir pre --index 0 --out window.png

The port's counterpart of the JAX package's
script ``inspect_preprocessed_window``, with its flags and printed
lines: sample a window exactly as training does
(``training/data.py::LipSyncDataset`` in preprocessed mode, on the host)
and dump a contact-sheet PNG and its stats. Only the plotting is optional:
where matplotlib does not import, the tool says "(plotting skipped: ...)"
after the window has been read and its stats printed.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.training.data import LipSyncDataset


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description="Visualize a sampled training window from a precomputed "
                    "tensor dir.")
    p.add_argument("--preprocessed-dir", type=Path, required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--train-mode", action="store_true")
    p.add_argument("--out", type=Path, default=Path("window.png"))
    args = p.parse_args(argv)

    ds = LipSyncDataset(preprocessed_dir=args.preprocessed_dir)
    sample = ds.get_item(args.index, train_mode_override=args.train_mode)
    if sample is None:
        raise SystemExit(f"Sample {args.index} failed to load")
    visual, audio, label = sample
    print(f"sample {args.index}: label={int(label)} "
          f"visual={visual.shape} [{visual.min():.3f},{visual.max():.3f}] "
          f"audio={audio.shape} [{audio.min():.1f},{audio.max():.1f}] dB")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = visual.shape[0]
        cols = 8
        rows = -(-t // cols) + 1
        fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.2, rows * 1.4))
        for i in range(rows * cols):
            ax = axes.flat[i]
            ax.axis("off")
            if i < t:
                ax.imshow(visual[i])
        # Mel spectrogram across the bottom row.
        gs = axes[-1, 0].get_gridspec()
        for ax in axes[-1, :]:
            ax.remove()
        mel_ax = fig.add_subplot(gs[-1, :])
        mel_ax.imshow(audio, aspect="auto", origin="lower")
        mel_ax.set_title("mel (dB)", fontsize=8)
        fig.suptitle(f"sample {args.index} label={int(label)}")
        fig.tight_layout()
        fig.savefig(args.out, dpi=110)
        print(f"Saved {args.out}")
    except Exception as e:
        print(f"(plotting skipped: {e})")
    return sample


if __name__ == "__main__":
    main()
