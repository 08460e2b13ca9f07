"""Sanity-check a precomputed tensor directory.

    python -m lipsync_tpu_torch.tools.validate_preprocessed \
        --preprocessed-dir pre

The port's counterpart of the JAX package's
``scripts/validate_preprocessed.py``: every manifest record must load
through ``training/data.py`` and sample a window; prints how many did and
the label balance, and exits with the count that did not. It reads files
only: it takes no ``--device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from lipsync_tpu_torch.training.data import LipSyncDataset


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preprocessed-dir", type=Path, required=True)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)

    ds = LipSyncDataset(preprocessed_dir=args.preprocessed_dir)
    n = min(args.limit, len(ds)) if args.limit else len(ds)
    ok, failed, labels = 0, [], {0: 0, 1: 0}
    for i in range(n):
        s = ds.get_item(i, train_mode_override=False)
        if s is None:
            failed.append(i)
        else:
            ok += 1
            labels[int(s[2])] += 1
    print(f"{ok}/{n} samples load (labels: {labels[1]} real / "
          f"{labels[0]} fake)")
    if failed:
        more = "..." if len(failed) > 20 else ""
        print(f"FAILED indices: {failed[:20]}{more}")
    return len(failed)


if __name__ == "__main__":
    raise SystemExit(main())
