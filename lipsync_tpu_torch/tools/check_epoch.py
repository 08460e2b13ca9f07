"""Print checkpoint metadata (epoch, metrics, geometry).

    python -m lipsync_tpu_torch.tools.check_epoch weights/latest [more...]

The port's counterpart of the JAX package's script ``check_epoch``: a
thin checkpoint inspector over ``training/checkpoints.py::load_metadata``
(the ``metadata.json`` beside a checkpoint's ``model.pth``). Host only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from lipsync_tpu_torch.training.checkpoints import load_metadata


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        argv = ["weights/latest"]
    for path in argv:
        meta = load_metadata(Path(path))
        print(f"{path}: {json.dumps(meta, indent=2) if meta else '(no metadata)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
