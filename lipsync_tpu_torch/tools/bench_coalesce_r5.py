"""Cross-request coalescing A/B: the engine-only matrix.

    python -m lipsync_tpu_torch.tools.bench_coalesce_r5 \
        [--model-path FILE] [--requests 80] [--concurrencies 1,4,8] \
        [--out docs/eval/coalesce_r5.json] [--device cuda:0]

The port's counterpart of the JAX package's script ``bench_coalesce_r5``,
with its flags, JSON keys and markdown table. ``serving/config.py`` ships
``coalesce_requests=True`` (``inference/batcher.py::CoalescingEngine``
merges concurrent requests' windows into shared forwards). This runs the
engine-only matrix {concurrency} x {coalesce off, on} with pre-decoded
windows and ONE engine loaded on ``--device`` shared across all cells
(``tools/bench_serving.py::engine_only_bench``), writes ``--out`` and
prints a markdown table. ``main(..., engine=)`` takes a loaded engine.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

from lipsync_tpu_torch.tools import bench_serving
from lipsync_tpu_torch.tools.common import add_device_argument

REPO = Path(__file__).resolve().parents[2]


def main(argv: Optional[List[str]] = None, engine=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", type=Path, default=None,
                   help="defaults to the shipped weights/flagship")
    p.add_argument("--requests", type=int, default=80)
    p.add_argument("--windows-per-request", type=int, default=6)
    p.add_argument("--coalesce-wait-ms", type=float, default=2.0)
    p.add_argument("--concurrencies", default="1,4,8")
    p.add_argument("--out", type=Path,
                   default=REPO / "docs" / "eval" / "coalesce_r5.json")
    add_device_argument(p)
    args = p.parse_args(argv)

    model_path = args.model_path
    if engine is None:
        from lipsync_tpu_torch.inference.engine import load_engine

        if model_path is None:
            from lipsync_tpu_torch.utils.weights import default_checkpoint

            model_path = default_checkpoint()
            if model_path is None:
                raise SystemExit("no --model-path and no weights/flagship")
        print(f"[coalesce] loading engine once: {model_path}",
              file=sys.stderr)
        engine = load_engine(model_path, device=args.device)

    cells = []
    for conc in [int(c) for c in args.concurrencies.split(",")]:
        for mode in ("off", "on"):
            cell_args = SimpleNamespace(
                model_path=model_path,
                requests=args.requests,
                concurrency=conc,
                coalesce=mode,
                coalesce_wait_ms=args.coalesce_wait_ms,
                windows_per_request=args.windows_per_request,
                device=args.device,
            )
            print(f"[coalesce] concurrency={conc} coalesce={mode}",
                  file=sys.stderr, flush=True)
            cells.append(bench_serving.engine_only_bench(
                cell_args, engine=engine))

    out = {
        "model_path": str(model_path),
        "requests": args.requests,
        "windows_per_request": args.windows_per_request,
        "coalesce_wait_ms": args.coalesce_wait_ms,
        "cells": cells,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=2))
    print(f"[coalesce] wrote {args.out}", file=sys.stderr)

    print("| concurrency | coalesce | QPS | windows/s | p50 ms | p95 ms "
          "| batches | coalesced items |")
    print("|---|---|---|---|---|---|---|---|")
    for c in cells:
        print(f"| {c['concurrency']} | {'on' if c['coalesce'] else 'off'} "
              f"| {c['value']:.2f} | {c['windows_per_sec']:.1f} "
              f"| {c['p50_ms']:.1f} | {c['p95_ms']:.1f} "
              f"| {c['batches_dispatched']} | {c['items_coalesced']} |")
    return out


if __name__ == "__main__":
    main()
