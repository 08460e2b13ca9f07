"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control] [--fault <name>] [--part PART:ACT:MATH]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the comparison that decides ``correct`` (the
program's reading of each number); with ``--control``, also the same
comparison with the reference one precision step below the configuration's
in the program's place (the control's reading); with ``--fault``, the
program with that fault planted (``altered_answer``, ``unchanged_state``,
``half_batch``: the names a mix knows); with ``--part PART:ACT:MATH`` (as
often as wanted; several parts joined by commas), also the comparison
with the reference at the configuration's precision but for those parts,
stored in ``ACT`` and multiplied in ``MATH`` (the reading of a change to
some parts' precision). One JSON line per seed,
with the seconds the comparison took. The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmark import run
from benchmark.core import cell as cells
from benchmark.core.spans import Spans


def one_part(config, key: str, spec: str):
    """The configuration's precision under ``key`` (the one the mix runs)
    with each part's ``act`` and ``math`` that ``spec`` names set:
    ``PART:ACT:MATH``, several joined by commas."""
    precision = {k: dict(v) for k, v in config[key].items()}
    for change in spec.split(","):
        part, act, math_mode = change.split(":")
        precision[part] = {"act": act, "math": math_mode}
    return precision


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[],
                   help="plant a fault the mix knows in the program")
    p.add_argument("--part", action="append", default=[],
                   help="PART:ACT:MATH[,...]: some parts' precision changed")
    args = p.parse_args(argv)
    run.cache_dirs(cells.ROOT)
    cell = cells.resolve(cells.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.Context(cell.config, seed, args.seconds, device,
                          Spans(False), faults=tuple(args.fault))
        state = cell.mix.setup(ctx)
        cell.mix.window(state, ctx)
        t0 = time.perf_counter()
        got = cell.mix.check(state, ctx)
        line = {"workload": cell.name, "seed": seed,
                "check_s": time.perf_counter() - t0,
                "program": {n: v for n, v, _ in got},
                "detail": state.get("detail")}
        if args.control:
            line["control"] = {n: v for n, v, _ in cell.mix.control(state,
                                                                    ctx)}
        for spec in args.part:
            line[spec] = {n: v for n, v, _ in cell.mix.control(
                state, ctx, one_part(ctx.config, cell.mix.PRECISION, spec))}
        print(json.dumps(line), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
