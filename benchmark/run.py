"""Run one cell of the benchmark on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration file and a traffic mix (``benchmark/traffic/<mix>.py``); the
mix builds the program (``lipsync_tpu_torch``) and its inputs from the seed,
warms up the shapes it will use (set-up, ``setup_s``), drives the program
for ``--seconds`` (the window), then frees it and decides ``correct`` by
comparing what the window produced with the plain reference
(``benchmark/reference``). ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` profiles the window and reports its per-layer
metrics (``benchmark/metrics/<name>.py``), with ``busy_s``, ``window_s``
and a breakdown of device time and idle gaps.

The last line of standard output is one JSON object; the numbers compared
for ``correct`` are the last lines of standard error. Without a CUDA card,
or with fewer cards than the cell asks for, the run prints no result and
exits 2; if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional, Sequence  # noqa: E402

from benchmark.core import cell as cells  # noqa: E402
from benchmark.core.report import (  # noqa: E402
    checks_correct,
    device_info,
    emit,
    forbidden_modules,
)
from benchmark.core.peaks import power_limit_w  # noqa: E402
from benchmark.core.spans import Spans  # noqa: E402
from benchmark.core.trace import Trace  # noqa: E402


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only the first run of a checkout builds (the program's own kernels
    build into ``build/lipsync_tpu_torch_kernels`` there already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def subseed(seed: int, tag: str) -> int:
    """A 62-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 2


@dataclasses.dataclass
class Context:
    """What a mix gets: the configuration file's contents, the seed, the
    window's length, the device, the span recorder, and the faults a test
    plants (names a mix knows)."""

    config: Dict[str, Any]
    seed: int
    seconds: float
    device: Any
    spans: Spans
    faults: Sequence[str] = ()
    scale: Dict[str, Any] = dataclasses.field(default_factory=dict)
    t_start: float = T_START

    def subseed(self, tag: str) -> int:
        return subseed(self.seed, tag)

    def note(self, what: str) -> None:
        """A stage's end, with the seconds since the run began, on
        standard error."""
        print(f"[+{time.perf_counter() - self.t_start:.3f}s] {what}",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader gets after a traced window."""

    ctx: Context
    result: Dict[str, Any]
    trace: Trace


def refuse_forbidden() -> None:
    """Exit 3, printing no result, if JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float = T_START, faults: Sequence[str] = (),
            scale: Optional[Dict[str, Any]] = None, out=None) -> Dict:
    """Set-up, window, comparison and result of one run of ``cell``
    (``scale`` shrinks a mix's sizes for a rehearsal on the CPU; the
    command never passes it)."""
    import torch

    ctx = Context(cell.config, int(seed), float(seconds), device,
                  Spans(trace), tuple(faults), dict(scale or {}), t_start)
    ctx.note("imports")
    mix = cell.mix
    state = mix.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    tr = Trace(trace, span_names=mix.SPANS)
    with tr.run(ctx.spans):
        result = mix.window(state, ctx)
    refuse_forbidden()
    dev = device_info(device, cell.chips,
                      power_limit_w() if device.type == "cuda" else None)
    checks = mix.check(state, ctx)
    del state
    metrics: Dict[str, tuple] = {}
    breakdown = None
    if not trace:
        values = dict(mix.end_to_end(result), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = (values[m["name"]], m["unit"])
    else:
        view = View(ctx, result, tr)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    refuse_forbidden()
    return emit(checks_correct(checks), result["attempted"],
                result["failed"], metrics, dev, checks, breakdown, out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(cells.ROOT)
    bench = cells.load_benchmark()
    cell = cells.resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    execute(cell, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
