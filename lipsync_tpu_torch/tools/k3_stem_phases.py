"""Where K3's halo loop (the stems' main loop) spends its time.

Builds ``csrc/int8_conv.cu`` as it is and once more for each phase cut out
of the halo kernel (the widening of the staged rows, the MMA, the output
stores), then times each build at the two stems of ``ModelConfig()`` at
16 windows (R2's bucket), with int32, fp32 and bf16 outputs, by
``torch.profiler`` device time and by CUDA events per call. A cut build's
output is wrong by design: only its time means anything, and the time it
saves is what that phase costs where it does not overlap the others. The
full build is checked against the twin. Prints one JSON line per build
and output, and the card's name and power limit.

    python3 -m lipsync_tpu_torch.tools.k3_stem_phases [--parent DIR]

Needs ``nvcc`` and a card (cuda:0). ``--parent DIR`` instead times K3 at
the stems as another checkout of the
repository (``git archive`` of a parent commit unpacked in ``DIR``)
builds and runs it, against this one, in turns: parent, this, this,
parent, each in a process of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from lipsync_tpu_torch.ops.kernels import build
from lipsync_tpu_torch.ops.kernels import int8_conv as k3

# Each cut: the text of the halo kernel that runs the phase, and what
# takes its place.
CUTS = {
    "no_widen": ("      widen(decode(t + tstep), b ^ 1, "
                 "halo + (b ^ 1) * hwords);\n", ""),
    "no_mma": ("for (int kb = 0; kb < hp.kblocks; ++kb) {",
               "for (int kb = 0; kb < 0; ++kb) {"),
    "no_store": ("if (col < g.cout) {\n          store_pair",
                 "if (col < g.cout && acc[0] == 123456789) {\n"
                 "          store_pair"),
}
OUT_DTYPES = (torch.int32, torch.float32, torch.bfloat16)
# The visual and audio stems at 16 windows: channels-last input and weight
# shapes, stride, padding.
STEMS = {
    "visual": ((16, 32, 96, 96, 3), (64, 3, 7, 7, 3), (1, 2, 2), (1, 3, 3)),
    "audio": ((16, 80, 128, 1), (64, 7, 7, 1), (2, 2), (3, 3)),
}


def build_variants(source: Path, out_dir: Path) -> dict:
    """One shared library per variant, all ``nvcc`` at once."""
    text = source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cut in {"full": None, **CUTS}.items():
        body = text
        if cut is not None:
            if cut[0] not in body:
                raise ValueError(f"{source} has no marker for {name}")
            body = body.replace(cut[0], cut[1])
        src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(body)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib_path: Path):
    """K3's wrappers launching from ``lib_path`` in place of the package's
    build."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.lipsync_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 23 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    saved = k3._library
    k3._library = lambda: lib
    try:
        yield
    finally:
        k3._library = saved


def device_ms(fn, iters: int = 10, kernel: str = "int8_conv_halo_kernel"
              ) -> float:
    """Profiler time per call of the kernels whose names hold ``kernel``,
    the median of three traces that recorded them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if kernel in e.key)
        if total > 0:
            runs.append(total / iters / 1e3)
        if len(runs) == 3:
            break
    if not runs:
        raise RuntimeError(f"no trace recorded {kernel}")
    return sorted(runs)[len(runs) // 2]


def event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def operands(dev):
    """Seeded int8 operands of the two stems and the twin's sums."""
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for name, (xs, ws, stride, pad) in STEMS.items():
        x, w = (torch.randint(-127, 128, s, generator=gen, device=dev,
                              dtype=torch.int16).to(torch.int8)
                for s in (xs, ws))
        data[name] = (x, w, stride, pad,
                      k3.int8_conv_plain(x, w, stride, pad))
    return data, torch.rand(64, generator=gen, device=dev) * 1e-4


def stem_times(dev) -> None:
    """K3 at the stems as the imported package builds it: int32 and fp32
    out, profiler (every ``int8_conv`` kernel) and event times."""
    data, scale = operands(dev)
    for name, (x, w, stride, pad, want) in data.items():
        row = {"package": str(Path(k3.__file__).parents[3]), "conv": name,
               "equal": bool(torch.equal(
                   k3.int8_conv_int32(x, w, stride, pad), want))}
        for tag, fn in (
                ("int32", lambda: k3.int8_conv_int32(x, w, stride, pad)),
                ("float32", lambda: k3.int8_conv_dequant(
                    x, w, scale, None, torch.float32, stride, pad))):
            row[f"{tag}_device_ms"] = device_ms(fn, kernel="int8_conv_")
            row[f"{tag}_ms"] = event_ms(fn)
        print(json.dumps(row), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--stems-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_stem_phases: CUDA is not available")
    dev = torch.device("cuda", 0)
    if args.stems_only:
        stem_times(dev)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    if args.parent is not None:
        here = Path(__file__).resolve().parents[2]
        for root in (args.parent, here, here, args.parent):
            subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--stems-only"],
                cwd=root, check=True,
                env={**os.environ, "PYTHONPATH": str(root.resolve())})
        return
    libs = build_variants(build.CSRC / "int8_conv.cu",
                          build.BUILD_DIR / "stem_phases")
    data, scale = operands(dev)
    for variant, lib in libs.items():
        with using(lib):
            for name, (x, w, stride, pad, want) in data.items():
                row = {"variant": variant, "conv": name,
                       "x": list(x.shape), "w": list(w.shape)}
                if variant == "full":
                    got = k3.int8_conv_int32(x, w, stride, pad)
                    row["equal"] = bool(torch.equal(got, want))
                for dt in OUT_DTYPES:
                    if dt == torch.int32:
                        fn = lambda: k3.int8_conv_int32(  # noqa: E731
                            x, w, stride, pad)
                    else:
                        fn = lambda dt=dt: k3.int8_conv_dequant(  # noqa
                            x, w, scale, None, dt, stride, pad)
                    tag = str(dt).removeprefix("torch.")
                    row[f"{tag}_device_ms"] = device_ms(fn)
                    row[f"{tag}_ms"] = event_ms(fn)
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
