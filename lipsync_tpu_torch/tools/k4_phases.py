"""Where K4's single launch (``int8_quant.absmax_quantize``) spends its
time, against the two-launch ``absmax`` + ``quantize`` it replaces outside
a mesh.

Builds ``csrc/int8_quant.cu`` as it is and once more for each variant
below, then times each build's single launch at the int8 encoder inputs
of ``ModelConfig()`` at 16 windows (R2's bucket; fp32, channels-last, as
the serving path gives them) and at 128 windows on layer1's, by
``torch.profiler`` device time, with the pair timed before and after them
(pair, variants, pair). Build variants:

- ``no_phase_b``: Phase A and the scale only (no int8 written);
- ``no_sync``: no grid barrier (each block quantizes with its own scale);
- ``unroll8``: eight 16-byte loads in flight a thread, not four;
- ``no_l2_hints``: the L2 ``evict_normal`` policy for every load;
- ``ieee_div``: each value divided by the scale with ``__fdiv_rn`` (as the
  two-launch ``quantize`` does), not by the reciprocal and two FMA
  corrections;

and a run-time variant of the full build, ``stream_all`` (nothing kept in
shared memory: every value read twice, the second time through L2).
A cut build's output is wrong by design: only its time means anything.
The full build is held against the twin bit for bit, and its per-call
time (CUDA events, host launch included) is taken with the pair's. Prints
one JSON line per geometry, and the card's name and power limit.

    python3 -m lipsync_tpu_torch.tools.k4_phases

Needs ``nvcc`` and a card (cuda:0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from lipsync_tpu_torch.ops.kernels import build
from lipsync_tpu_torch.ops.kernels import int8_quant as k4

VARIANTS = {
    "no_phase_b": [(
        "  // Phase B: the streamed units, last read first; then the kept "
        "ones.\n", "  return;\n")],
    "no_sync": [("  cooperative_groups::this_grid().sync();\n", "")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "no_l2_hints": [("L2::evict_last.b64", "L2::evict_normal.b64"),
                    ("L2::evict_first.b64", "L2::evict_normal.b64")],
    "ieee_div": [("  float q = __fmul_rn(v, d.r);\n",
                  "  return quant(v, d.s);\n  float q = __fmul_rn(v, d.r);\n")],
}
# (N, C, *spatial) of the int8 encoder inputs at 16 windows, and layer1's
# at 128.
INPUTS = {
    "visual_stem": (16, 3, 32, 96, 96),
    "visual_layer1": (16, 64, 32, 24, 24),
    "visual_layer2_c2": (16, 128, 32, 12, 12),
    "visual_layer3_c2": (16, 256, 32, 6, 6),
    "visual_layer4_c2": (16, 256, 32, 3, 3),
    "audio_stem": (16, 1, 80, 128),
    "audio_layer1": (16, 64, 40, 32),
    "audio_layer3_c2": (16, 256, 10, 16),
    "visual_layer1_b128": (128, 64, 32, 24, 24),
}
NEW = ("absmax_quantize_kernel",)
OLD = ("absmax_kernel", "quant_rows_kernel", "quant_transpose_kernel")


def build_variants(out_dir: Path) -> dict:
    """One shared library per build variant, all ``nvcc`` at once."""
    text = (build.CSRC / "int8_quant.cu").read_text()
    procs = {}
    for name, subs in {"full": [], **VARIANTS}.items():
        body = text
        for old, new in subs:
            if old not in body:
                raise ValueError(f"int8_quant.cu has no marker for {name}")
            body = body.replace(old, new)
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
        libs[name] = k4.bind(ctypes.CDLL(str(lib)))
    return libs


def device_ms(fn, names, iters: int = 20) -> float:
    """Median over three profiler traces of the device time per call of
    ``fn`` in the kernels named ``names``."""
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
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(n in e.key for n in names))
        if total > 0:
            runs.append(total)
        if len(runs) == 3:
            break
    if not runs:
        raise RuntimeError(f"no profiler trace recorded {names}")
    return statistics.median(runs) / iters / 1e3


def events_ms(fn, iters: int = 20) -> float:
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


def launcher(lib, x, plan, w_scale):
    """The single launch of ``lib`` on ``x`` by ``plan``, into buffers
    allocated once."""
    c_plan = k4.plan_struct(plan, 0)
    out = torch.empty((plan.n, *x.shape[2:], plan.c), dtype=torch.int8,
                      device=x.device)
    buf = torch.empty(1 + w_scale.numel() + plan.grid, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.lipsync_absmax_quantize(
            ctypes.byref(c_plan), x.data_ptr(), buf.data_ptr(),
            w_scale.data_ptr(), w_scale.numel(), out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return run


def main() -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        for name, shape in INPUTS.items():
            n, c, *sp = shape
            x = torch.randn(n, *sp, c, generator=gen, device=dev).movedim(
                -1, 1)
            w_scale = torch.rand(c, generator=gen, device=dev)
            q, s, sc = k4.absmax_quantize(x, w_scale)
            q2, s2, sc2 = k4.absmax_quantize_plain(x, w_scale)
            torch.cuda.synchronize()
            equal = (torch.equal(q, q2) and torch.equal(s, s2)
                     and torch.equal(sc, sc2))
            del q, q2

            def pair():
                scale = torch.clamp(k4.absmax(x) * k4.INV_127, min=1e-12)
                return k4.quantize(x, scale), scale * w_scale

            def blocks_of(lib):
                def blocks(mode, smem):
                    out = ctypes.c_int(0)
                    err = lib.lipsync_absmax_quantize_blocks(
                        0, mode, smem, ctypes.byref(out))
                    if err:
                        raise RuntimeError(f"cudaError {err}")
                    return out.value
                return blocks

            row = {"input": name, "shape": list(shape),
                   "mbytes": 4 * x.numel() / 1e6, "equal": equal,
                   "bound_ms": 5 * x.numel() / 3.35e12 * 1e3,
                   "pair_device_ms": [device_ms(pair, OLD)]}
            for vname, lib in libs.items():
                plan = k4.fused_plan(tuple(x.shape), x.stride(),
                                     "channels_last", 4, True, sms,
                                     blocks_of(lib))
                run = launcher(lib, x, plan, w_scale)
                row[f"{vname}_device_ms"] = device_ms(run, NEW)
                if vname == "full":
                    row["plan"] = {k: getattr(plan, k) for k in (
                        "grid", "smem", "cap", "units")}
                    flat = dataclasses.replace(
                        plan, cap=0, smem=0,
                        grid=blocks_of(lib)(0, 0) * sms)
                    run_flat = launcher(lib, x, flat, w_scale)
                    row["stream_all_device_ms"] = device_ms(run_flat, NEW)
            row["pair_device_ms"].append(device_ms(pair, OLD))
            fused = lambda: k4.absmax_quantize(x, w_scale)  # noqa: E731
            row["pair_ms"] = [events_ms(pair)]
            row["full_ms"] = [events_ms(fused), events_ms(fused)]
            row["pair_ms"].append(events_ms(pair))
            print(json.dumps(row), flush=True)
            del x
            torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
