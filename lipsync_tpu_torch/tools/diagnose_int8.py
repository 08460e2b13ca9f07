"""Int8 root-cause diagnostic: where does the int8 conv lowering's time go?

    python -m lipsync_tpu_torch.tools.diagnose_int8 \
        --out docs/eval/int8_diagnosis.json [--stages gemm,conv,quant] \
        [--batch 256] [--iters 10] [--max-dim 2048] [--shapes v_stem,...] \
        [--device cuda:0]

The port's counterpart of the JAX package's script ``diagnose_int8``, with
its flags, stages and report keys (its ``--cpu`` is ``--device cpu``
here). It isolates the three possible sinks of the int8 lowering and
writes each stage's result to the output JSON AS IT COMPLETES, so an
interrupted run keeps the earlier stages:

  gemm   — int8 x int8 -> int32 (``torch._int_mm``) against a bf16
           ``torch.matmul`` at n^3 for n in 512, 1024, 2048 (n <=
           ``--max-dim``, itself clamped to 2048): the library's int8 rate
           on plain products. No kernel of the port is involved.
  conv   — each encoder conv geometry of ``CONV_SHAPES`` three ways: the
           bf16 cuDNN convolution; K3 (``int8_conv_int32``) fed
           PRE-QUANTIZED int8 tensors (pure conv cost); the whole
           ``models/layers.py::int8_conv`` (K4's quantize, then K3 with its
           dequantizing epilogue). Each row also says whether K3's int32
           accumulators equal its plain twin's (``int8_acc_equals_twin``).
  quant  — K4 alone (``absmax_quantize``: the per-tensor scale and the int8
           activation in one launch) on bf16 activations of the first four
           geometries. The port dequantizes in K3's epilogue, so
           ``qdq_ms`` is the quantize alone.

The JAX script's ``v5e_bf16_peak_tops`` and ``v5e_int8_peak_tops`` are
TPU figures; they stay in the report as null, and the card's own peaks
(``utils/device.py::card_peaks``; null on the CPU) stand beside them as
``bf16_peak_tops`` and ``int8_peak_tops``. Each time is the median over
``--iters`` calls after a warm one, between two CUDA events on the card
(``tools/common.py::median_call_s``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from lipsync_tpu_torch.tools.common import add_device_argument, median_call_s

# The encoder conv shapes that carry the model's conv FLOPs (visual stem +
# stages, audio stem + stages): (name, input NDHWC/NHWC shape sans batch,
# kernel, cin, cout, stride), as the JAX script lists them.
CONV_SHAPES = [
    ("v_stem", (32, 96, 96, 3), (3, 7, 7), 3, 64, (1, 2, 2)),
    ("v_l1", (32, 24, 24, 64), (3, 3, 3), 64, 64, (1, 1, 1)),
    ("v_l2", (32, 24, 24, 64), (3, 3, 3), 64, 128, (1, 2, 2)),
    ("v_l3", (32, 12, 12, 128), (3, 3, 3), 128, 256, (1, 2, 2)),
    ("v_l4", (32, 6, 6, 256), (3, 3, 3), 256, 256, (1, 1, 1)),
    ("a_stem", (80, 128, 1), (7, 7), 1, 64, (2, 2)),
    ("a_l2", (20, 32, 64), (3, 3), 64, 128, (2, 2)),
]


def _flush(out_path: Path, result: dict) -> None:
    out_path.write_text(json.dumps(result, indent=1))


def stage_gemm(result: dict, args, out_path: Path, device) -> None:
    """Raw matmul rate: int8 x int8 -> int32 vs bf16 at n^3, n <= 2048."""
    rows = []
    rng = np.random.RandomState(0)
    for n in (512, 1024, 2048):
        if n > args.max_dim:
            continue
        a8 = torch.from_numpy(
            rng.randint(-127, 128, size=(n, n)).astype(np.int8)).to(device)
        b8 = torch.from_numpy(
            rng.randint(-127, 128, size=(n, n)).astype(np.int8)).to(device)
        abf = torch.from_numpy(rng.randn(n, n)).to(device, torch.bfloat16)
        bbf = torch.from_numpy(rng.randn(n, n)).to(device, torch.bfloat16)
        t_i8 = median_call_s(lambda: torch._int_mm(a8, b8), device,
                             iters=args.iters)
        t_bf = median_call_s(lambda: torch.matmul(abf, bbf), device,
                             iters=args.iters)
        flops = 2.0 * n ** 3
        row = {
            "n": n,
            "int8_tops": flops / t_i8 / 1e12,
            "bf16_tops": flops / t_bf / 1e12,
            "int8_over_bf16": t_bf / t_i8,
        }
        print(f"[gemm] {row}", file=sys.stderr, flush=True)
        rows.append(row)
        result.setdefault("gemm", {})["rows"] = rows
        _flush(out_path, result)


def conv_operands(rng, ishape, ks, cin, cout, batch: int):
    """``(x, k, x8, k8)`` as the JAX script draws them: fp32 ``x`` (B,
    *ishape) channels-last and ``k`` (*ks, cin, cout), and their int8
    roundings ``clip(round(x * 20))`` and ``clip(round(k * 500))``."""
    x = rng.randn(batch, *ishape).astype(np.float32)
    k = rng.randn(*ks, cin, cout).astype(np.float32) * 0.05
    x8 = np.clip(np.round(x * 20), -127, 127).astype(np.int8)
    k8 = np.clip(np.round(k * 500), -127, 127).astype(np.int8)
    return x, k, x8, k8


def torch_weight(k: np.ndarray) -> np.ndarray:
    """``(*ks, cin, cout)`` -> torch's ``(cout, cin, *ks)``."""
    return np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1)))


def int8_prequant(x8: torch.Tensor, k8: torch.Tensor, strides):
    """K3's int32 entry on channels-last int8 ``x8`` (B, *spatial, cin) and
    ``k8`` (*ks, cin, cout): the int32 (B, *out, cout) accumulators, with
    ``k // 2`` zero padding as the JAX script pads."""
    from lipsync_tpu_torch.ops.kernels.int8_conv import int8_conv_int32

    w = k8.movedim(-1, 0).contiguous()  # (cout, *ks, cin)
    pads = tuple(d // 2 for d in k8.shape[:-2])
    return int8_conv_int32(x8, w, tuple(strides), pads)


def stage_conv(result: dict, args, out_path: Path, device) -> None:
    """Per-shape conv cost: bf16 vs pre-quantized int8 (K3) vs the whole
    int8 convolution (K4 -> K3 with its dequantizing epilogue)."""
    import torch.nn.functional as F

    from lipsync_tpu_torch.models.layers import int8_conv
    from lipsync_tpu_torch.ops.kernels.int8_conv import int8_conv_plain

    rng = np.random.RandomState(1)
    rows = []
    shapes = CONV_SHAPES
    if args.shapes:
        keep = set(args.shapes.split(","))
        shapes = [s for s in CONV_SHAPES if s[0] in keep]
    for name, ishape, ks, cin, cout, strides in shapes:
        b = args.batch
        x, k, x8, k8 = conv_operands(rng, ishape, ks, cin, cout, b)
        pads = tuple(d // 2 for d in ks)
        conv = F.conv2d if len(ks) == 2 else F.conv3d
        xbf = torch.from_numpy(x).to(device, torch.bfloat16)
        wbf = torch.from_numpy(torch_weight(k)).to(device, torch.bfloat16)
        x8d = torch.from_numpy(x8).to(device)
        k8d = torch.from_numpy(k8).to(device)
        xbf_cf = xbf.movedim(-1, 1)  # channels-first view of NDHWC data

        def conv_bf():
            return conv(xbf_cf, wbf, stride=strides, padding=pads)

        def full_i8():
            return int8_conv(xbf_cf, wbf, None, strides, pads)

        t_bf = median_call_s(conv_bf, device, iters=args.iters)
        t_i8 = median_call_s(lambda: int8_prequant(x8d, k8d, strides),
                             device, iters=args.iters)
        t_full = median_call_s(full_i8, device, iters=args.iters)
        acc = int8_prequant(x8d, k8d, strides)
        twin = int8_conv_plain(x8d, k8d.movedim(-1, 0).contiguous(),
                               strides, pads)
        # FLOPs: 2 * out_elems * cin * prod(ks)
        out_spatial = [(d + s_ - 1) // s_
                       for d, s_ in zip(ishape[:-1], strides)]
        out_elems = b * int(np.prod(out_spatial)) * cout
        flops = 2.0 * out_elems * cin * int(np.prod(ks))
        row = {
            "shape": name,
            "bf16_ms": t_bf * 1e3,
            "int8_prequant_ms": t_i8 * 1e3,
            "int8_full_ms": t_full * 1e3,
            "bf16_tops": flops / t_bf / 1e12,
            "int8_prequant_tops": flops / t_i8 / 1e12,
            "prequant_speedup_vs_bf16": t_bf / t_i8,
            "full_speedup_vs_bf16": t_bf / t_full,
            "quant_overhead_ms": (t_full - t_i8) * 1e3,
            "int8_acc_equals_twin": bool(torch.equal(acc, twin)),
        }
        print(f"[conv] {row}", file=sys.stderr, flush=True)
        rows.append(row)
        result.setdefault("conv", {"batch": args.batch})["rows"] = rows
        _flush(out_path, result)


def stage_quant(result: dict, args, out_path: Path, device) -> None:
    """K4 alone at model activation sizes (bf16 inputs)."""
    from lipsync_tpu_torch.models.layers import absmax_quantize

    rng = np.random.RandomState(2)
    rows = []
    for name, ishape, *_ in CONV_SHAPES[:4]:
        x = torch.from_numpy(rng.randn(args.batch, *ishape)).to(
            device, torch.bfloat16)
        x_cf = x.movedim(-1, 1)
        t = median_call_s(lambda: absmax_quantize(x_cf), device,
                          iters=args.iters)
        mb = float(np.prod(x.shape)) * 2 / 1e6
        row = {"shape": name, "qdq_ms": t * 1e3,
               "activation_mb_bf16": mb,
               "effective_gbps": mb / 1e3 / t}
        print(f"[quant] {row}", file=sys.stderr, flush=True)
        rows.append(row)
        result.setdefault("quant", {"batch": args.batch})["rows"] = rows
        _flush(out_path, result)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--stages", default="gemm,conv,quant")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--max-dim", type=int, default=2048,
                   help="hard cap on GEMM size (clamped to 2048)")
    p.add_argument("--shapes", default=None,
                   help="comma list filtering the conv-stage shapes")
    p.add_argument("--out", type=Path,
                   default=Path("docs/eval/int8_diagnosis.json"))
    add_device_argument(p)
    args = p.parse_args(argv)
    args.max_dim = min(args.max_dim, 2048)

    from lipsync_tpu_torch.utils.device import (
        device_peaks,
        disable_tf32,
        get_device,
    )

    device = get_device(args.device)
    disable_tf32()
    card = device_peaks(device)
    result = {"platform": device.type, "batch": args.batch,
              "v5e_bf16_peak_tops": None, "v5e_int8_peak_tops": None,
              "bf16_peak_tops": card.bf16 / 1e12 if card else None,
              "int8_peak_tops": card.int8 / 1e12 if card else None}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for stage in args.stages.split(","):
        print(f"[diagnose_int8] stage {stage}", file=sys.stderr, flush=True)
        {"gemm": stage_gemm, "conv": stage_conv, "quant": stage_quant}[
            stage.strip()](result, args, args.out, device)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
