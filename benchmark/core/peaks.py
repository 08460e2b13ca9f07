"""The card's published peaks, and the kernels' operations and bytes.

Peaks are NVIDIA's data-sheet dense rates of one H100 SXM (80 GB HBM3) at
its 700 W limit: a roofline or MFU share is stated against them, with the
card's power limit recorded beside it (``power_limit_w``).

Each kernel's least time is the larger of its operations over the peak of
the arithmetic it runs and its bytes over the memory bandwidth, counting
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math
import subprocess
from typing import Optional, Sequence

H100_SXM = {
    "bytes_per_s": 3.35e12,
    "fp32": 67e12,       # fp32 outside the tensor cores (SIMT)
    "tf32": 494.7e12,
    "bf16": 989e12,
    "int8": 1979e12,
}


def peak(kind: str) -> float:
    return H100_SXM[kind]


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi`` (None where it cannot be
    read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def least_seconds(n_bytes: float, ops: float, kind: str) -> float:
    return max(n_bytes / H100_SXM["bytes_per_s"], ops / H100_SXM[kind])


def _out(n: int) -> int:
    """k3 / stride 2 / pad 1."""
    return (n - 1) // 2 + 1


def k2_hf_stem(shape: Sequence[int], elem_bytes: int) -> float:
    """Least seconds of one K2 launch on a ``(B, T, H, W, 3)`` clip:
    the 3x3 Laplacian (3 -> 3), conv1 (3 -> 32, k3, stride (1, 2, 2)) and
    the folded BatchNorm + ReLU; the clip read once, the
    ``(B, T, Ho, Wo, 32)`` output written once, in the clip's dtype. K2
    runs conv1 on the tensor cores in TF32."""
    b, t, h, w, _ = shape
    ho, wo = _out(h), _out(w)
    ops = 2 * b * t * h * w * 3 * 27 + 2 * b * t * ho * wo * 32 * 81 \
        + 2 * b * t * ho * wo * 32
    n_bytes = elem_bytes * (b * t * h * w * 3 + b * t * ho * wo * 32)
    return least_seconds(n_bytes, ops, "tf32")


def k3_int8_conv(x_shape: Sequence[int], w_shape: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int],
                 out_bytes: int) -> float:
    """Least seconds of one K3 launch: an int8 convolution of a
    channels-last ``x`` ``(N, *S, C)`` by ``w`` ``(C_out, *K, C)``, int32
    sums, one output element of ``out_bytes`` per output position and
    channel; ``x`` and ``w`` read once as int8."""
    spatial = x_shape[1:-1]
    taps = w_shape[1:-1]
    outs = [(s + 2 * p - k) // st + 1
            for s, p, k, st in zip(spatial, padding, taps, stride)]
    n_out = x_shape[0] * math.prod(outs) * w_shape[0]
    ops = 2 * n_out * math.prod(taps) * x_shape[-1]
    n_bytes = math.prod(x_shape) + math.prod(w_shape) + n_out * out_bytes
    return least_seconds(n_bytes, ops, "int8")
