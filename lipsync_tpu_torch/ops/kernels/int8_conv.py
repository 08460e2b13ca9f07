"""K3: the int8 implicit-GEMM convolution (``csrc/int8_conv.cu``), its
wrapper and its twin.

The JAX package's quantized serving lowering (``models/layers.py::
Int8Conv``) convolves int8 activations with int8 weights into int32
(``lax.conv_general_dilated(..., preferred_element_type=int32)``, an XLA
convolution). PyTorch has no CUDA convolution that accumulates int8 in
int32 (``F.conv*`` on int8 tensors accumulates in int8 and wraps), so the
port launches K3 for a CUDA tensor. The twin (:func:`int8_conv_plain`)
convolves the int8 values in float64 and casts to int32: exact, since
|acc| <= 127^2 x 6912 < 2^53 for every encoder convolution (float32 is not
exact past 2^24). It runs only for a CPU tensor.

Layouts are channels-last: activations ``(N, [D,] H, W, C_in)``, weights
``(C_out, [kD,] kH, kW, C_in)``, output ``(N, [Do,] Ho, Wo, C_out)``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build

K_STEP = 32  # the kernel's K per step; weights are zero-padded to it

# Launches of the CUDA kernel in this process (the CPU twin does not count),
# in all and by device.
launches = 0
launches_by_device: Dict[str, int] = {}


def out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def gemm_dims(x_shape: Sequence[int], w_shape: Sequence[int],
              stride: Sequence[int], padding: Sequence[int]
              ) -> Tuple[int, int, int]:
    """``(M, N, K)`` of the convolution as a GEMM: output voxels, output
    channels, taps x input channels (before the padding of K to 32)."""
    spatial = [out_size(n, k, s, p) for n, k, s, p in
               zip(x_shape[1:-1], w_shape[1:-1], stride, padding)]
    m = x_shape[0]
    for v in spatial:
        m *= v
    k = 1
    for v in w_shape[1:]:
        k *= v
    return m, w_shape[0], k


def _check(x: torch.Tensor, w: torch.Tensor, stride, padding) -> int:
    nd = x.dim() - 2
    if nd not in (2, 3) or w.dim() != x.dim():
        raise ValueError(f"expected 2-d or 3-d channels-last operands, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"operands must be int8, got {x.dtype}, {w.dtype}")
    if x.shape[-1] != w.shape[-1]:
        raise ValueError(f"input channels differ: {x.shape[-1]} vs "
                         f"{w.shape[-1]}")
    if len(stride) != nd or len(padding) != nd:
        raise ValueError(f"stride {stride} / padding {padding} for {nd}-d")
    return nd


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int]
                    ) -> torch.Tensor:
    """Twin of the kernel in plain PyTorch: the int8 values convolved in
    float64, cast to int32, channels-last."""
    nd = _check(x, w, stride, padding)
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(x.movedim(-1, 1).double(), w.movedim(-1, 1).double(),
             stride=tuple(stride), padding=tuple(padding))
    return y.movedim(1, -1).to(torch.int32).contiguous()


def int8_conv_int32(x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int]
                    ) -> torch.Tensor:
    """int8 ``x`` (N, [D,] H, W, C_in) convolved with int8 ``w`` (C_out,
    [kD,] kH, kW, C_in), zero padding, into int32 (N, [Do,] Ho, Wo,
    C_out). Launches K3 for a CUDA tensor; the twin runs only for a CPU
    tensor."""
    global launches
    nd = _check(x, w, stride, padding)
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, stride, padding)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"unsupported devices {x.device}, {w.device}")
    if w.shape[0] % 8:
        raise ValueError(f"C_out must be a multiple of 8, got {w.shape[0]}")
    if nd == 2:  # one frame of a 3-d convolution
        x, w = x.unsqueeze(1), w.unsqueeze(1)
        stride, padding = (1, *stride), (0, *padding)
    x = x.contiguous()
    n, d, h, wd, c = x.shape
    cout, kd, kh, kw, _ = w.shape
    od, oh, ow = (out_size(*a) for a in zip((d, h, wd), (kd, kh, kw),
                                            stride, padding))
    if min(n, od, oh, ow) <= 0:
        raise ValueError(f"empty output for input {tuple(x.shape)}")
    k = kd * kh * kw * c
    kp = -(-k // K_STEP) * K_STEP
    wp = F.pad(w.reshape(cout, k), (0, kp - k)).contiguous()
    vec = int(c % K_STEP == 0 and x.data_ptr() % 16 == 0)
    out = torch.empty((n, od, oh, ow, cout), dtype=torch.int32,
                      device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_int8_conv(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(), n, d, h, wd, c,
            kd, kh, kw, *stride, *padding, od, oh, ow, cout, kp, vec, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {err}")
    with build.COUNT_LOCK:
        launches += 1
        key = str(x.device)
        launches_by_device[key] = launches_by_device.get(key, 0) + 1
    return out[:, 0] if nd == 2 else out


def _library() -> ctypes.CDLL:
    lib = build.library("int8_conv")
    fn = lib.lipsync_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 20 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
