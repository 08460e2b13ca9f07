"""K4: per-tensor int8 quantization of an activation
(``csrc/int8_quant.cu``), its wrappers and their twins.

The JAX package's quantized serving lowering (``models/layers.py::
Int8Conv``) quantizes each convolution's input per tensor, symmetric:
``s = max(max|x| / 127, 1e-12)`` and ``clip(round(x / s), -127, 127)`` as
int8, an elementwise chain that XLA fuses. The port does it in two
launches around the mesh's reduction of the scale: :func:`absmax` (one
read of the frames this shard owns) and :func:`quantize` (one read of
``x`` in its own layout and dtype, one int8 write, channels-last, ready
for K3). Each counts as one launch of K4.

The twins (:func:`absmax_plain`, :func:`quantize_plain`) are the torch
chain the port ran before K4; the wrappers take them only for a CPU
tensor. For a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from lipsync_tpu_torch.ops.kernels import build

# Launches of the CUDA kernels in this process (the CPU twins do not
# count), in all and by device.
launches = 0
launches_by_device: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def absmax_plain(x: torch.Tensor,
                 frames: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Twin of :func:`absmax`: ``max|x|`` in fp32 over ``x[:, :, lo:hi]``
    (all of ``x`` without ``frames``), a 0-dim tensor."""
    x32 = x.float()
    owned = x32 if frames is None else x32[:, :, frames[0]:frames[1]]
    return owned.abs().max()


def quantize_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`quantize`: :func:`quantize_int8` of ``x`` in fp32,
    moved to channels-last and made contiguous."""
    return quantize_int8(x.float(), scale).movedim(1, -1).contiguous()


def layout_of(x: torch.Tensor) -> str:
    """How the kernels read ``x`` (N, C, *spatial): ``"channels_last"``
    when each sample's values lie contiguous in (*spatial, C) order,
    ``"channels_first"`` when each channel's voxels lie contiguous; raises
    for any other layout."""
    if x.movedim(1, -1)[0].is_contiguous():
        return "channels_last"
    if x[0, 0].is_contiguous():
        return "channels_first"
    raise ValueError(f"unsupported layout: shape {tuple(x.shape)}, strides "
                     f"{x.stride()}")


def _check(x: torch.Tensor) -> None:
    if x.dim() not in (4, 5):
        raise ValueError(f"expected a 2-d or 3-d channels-first activation, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"activation must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"empty activation {tuple(x.shape)}")


def _runs(t: torch.Tensor):
    """``t``'s elements as at most two levels of rows of contiguous values:
    ``(ra, sa, rb, sb, length)`` in elements, or None."""
    dims = sorted(((s, st) for s, st in zip(t.shape, t.stride()) if s != 1),
                  key=lambda d: -d[1])
    merged = []
    for size, stride in dims:
        if merged and merged[-1][1] == size * stride:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    if not merged:
        return 1, 0, 1, 0, 1
    length, inner = merged.pop()
    if inner != 1 or len(merged) > 2:
        return None
    merged = [(1, 0)] * (2 - len(merged)) + merged
    return merged[0][0], merged[0][1], merged[1][0], merged[1][1], length


def _count(device: torch.device) -> None:
    global launches
    with build.COUNT_LOCK:
        launches += 1
        key = str(device)
        launches_by_device[key] = launches_by_device.get(key, 0) + 1


def absmax(x: torch.Tensor,
           frames: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``max|x|`` over ``x[:, :, lo:hi]`` (all of ``x`` without
    ``frames``; axis 2 is the frame axis of a 3-d activation), as a 0-dim
    fp32 tensor on ``x``'s device. The slice is read in place, never
    copied. Launches K4 for a CUDA tensor; the twin runs only for a CPU
    tensor."""
    _check(x)
    if x.device.type == "cpu":
        return absmax_plain(x, frames)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    owned = x if frames is None else x[:, :, frames[0]:frames[1]]
    if owned.numel() == 0:
        raise ValueError(f"no owned values in {tuple(x.shape)} at {frames}")
    runs = _runs(owned)
    if runs is None:
        raise ValueError(f"unsupported layout: shape {tuple(owned.shape)}, "
                         f"strides {owned.stride()}")
    ra, sa, rb, sb, length = runs
    size = x.element_size()
    vec = int(owned.data_ptr() % 16 == 0
              and all(v * size % 16 == 0 for v in (sa, sb, length)))
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_absmax(owned.data_ptr(), _DTYPES[x.dtype], ra, sa,
                                 rb, sb, length, vec, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"absmax kernel launch failed: cudaError {err}")
    _count(x.device)
    return out


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``clamp(rint(x / scale), -127, 127)`` of ``x`` (N, C,
    *spatial; fp32 or bf16, channels-last or channels-first in memory) as
    a contiguous (N, *spatial, C) tensor; ``scale`` is a one-element fp32
    tensor on ``x``'s device, read there. Launches K4 for a CUDA tensor;
    the twin runs only for a CPU tensor."""
    _check(x)
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"scale must be one float32, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return quantize_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, c = x.shape[:2]
    length = x.numel() // n
    out = torch.empty((n, *x.shape[2:], c), dtype=torch.int8,
                      device=x.device)
    size = x.element_size()
    if layout_of(x) == "channels_last":
        layout, sa, sc = 0, x.stride(0), 0
        vec = int(x.data_ptr() % 16 == 0 and length * size % 16 == 0
                  and (n == 1 or sa * size % 16 == 0))
    else:
        layout, sa, sc, length, vec = 1, x.stride(0), x.stride(1), \
            length // c, 0
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_quantize(x.data_ptr(), _DTYPES[x.dtype], layout, n,
                                   sa, sc, c, length, vec, scale.data_ptr(),
                                   out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    _count(x.device)
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("int8_quant")
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.lipsync_absmax.argtypes = [p, i, ll, ll, ll, ll, ll, i, p, p]
    lib.lipsync_absmax.restype = i
    lib.lipsync_quantize.argtypes = [p, i, i, ll, ll, ll, i, ll, i, p, p, p]
    lib.lipsync_quantize.restype = i
    return lib
