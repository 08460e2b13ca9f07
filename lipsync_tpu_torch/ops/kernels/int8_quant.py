"""K4: per-tensor int8 quantization of an activation
(``csrc/int8_quant.cu``), its wrappers and their twins.

The JAX package's quantized serving lowering (``models/layers.py::
Int8Conv``) quantizes each convolution's input per tensor, symmetric:
``s = max(max|x| / 127, 1e-12)`` and ``clip(round(x / s), -127, 127)`` as
int8, an elementwise chain that XLA fuses. The port has two ways to run
it, each counted as one launch of K4 per CUDA launch:

- :func:`absmax_quantize`, one cooperative launch that reads ``x`` once
  and writes the int8 copy (channels-last, ready for K3), the scale and
  K3's epilogue scale vector, by the launch plan of :func:`fused_plan`;
- :func:`absmax` (one read of the frames this shard owns) and
  :func:`quantize` (one read of ``x``, one int8 write), two launches with
  the mesh's reduction of the scale between them, which the engine's
  in-process shards take.

The twins (:func:`absmax_plain`, :func:`quantize_plain`,
:func:`absmax_quantize_plain`) are the torch chain the port ran before K4;
the wrappers take them only for a CPU tensor. For a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lipsync_tpu_torch.ops.kernels import build

# Launches of the CUDA kernels in this process (the CPU twins do not
# count), in all and by device.
launches = 0
launches_by_device: Dict[str, int] = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# 1/127 rounded to float32. XLA compiles the JAX package's ``max / 127.0``
# into a multiplication by this reciprocal, which rounds a scale differently
# from a true division in some channels and so moves values that sit near a
# half step of the grid; the port multiplies too, to quantize as the
# compiled JAX package does.
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

# The shared memory a block of the single launch may keep values in (the
# kernel adds one tile of scratch in mode 2).
KEEP_BYTES = 216 * 1024


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


def absmax_quantize_plain(x: torch.Tensor,
                          w_scale: Optional[torch.Tensor] = None):
    """Twin of :func:`absmax_quantize`: :func:`absmax_plain`, the scale
    ``clamp(max * INV_127, min=1e-12)``, :func:`quantize_plain` (and
    ``x_scale * w_scale``)."""
    x_scale = torch.clamp(absmax_plain(x) * INV_127, min=1e-12)
    return (quantize_plain(x, x_scale), x_scale,
            None if w_scale is None else x_scale * w_scale)


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


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How the single launch splits one input geometry (a pure function of
    it: :func:`fused_plan`). The work is ``units`` units: in mode 0, 16
    bytes of a channels-last tensor (``unit_values`` values); in mode 1
    (a tensor whose rows do not allow 16-byte loads), one value; in mode 2,
    a tile of ``tc`` channels x ``tv`` voxels of one sample of a
    channels-first tensor, kept at ``pitch`` values a channel. Modes 0-1
    read unit ``u`` at :func:`unit_values`'s offsets and write it to
    ``out[u * unit_values:]``; the ``tail`` values after the last unit of
    a single row are the last block's. Block ``b`` of ``grid`` takes units
    :meth:`share`, keeps the first ``cap`` of them in ``smem`` bytes of
    shared memory (:meth:`kept`) and reads the rest twice through L2."""

    mode: int
    units: int
    unit_values: int
    row_units: int
    row_stride: int
    tail: int
    n: int
    c: int
    nv: int
    sn: int
    sc: int
    tc: int
    tv: int
    pitch: int
    c_tiles: int
    v_tiles: int
    unit_bytes: int
    cap: int
    grid: int
    smem: int

    def share(self, b: int) -> Tuple[int, int]:
        return b * self.units // self.grid, (b + 1) * self.units // self.grid

    def kept(self, b: int) -> Tuple[int, int]:
        u0, u1 = self.share(b)
        return u0, min(u1, u0 + self.cap)


def fused_plan(shape: Tuple[int, ...], stride: Tuple[int, ...], layout: str,
               element_size: int, aligned: bool, sms: int,
               blocks_per_sm: Callable[[int, int], int]) -> FusedPlan:
    """The single launch's plan for an (N, C, *spatial) input of these
    strides and ``layout`` (:func:`layout_of`), ``aligned`` when its data
    starts on 16 bytes, on a card of ``sms`` SMs that fits
    ``blocks_per_sm(mode, smem)`` blocks of ``smem`` bytes on each. The
    grid is every block that fits at once; a block keeps what it would
    take at one block an SM, up to ``KEEP_BYTES``."""
    n, c = shape[0], shape[1]
    nv = int(np.prod(shape[2:], dtype=np.int64))
    tc = tv = pitch = c_tiles = v_tiles = sn = sc = 0
    row_units = row_stride = tail = 0
    if layout == "channels_last":
        length, sa = c * nv, stride[0]
        one_row = n == 1 or sa == length
        vec = 16 // element_size
        if not aligned or not (one_row or (length % vec == 0
                                           and sa % vec == 0)):
            vec = 1
        mode = 0 if vec > 1 else 1
        if one_row:
            units, tail = n * length // vec, n * length % vec
        else:
            row_units, row_stride = length // vec, sa
            units = n * row_units
        unit_bytes, unit_values, scratch = vec * element_size, vec, 0
    else:
        mode, unit_values = 2, 0
        sn, sc = stride[0], stride[1]
        tc = min(c, 32)
        tv = max(32, 2048 // tc // 32 * 32)
        pitch = tv + 4 // element_size
        c_tiles, v_tiles = -(-c // tc), -(-nv // tv)
        units = n * c_tiles * v_tiles
        unit_bytes = -(-tc * pitch * element_size // 16) * 16
        scratch = unit_bytes
    cap = min(-(-units // sms), (KEEP_BYTES - scratch) // unit_bytes)
    smem = cap * unit_bytes + scratch
    grid = blocks_per_sm(mode, smem) * sms
    return FusedPlan(mode, units, unit_values, row_units,
                     row_stride, tail, n, c, nv, sn, sc, tc, tv, pitch,
                     c_tiles, v_tiles, unit_bytes, cap, grid, smem)


def unit_values(plan: FusedPlan, u: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit ``u``'s values as (offsets in ``x``, offsets in the int8
    output), in the kernel's arithmetic; ``u == plan.units`` gives the
    tail's."""
    if plan.mode == 2:
        ct, r = u % plan.c_tiles, u // plan.c_tiles
        vt, n = r % plan.v_tiles, r // plan.v_tiles
        c0, v0 = ct * plan.tc, vt * plan.tv
        c = np.arange(min(plan.tc, plan.c - c0))[:, None]
        v = np.arange(min(plan.tv, plan.nv - v0))[None, :]
        src = n * plan.sn + (c0 + c) * plan.sc + v0 + v
        dst = (n * plan.nv + v0 + v) * plan.c + c0 + c
        return src.reshape(-1), dst.reshape(-1)
    per = plan.unit_values
    if u == plan.units:
        e = plan.units * per + np.arange(plan.tail)
        return e, e
    if plan.row_units == 0:
        first = u * per
    else:
        first = (u // plan.row_units) * plan.row_stride + (
            u % plan.row_units) * per
    return first + np.arange(per), u * per + np.arange(per)


class _Plan(ctypes.Structure):
    """``Plan`` of ``csrc/int8_quant.cu``, field for field."""

    _fields_ = [(name, ctypes.c_longlong) for name in (
        "units", "row_units", "row_stride", "tail", "cap", "sn", "sc", "nv",
        "v_tiles")] + [(name, ctypes.c_int) for name in (
            "dtype", "mode", "c", "tc", "tv", "pitch", "c_tiles",
            "tile_bytes", "grid", "smem")] + [("inv127", ctypes.c_float)]


def plan_struct(plan: FusedPlan, dtype: int) -> _Plan:
    """``plan`` as the kernel's ``Plan`` (dtype 0 fp32, 1 bf16)."""
    return _Plan(plan.units, plan.row_units, plan.row_stride, plan.tail,
                 plan.cap, plan.sn, plan.sc, plan.nv, plan.v_tiles, dtype,
                 plan.mode, plan.c, plan.tc, plan.tv, plan.pitch,
                 plan.c_tiles, plan.unit_bytes, plan.grid, plan.smem,
                 INV_127)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: int, dtype: int, mode: int, smem: int) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().lipsync_absmax_quantize_blocks(
            dtype, mode, smem, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"absmax_quantize fits no block of {smem} bytes "
                           f"on cuda:{device}: cudaError {err}")
    return blocks.value


_plans: Dict[Tuple, Tuple[FusedPlan, _Plan]] = {}


def _fused_plan(x: torch.Tensor) -> Tuple[FusedPlan, _Plan]:
    """:func:`fused_plan` of ``x`` on its device and its C struct, made
    once per (shape, strides, dtype, device, alignment)."""
    aligned = x.data_ptr() % 16 == 0
    key = (tuple(x.shape), x.stride(), x.dtype, x.device, aligned)
    hit = _plans.get(key)
    if hit is None:
        dev = x.device.index if x.device.index is not None else \
            torch.cuda.current_device()
        dtype = _DTYPES[x.dtype]
        plan = fused_plan(
            tuple(x.shape), x.stride(), layout_of(x), x.element_size(),
            aligned,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            lambda mode, smem: _blocks_per_sm(dev, dtype, mode, smem))
        c_plan = plan_struct(plan, dtype)
        hit = _plans[key] = (plan, c_plan)
    return hit


def absmax_quantize(x: torch.Tensor, w_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """``(x_q, x_scale, scale)`` of ``x`` (N, C, *spatial; fp32 or bf16,
    channels-last or channels-first in memory) in one launch: ``x_scale =
    clamp(max|x| * INV_127, min=1e-12)`` as a 0-dim fp32 tensor, ``x_q``
    the int8 ``clamp(rint(x / x_scale), -127, 127)`` as a contiguous (N,
    *spatial, C) tensor, and ``scale = x_scale * w_scale`` (None without
    ``w_scale``, a float32 vector on ``x``'s device), all on ``x``'s
    device. Launches K4 once for a CUDA tensor; the twin runs only for a
    CPU tensor."""
    _check(x)
    if w_scale is not None and (w_scale.dtype != torch.float32
                                or w_scale.dim() != 1
                                or w_scale.device != x.device):
        raise ValueError(f"w_scale must be a float32 vector on {x.device}, "
                         f"got {w_scale.dtype} {tuple(w_scale.shape)} on "
                         f"{w_scale.device}")
    if x.device.type == "cpu":
        return absmax_quantize_plain(x, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    plan, c_plan = _fused_plan(x)
    cout = 0 if w_scale is None else w_scale.numel()
    if w_scale is not None:
        w_scale = w_scale.contiguous()
    out = torch.empty((plan.n, *x.shape[2:], plan.c), dtype=torch.int8,
                      device=x.device)
    buf = torch.empty(1 + cout + plan.grid, dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().lipsync_absmax_quantize(
            ctypes.byref(c_plan), x.data_ptr(), buf.data_ptr(),
            None if w_scale is None else w_scale.data_ptr(), cout,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"absmax_quantize kernel launch failed: "
                           f"cudaError {err}")
    _count(x.device)
    return out, buf[cout], None if w_scale is None else buf[:cout]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, its functions bound once."""
    return bind(build.library("int8_quant"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of ``csrc/int8_quant.cu``."""
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.lipsync_absmax.argtypes = [p, i, ll, ll, ll, ll, ll, i, p, p]
    lib.lipsync_absmax.restype = i
    lib.lipsync_quantize.argtypes = [p, i, i, ll, ll, ll, i, ll, i, p, p, p]
    lib.lipsync_quantize.restype = i
    lib.lipsync_absmax_quantize_blocks.argtypes = [i, i, i,
                                                   ctypes.POINTER(i)]
    lib.lipsync_absmax_quantize_blocks.restype = i
    lib.lipsync_absmax_quantize.argtypes = [ctypes.POINTER(_Plan), p, p, p,
                                            i, p, p]
    lib.lipsync_absmax_quantize.restype = i
    return lib
