"""K3: the int8 implicit-GEMM convolution (``csrc/int8_conv.cu``), its
wrappers and their twins.

The JAX package's quantized serving lowering (``models/layers.py::
Int8Conv``) convolves int8 activations with int8 weights into int32
(``lax.conv_general_dilated(..., preferred_element_type=int32)``, an XLA
convolution) and dequantizes the result. PyTorch has no CUDA convolution
that accumulates int8 in int32 (``F.conv*`` on int8 tensors accumulates in
int8 and wraps), so the port launches K3 for a CUDA tensor, with two
entries: :func:`int8_conv_int32`, the exact int32 sums, and
:func:`int8_conv_dequant`, whose epilogue writes ``float(acc) * scale[c]
(+ bias[c])`` in fp32 or bf16, the serving path's. The geometry picks the
main loop (:func:`main_loop`): ``wgmma`` over a swizzled ring where
``C_in % 32 == 0``, and for every other ``C_in`` (the two stems among
them) ``wgmma`` over a halo tile in shared memory (:func:`halo_plan`).
The entries refuse a geometry that neither loop takes (:func:`takes`);
``models/layers.py::int8_conv`` reshapes such a convolution into ones
they take.

The twin (:func:`int8_conv_plain`) convolves the int8 values in float64
and casts to int32: exact, since |acc| <= 127^2 x 6912 < 2^53 for every
encoder convolution (float32 is not exact past 2^24). The dequantizing
twin (:func:`int8_conv_dequant_plain`) follows it with the torch ops that
the epilogue reproduces bit for bit. The twins run only for a CPU tensor.

Layouts are channels-last: activations ``(N, [D,] H, W, C_in)``, weights
``(C_out, [kD,] kH, kW, C_in)``, output ``(N, [Do,] Ho, Wo, C_out)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build

# K bytes per step of both main loops; the wrapper zero-pads each weight
# row to a multiple of it (the halo loop's K is over channels padded to 4).
K_STEP = 128
# K that the wgmma loop's table of K chunks holds; the wrappers refuse a
# larger K there.
WGMMA_MAX_K = 8192
# Shared memory a block may use on an H100, and the GEMM rows per tile the
# halo loop takes (3 or 2 warpgroups of 64 rows).
SMEM_LIMIT = 232448
HALO_ROWS = (192, 128)
_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

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
    return m, w_shape[0], _taps(w_shape)


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
    if w.shape[0] % 8:
        raise ValueError(f"C_out must be a multiple of 8, got {w.shape[0]}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if len(stride) != nd or len(padding) != nd:
        raise ValueError(f"stride {stride} / padding {padding} for {nd}-d")
    _check_loop(x.shape, w.shape, stride, padding)
    return nd


def _check_loop(x_shape, w_shape, stride, padding) -> None:
    """Raises ``ValueError`` unless a main loop takes these shapes: a
    ``wgmma`` K within the tap table, or a halo tile that fits in shared
    memory."""
    if main_loop(x_shape, w_shape) == "wgmma":
        kp = -(-_taps(w_shape) // K_STEP) * K_STEP
        if kp > WGMMA_MAX_K:
            raise ValueError(f"K = {kp} (padded) is past the wgmma loop's "
                             f"tap table of {WGMMA_MAX_K}")
    else:
        halo_plan(*_as_3d(tuple(x_shape), tuple(w_shape), tuple(stride),
                          tuple(padding)))


def takes(x_shape: Sequence[int], w_shape: Sequence[int],
          stride: Sequence[int], padding: Sequence[int]) -> bool:
    """Whether a main loop takes these channels-last shapes (C_out apart,
    which must be a multiple of 8)."""
    try:
        _check_loop(x_shape, w_shape, stride, padding)
    except ValueError:
        return False
    return True


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


def int8_conv_dequant_plain(x: torch.Tensor, w: torch.Tensor,
                            scale: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            out_dtype: torch.dtype, stride: Sequence[int],
                            padding: Sequence[int]) -> torch.Tensor:
    """Twin of the dequantizing entry: :func:`int8_conv_plain`, then
    ``y.float() * scale (+ bias)`` in fp32 and the cast to ``out_dtype``."""
    out = int8_conv_plain(x, w, stride, padding).float() * scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _taps(w_shape: Sequence[int]) -> int:
    """K of the GEMM: taps x input channels."""
    k = 1
    for v in w_shape[1:]:
        k *= v
    return k


def main_loop(x_shape: Sequence[int], w_shape: Sequence[int]) -> str:
    """The kernel's main loop for these shapes (channels-last, 2-d or 3-d):
    ``"wgmma"`` when ``C_in % 32 == 0``, else ``"halo"``."""
    return "wgmma" if x_shape[-1] % 32 == 0 else "halo"


def _as_3d(x_shape, w_shape, stride, padding):
    """2-d shapes as a 3-d convolution over one frame."""
    if len(x_shape) == 4:
        return ((x_shape[0], 1, *x_shape[1:]), (w_shape[0], 1, *w_shape[1:]),
                (1, *stride), (0, *padding))
    return tuple(x_shape), tuple(w_shape), tuple(stride), tuple(padding)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The halo loop's tile for one geometry: ``tr`` output rows x ``tw``
    output columns of one frame (``tr * tw`` GEMM rows of at most 192), the
    ``hr`` x ``hc`` input rows x columns of each of the kernel's ``kd``
    frames that they read, and the shared memory of a block: B resident
    (``kblocks`` blocks of 64 channels x 128 bytes), two widened halos
    (``cw`` words per voxel), two slots of staged input rows (``rs`` bytes
    each) with their row tables, and the tap table."""

    cw: int
    kwords: int
    kblocks: int
    tr: int
    tw: int
    hr: int
    hc: int
    rs: int
    smem: int


def _halo_smem(kd, kblocks, hr, hc, cw, rs) -> int:
    def up16(v):
        return -(-v // 16) * 16
    return (1024 + kblocks * 64 * 128 + 2 * up16(4 * kd * hr * hc * cw)
            + 2 * kd * hr * rs + 2 * up16(4 * kd * hr) + 128 * kblocks)


@functools.lru_cache(maxsize=256)
def halo_plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
              stride: Tuple[int, ...], padding: Tuple[int, ...]) -> HaloPlan:
    """The tile of the halo loop for 3-d channels-last shapes: of the tiles
    whose shared memory fits, the one with the fewest GEMM rows in all
    (tiles x rows per tile), first by 192 rows a tile, then 128, and by
    the widest row. Raises ``ValueError`` when none fits."""
    n, d, h, w, c = x_shape
    _, kd, kh, kw, _ = w_shape
    od, oh, ow = (out_size(*a) for a in zip((d, h, w), (kd, kh, kw), stride,
                                            padding))
    if min(n, od, oh, ow) <= 0:
        raise ValueError(f"empty output for input {tuple(x_shape)}")
    cw = -(-c // 4)
    kwords = kd * kh * kw * cw
    kblocks = -(-kwords // 32)
    best = None
    for rows in HALO_ROWS:
        widths = sorted({-(-ow // nb) for nb in range(-(-ow // rows), ow + 1)},
                        reverse=True)
        for tw in widths:
            hc = (tw - 1) * stride[2] + kw
            rs = 16 * ((hc * c + 31) // 16)
            for tr in range(max(1, min(oh, rows // tw)), 0, -1):
                hr = (tr - 1) * stride[1] + kh
                smem = _halo_smem(kd, kblocks, hr, hc, cw, rs)
                if smem > SMEM_LIMIT:
                    continue
                tiles = n * od * -(-oh // tr) * -(-ow // tw)
                if best is None or tiles * rows < best[0]:
                    best = (tiles * rows, HaloPlan(cw, kwords, kblocks, tr,
                                                   tw, hr, hc, rs, smem))
                break
    if best is None:
        raise ValueError(
            f"the halo loop does not fit in {SMEM_LIMIT} bytes of shared "
            f"memory for input {tuple(x_shape)} and weights "
            f"{tuple(w_shape)}: B alone takes {kblocks * 64 * 128} bytes")
    return best[1]


def halo_tap_offsets(plan: HaloPlan, w_shape: Sequence[int]) -> np.ndarray:
    """K word q (tap q // cw, channel word q % cw, taps in (kd, kh, kw)
    order) as its offset in words from a GEMM row's tap-0 word in the
    halo: ``((td * hr + th) * hc + tw) * cw + q % cw``; 0 past K, where the
    weights are zero. ``kblocks * 32`` int32 values."""
    _, kd, kh, kw, _ = w_shape
    q = np.arange(plan.kblocks * 32)
    tap, j = q // plan.cw, q % plan.cw
    td, th, tw = tap // (kh * kw), (tap // kw) % kh, tap % kw
    off = ((td * plan.hr + th) * plan.hc + tw) * plan.cw + j
    return np.where(q < plan.kwords, off, 0).astype(np.int32)


def halo_row_base(plan: HaloPlan, stride: Sequence[int], r: int) -> int:
    """GEMM row ``r`` of a tile (output row ``r // tw``, column ``r %
    tw``) as the halo word of its tap 0."""
    return ((r // plan.tw) * stride[1] * plan.hc
            + (r % plan.tw) * stride[2]) * plan.cw


def pack_halo_weights(w: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """3-d channels-last int8 weights ``(C_out, kD, kH, kW, C_in)`` as the
    halo loop's B: channels zero-padded to ``4 * cw``, taps in (kd, kh,
    kw) order, zero-padded to ``kblocks * 128`` bytes a row."""
    cout, c = w.shape[0], w.shape[-1]
    wp = F.pad(w, (0, 4 * plan.cw - c)).reshape(cout, 4 * plan.kwords)
    return F.pad(wp, (0, K_STEP * plan.kblocks - 4 * plan.kwords)
                 ).contiguous()


_tables: Dict[Tuple, torch.Tensor] = {}


def _halo_table(plan: HaloPlan, w_shape, device) -> torch.Tensor:
    """:func:`halo_tap_offsets` on ``device``, copied there once."""
    key = (plan, tuple(w_shape), str(device))
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = torch.from_numpy(
            halo_tap_offsets(plan, w_shape)).to(device)
    return table


def int8_conv_int32(x: torch.Tensor, w: torch.Tensor,
                    stride: Sequence[int], padding: Sequence[int]
                    ) -> torch.Tensor:
    """int8 ``x`` (N, [D,] H, W, C_in) convolved with int8 ``w`` (C_out,
    [kD,] kH, kW, C_in), zero padding, into int32 (N, [Do,] Ho, Wo,
    C_out). Launches K3 for a CUDA tensor; the twin runs only for a CPU
    tensor."""
    _check(x, w, stride, padding)
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, stride, padding)
    return _launch(x, w, None, None, torch.int32, stride, padding)


def int8_conv_dequant(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                      stride: Sequence[int], padding: Sequence[int]
                      ) -> torch.Tensor:
    """The convolution of :func:`int8_conv_int32`, dequantized in the
    epilogue: ``float(acc) * scale[c] (+ bias[c])`` as ``out_dtype``
    (float32 or bfloat16), channels-last. ``scale`` and ``bias`` are fp32
    vectors of C_out on the operands' device. Launches K3 for a CUDA
    tensor; the twin runs only for a CPU tensor."""
    _check(x, w, stride, padding)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    vectors = [("scale", scale)] + ([] if bias is None else [("bias", bias)])
    for name, v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (w.shape[0],):
            raise ValueError(f"{name} must be float32 of shape "
                             f"({w.shape[0]},), got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, operands on {x.device}")
    if x.device.type == "cpu":
        return int8_conv_dequant_plain(x, w, scale, bias, out_dtype, stride,
                                       padding)
    return _launch(x, w, scale.contiguous(),
                   None if bias is None else bias.contiguous(), out_dtype,
                   stride, padding)


def _launch(x, w, scale, bias, out_dtype, stride, padding) -> torch.Tensor:
    global launches
    nd = x.dim() - 2
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
    loop = main_loop(x.shape, w.shape)
    # Views into other tensors; the epilogue reads scale and bias by pairs.
    if x.data_ptr() % 16:
        x = x.clone()
    if scale is not None and scale.data_ptr() % 8:
        scale = scale.clone()
    if bias is not None and bias.data_ptr() % 8:
        bias = bias.clone()
    out = torch.empty((n, od, oh, ow, cout), dtype=out_dtype,
                      device=x.device)
    if loop == "wgmma":
        k = kd * kh * kw * c
        kp = -(-k // K_STEP) * K_STEP
        wp = F.pad(w.reshape(cout, k), (0, kp - k)).contiguous()
        tr = tw = 0
        table = None
    else:
        plan = halo_plan(tuple(x.shape), tuple(w.shape), tuple(stride),
                         tuple(padding))
        wp = pack_halo_weights(w, plan)
        kp, tr, tw = wp.shape[1], plan.tr, plan.tw
        table = _halo_table(plan, w.shape, x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_int8_conv(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), _OUT_KINDS[out_dtype],
            n, d, h, wd, c, kd, kh, kw, *stride, *padding, od, oh, ow, cout,
            kp, int(loop == "wgmma"), tr, tw,
            None if table is None else table.data_ptr(), stream)
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 23 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib
