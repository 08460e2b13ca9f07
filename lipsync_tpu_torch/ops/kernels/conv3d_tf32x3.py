"""K6: an fp32-accurate 3-D convolution on the TF32 tensor cores with eval
BatchNorm, the residual and ReLU in its epilogue (``csrc/conv3d_tf32x3.cu``),
its wrapper and its twin.

``act(BN_eval(conv3d(x, w, stride, padding)) [+ residual])`` over
channels-last fp32 frames ``(B, T, H, W, C)``: the 3x3x3 convolutions of
the visual encoder's residual blocks and their 1x1x1 shortcut, which the
served configuration holds at fp32 (``models/layers.py::tf32x3_takes``
says when the model takes the kernel). No TPU kernel stands behind it: the
JAX package leaves these convolutions to XLA. The kernel splits every
operand into TF32 hi and lo and sums ``a_hi b_hi + a_hi b_lo + a_lo b_hi``
in fp32 (3xTF32), so it keeps fp32's accuracy on the tensor cores.

The wrapper packs the weights once per module (:func:`packed`, cached on
the parameters' versions and device): TF32 hi and lo in the kernel's K
order (:func:`pack_weights`), and BatchNorm's scale and shift computed in
float64 (:func:`bn_affine`); BatchNorm is not folded into the weights. It
launches the kernel for a CUDA tensor; the plain twin
(:func:`conv3d_tf32x3_plain`, ``F.conv3d`` and the affine in fp32) runs
only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build
from lipsync_tpu_torch.ops.kernels.hf_stem import tf32_round

K_STEP = 32   # channels of one tap a K step holds (128 bytes of fp32)
N_TILE = 64   # output channels of one tile

# Launches of the CUDA kernel in this process (the CPU twin does not count).
launches = 0


class Packed(NamedTuple):
    """One convolution and its BatchNorm as the kernel takes them:
    ``whi``, ``wlo`` ``(C_out, K)`` fp32 in the kernel's K order, TF32 hi
    and lo of the weight; ``scale``, ``shift`` ``(C_out,)`` fp32; the
    module's own ``weight`` ``(C_out, C_in, kd, kh, kw)`` for the twin."""

    whi: torch.Tensor
    wlo: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    weight: torch.Tensor


def k_order() -> torch.Tensor:
    """Within each K step of 32 channels, the channel that the kernel's
    logical column ``k`` multiplies: ``8 (q % 4) + 2 kk + q // 4`` for
    ``k = 8 kk + q``. A consumer thread's A values of one step (rows g and
    g + 8, logical columns t and t + 4 of each k8 slice, the m16n8k8 A
    fragment) are then physical channels 8 t .. 8 t + 7 of its rows: two
    16-byte shared loads."""
    k = torch.arange(K_STEP)
    kk, q = k // 8, k % 8
    return 8 * (q % 4) + 2 * kk + q // 4


def weight_matrix(conv_weight: torch.Tensor) -> torch.Tensor:
    """``(C_out, C_in, kd, kh, kw)`` as the GEMM's B, ``(C_out, K)`` fp32,
    K ordered (kt, kh, kw, c) with c fastest, each step of 32 columns in
    :func:`k_order`."""
    cout = conv_weight.shape[0]
    w = conv_weight.float().permute(0, 2, 3, 4, 1).reshape(cout, -1, K_STEP)
    return w[:, :, k_order().to(w.device)].reshape(cout, -1)


def pack_weights(conv_weight: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: :func:`weight_matrix` split into TF32 halves as the
    kernel splits A (``cvt.rna``): ``hi = tf32(w)``, ``lo = tf32(w -
    hi)``; ``hi + lo`` rebuilds ``w`` to within 2^-22 of it."""
    w = weight_matrix(conv_weight).contiguous()
    hi = tf32_round(w)
    return hi, tf32_round(w - hi)


def bn_affine(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``y * scale + shift``, both computed in float64
    from the module's fp32 parameters and statistics, then rounded to
    fp32."""
    inv = torch.rsqrt(bn.running_var.double() + bn.eps)
    scale = bn.weight.double() * inv
    shift = bn.bias.double() - bn.running_mean.double() * scale
    return scale.float(), shift.float()


def _version(t: torch.Tensor) -> tuple:
    """A tensor's storage and version (an inference tensor, which keeps no
    version, by its storage alone)."""
    return (t.data_ptr(), -1 if t.is_inference() else t._version)


def packed(block) -> Packed:
    """The kernel's operands of ``block`` (``ConvBNAct``: conv, BatchNorm),
    made once and kept on the module until a parameter or statistic
    changes (its version or storage) or the module moves."""
    conv, bn = block[0], block[1]
    tensors = (conv.weight, bn.weight, bn.bias, bn.running_mean,
               bn.running_var)
    key = tuple(_version(t) for t in tensors) + (conv.weight.device, bn.eps)
    cached = getattr(block, "_tf32x3_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        whi, wlo = pack_weights(conv.weight)
        scale, shift = bn_affine(bn)
        p = Packed(whi, wlo, scale.contiguous(), shift.contiguous(),
                   conv.weight)
    block._tf32x3_pack = (key, p)
    return p


def out_extent(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def out_shape(x_shape: Sequence[int], kernel: Sequence[int],
              cout: int, stride: Sequence[int],
              padding: Sequence[int]) -> Tuple[int, ...]:
    """``(B, To, Ho, Wo, C_out)`` of a channels-last ``x_shape``."""
    spatial = tuple(out_extent(n, k, s, p) for n, k, s, p in
                    zip(x_shape[1:4], kernel, stride, padding))
    return (x_shape[0],) + spatial + (cout,)


def flops(x_shape: Sequence[int], weight_shape: Sequence[int],
          stride: Sequence[int], padding: Sequence[int]) -> int:
    """2 x multiply-adds of one launch."""
    cout, cin = weight_shape[:2]
    o = out_shape(x_shape, weight_shape[2:], cout, stride, padding)
    taps = weight_shape[2] * weight_shape[3] * weight_shape[4]
    return 2 * o[0] * o[1] * o[2] * o[3] * cout * taps * cin


def conv3d_tf32x3_plain(x: torch.Tensor, p: Packed, stride: Sequence[int],
                        padding: Sequence[int],
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Twin of the kernel in fp32: ``F.conv3d`` of the channels-last ``x``
    by the module's weight, ``* scale + shift``, ``+ residual``, ReLU,
    channels-last and contiguous."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), p.weight.detach().float(),
                 None, tuple(stride), tuple(padding)).permute(0, 2, 3, 4, 1)
    y = y * p.scale + p.shift
    if residual is not None:
        y = y + residual
    if relu:
        y = F.relu(y)
    return y.contiguous()


def check_operands(x: torch.Tensor, p: Packed, stride: Sequence[int],
                   padding: Sequence[int],
                   residual: Optional[torch.Tensor]) -> None:
    """Raise for what the kernel does not take: ``x`` not a non-empty
    fp32 ``(B, T, H, W, C)`` with C a multiple of 32 (ValueError,
    TypeError); a weight other than ``(C_out, C, kd, kh, kw)`` with C_out
    a multiple of 64, more than 512 K steps, a stride below 1, a padding
    below 0 or an empty output (ValueError); a residual other than the
    output's shape in fp32 (ValueError, TypeError); any tensor on another
    device than ``x`` (ValueError)."""
    if x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, T, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    w = p.weight
    cout, cin = w.shape[:2]
    if w.dim() != 5 or cin != x.shape[-1]:
        raise ValueError(f"weight {tuple(w.shape)} does not take "
                         f"{x.shape[-1]} input channels")
    if cin % K_STEP or cout % N_TILE:
        raise ValueError(f"C_in must be a multiple of {K_STEP} and C_out of "
                         f"{N_TILE}, got {cin} and {cout}")
    taps = w.shape[2] * w.shape[3] * w.shape[4]
    if taps * cin // K_STEP > 512 or max(w.shape[2:]) > 255:
        raise ValueError(f"weight {tuple(w.shape)} is past the kernel's "
                         f"512 K steps")
    if len(stride) != 3 or len(padding) != 3 or min(stride) < 1 \
            or min(padding) < 0:
        raise ValueError(f"stride {tuple(stride)} and padding "
                         f"{tuple(padding)} must be 3 ints, >= 1 and >= 0")
    shape = out_shape(x.shape, w.shape[2:], cout, stride, padding)
    if min(shape) < 1:
        raise ValueError(f"empty output {shape}")
    if residual is not None:
        if tuple(residual.shape) != shape:
            raise ValueError(f"residual must be {shape}, got "
                             f"{tuple(residual.shape)}")
        if residual.dtype != torch.float32:
            raise TypeError(f"residual must be float32, got {residual.dtype}")
    others = (p.whi, p.wlo, p.scale, p.shift) + (
        () if residual is None else (residual,))
    if any(t.device != x.device for t in others):
        raise ValueError("operands must be on the input's device")


def conv3d_tf32x3(x: torch.Tensor, p: Packed, stride: Sequence[int],
                  padding: Sequence[int],
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """``act(conv3d(x) * scale + shift [+ residual])`` of a channels-last
    fp32 ``x`` ``(B, T, H, W, C)``: a contiguous fp32 ``(B, To, Ho, Wo,
    C_out)`` tensor. Launches K6 for a CUDA tensor; the twin runs only for
    a CPU tensor."""
    global launches
    check_operands(x, p, stride, padding, residual)
    if x.device.type == "cpu":
        return conv3d_tf32x3_plain(x, p, stride, padding, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xs = x.contiguous()
    res = None if residual is None else residual.contiguous()
    w = p.weight
    cout = w.shape[0]
    out = torch.empty(out_shape(xs.shape, w.shape[2:], cout, stride,
                                padding), device=x.device)
    b, t, h, wd, c = xs.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_conv3d_tf32x3(
            xs.data_ptr(), p.whi.data_ptr(), p.wlo.data_ptr(),
            p.scale.data_ptr(), p.shift.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            int(relu), b, t, h, wd, c, cout,
            *w.shape[2:], *stride, *padding, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_tf32x3 kernel launch failed: "
                           f"cudaError {err}")
    with build.COUNT_LOCK:
        launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("conv3d_tf32x3")
    fn = lib.lipsync_conv3d_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
