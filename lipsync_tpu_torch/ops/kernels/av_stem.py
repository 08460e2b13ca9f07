"""K5: the 3D stem of AV-HuBERT and of Auto-AVSR in one kernel
(``csrc/av_stem.cu``), its wrapper and its twin.

``ResEncoder.frontend3D`` of ``models/avhubert.py``: Conv3d 1 -> 64,
k(5, 7, 7), s(1, 2, 2), p(2, 3, 3), no bias; eval BatchNorm; PReLU
(AV-HuBERT) or Swish (Auto-AVSR's ``Conv3dResNet``, one instantiation of
its own); max-pool (1, 3, 3) / (1, 2, 2) / (0, 1, 1). No TPU kernel stands
behind it: both models exist only in the port. The kernel runs the
convolution as an implicit GEMM on the bf16 tensor cores with fp32 sums,
and BatchNorm, the activation and the pool in its epilogue, rounding to
bf16 where the module chain stores an activation; it writes only the
pooled frames. A ``prelu_weight`` of None means Swish.

The wrapper lays the weights out as the kernel's shared memory holds them
(:func:`pack_weights`, once per call) and launches the kernel for a CUDA
tensor; the plain twin (:func:`av_stem_plain`, the module chain) runs only
for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build

C_OUT = 64
WEIGHT_SHAPE = (C_OUT, 1, 5, 7, 7)
TAP_ROWS = 35  # (dt, dy)
ROW_TAPS = 8   # taps of a row as the GEMM's K holds them: dx + 1, and a zero
K_BLOCKS = 5   # 64 K values (128 bytes) a block of the shared image
POOL_TILE = (5, 11)  # pooled rows x columns of one tile of the kernel

SWISH_SLOPE = 1.1  # above max |d/dx x sigmoid(x)| = 1.0998
BOUND_CHUNK = 2 ** 28  # conv output values a step of sum_order_bound

# Launches of the CUDA kernel in this process (the CPU twin does not count).
launches = 0


def out_size(n: int) -> int:
    """Output extent of a k7 / stride 2 / pad 3 axis, and of a k3 / stride
    2 / pad 1 one."""
    return (n - 1) // 2 + 1


def weight_matrix(conv_weight: torch.Tensor) -> torch.Tensor:
    """The GEMM's B, ``(64, 320)`` K-major: column ``8 * r + dx + 1`` holds
    tap ``(dt, dy, dx)`` with ``r = 7 * dt + dy``; column ``8 * r`` of each
    tap row and columns 280-319 are zero."""
    w = F.pad(conv_weight.reshape(C_OUT, TAP_ROWS, 7), (1, 0))
    return F.pad(w.reshape(C_OUT, TAP_ROWS * ROW_TAPS),
                 (0, K_BLOCKS * 64 - TAP_ROWS * ROW_TAPS))


def pack_weights(conv_weight: torch.Tensor) -> torch.Tensor:
    """B as the kernel's shared memory holds it for ``wgmma`` (K-major,
    128-byte swizzle), flat in the weight's dtype: K block ``kb``, row
    ``n``, 16-byte slot ``s`` at element ``(kb * 64 + n) * 64 + 8 * s``
    holds columns ``64 * kb + 8 * (s ^ n % 8)`` and the next 7 of row ``n``
    of :func:`weight_matrix`."""
    blocks = weight_matrix(conv_weight).reshape(C_OUT, K_BLOCKS, 8, 8)
    n = torch.arange(C_OUT, device=conv_weight.device)
    q = torch.arange(8, device=conv_weight.device)[None, :] ^ (n[:, None] % 8)
    slots = torch.gather(blocks, 2,
                         q[:, None, :, None].expand(-1, K_BLOCKS, -1, 8))
    return slots.permute(1, 0, 2, 3).reshape(-1).contiguous()


def av_stem_plain(
    x: torch.Tensor,
    conv_weight: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float,
    prelu_weight: Optional[torch.Tensor],
) -> torch.Tensor:
    """Twin of the kernel: the module chain in plain PyTorch, each stage
    stored in ``x``'s dtype (PReLU, or Swish for ``prelu_weight=None``).
    ``(B, 1, T, H, W)`` -> ``(B, 64, T, Hp, Wp)``."""
    y = F.conv3d(x, conv_weight, None, (1, 2, 2), (2, 3, 3))
    y = F.batch_norm(y, bn_mean, bn_var, bn_weight, bn_bias, False, 0.0, eps)
    y = F.silu(y) if prelu_weight is None else F.prelu(y, prelu_weight)
    return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))


def operands(frontend3d) -> tuple:
    """The arguments after ``x`` of :func:`av_stem` that
    ``ResEncoder.frontend3D`` (conv, BatchNorm, PReLU or Swish, pool)
    holds: the PReLU's slopes, or None for Swish."""
    conv, bn, act, _ = frontend3d
    return (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var,
            bn.eps, getattr(act, "weight", None))


def _step(v: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at ``|v|``: 2^-7 of its power of two."""
    return torch.exp2(torch.floor(torch.log2(v.clamp(min=2 ** -126))) - 7)


def sum_order_bound(
    x: torch.Tensor,
    conv_weight: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float,
    prelu_weight: Optional[torch.Tensor],
) -> torch.Tensor:
    """Per pooled value ``(B, 64, T, Hp, Wp)`` (fp32), how far two chains
    that differ only in the order of the conv's fp32 sum may lie apart:
    K5 and the module chain, for bf16 ``x``. Each stage's bound at every
    conv position, carried through the next:

    - conv: each fp32 sum of the 245 exact products lies within 245 *
      2^-23 (rounding to nearest or toward zero) of S = sum |w x|, so the
      two within twice that, ``err``; each is then rounded to bf16, half a
      step of a value no larger than ``|y| (1 + 2^-8) + err``;
    - BatchNorm: the gain ``|gamma| / sqrt(var + eps)`` times that, each
      side's fp32 formula within 2^-21 of its terms, and each side's
      rounding to bf16;
    - PReLU: times ``max(1, |slope|)``, and each side's rounding; Swish
      (``prelu_weight=None``): times 1.1, above the largest slope of ``x
      sigmoid(x)`` (1.0998 at x = 2.40), plus its fp32 formula's few steps
      (2^-21 of the value), and each side's rounding;
    - the pool: a max moves no further than the values it takes.

    ``y`` is the chain's own conv output; the bound is rigorous for any
    order of either sum. Computed a few windows at a time (each value's
    bound is its window's alone), so that no fp32 intermediate passes
    ~1 GB."""
    b, _, t, h, w = x.shape
    step = max(1, BOUND_CHUNK // (C_OUT * t * out_size(h) * out_size(w)))
    if b > step:
        return torch.cat([
            sum_order_bound(x[lo:lo + step], conv_weight, bn_weight, bn_bias,
                            bn_mean, bn_var, eps, prelu_weight)
            for lo in range(0, b, step)])
    stride, pad = (1, 2, 2), (2, 3, 3)
    shape = (1, C_OUT, 1, 1, 1)
    with torch.no_grad():
        y = F.conv3d(x, conv_weight, None, stride, pad)
        err = F.conv3d(x.abs(), conv_weight.abs(), None, stride, pad).float()
        err.mul_(2 * 245 * 2 ** -23 * (1 + 2 ** -7))
        d = err.add_(_step(y.float().abs_().mul_(1 + 2 ** -8).add_(err)))
        gain = (bn_weight.abs() * torch.rsqrt(bn_var + eps)).view(shape)
        terms = (gain * (y.float().abs_() + bn_mean.abs().view(shape))
                 + bn_bias.abs().view(shape))
        z = F.batch_norm(y, bn_mean, bn_var, bn_weight, bn_bias, False, 0.0,
                         eps)
        del y
        d.mul_(gain).add_(terms.mul_(2 ** -21))
        del terms
        d.add_(_step(z.float().abs_().mul_(1 + 2 ** -8).add_(d)))
        if prelu_weight is None:
            p = F.silu(z)
            d.mul_(SWISH_SLOPE).add_(p.float().abs().mul_(2 ** -21))
        else:
            slope = prelu_weight.float().abs().clamp(min=1).view(shape)
            p = F.prelu(z, prelu_weight)
            d.mul_(slope)
        del z
        d.add_(_step(p.float().abs_().mul_(1 + 2 ** -8).add_(d)))
        return F.max_pool3d(d, (1, 3, 3), (1, 2, 2), (0, 1, 1))


def check_shapes(x: torch.Tensor, conv_weight: torch.Tensor,
                 prelu_weight: Optional[torch.Tensor]) -> None:
    """Raise ValueError for a shape the kernel does not take: an input other
    than a non-empty ``(B, 1, T, H, W)``, a weight other than ``(64, 1, 5,
    7, 7)``, other than 64 PReLU slopes (None: Swish, no slope)."""
    if x.dim() != 5 or x.shape[1] != 1:
        raise ValueError(f"expected (B, 1, T, H, W), got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if tuple(conv_weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"conv_weight must be {WEIGHT_SHAPE}, got "
                         f"{tuple(conv_weight.shape)}")
    if prelu_weight is not None and tuple(prelu_weight.shape) != (C_OUT,):
        raise ValueError(f"prelu_weight must be ({C_OUT},), got "
                         f"{tuple(prelu_weight.shape)}")


def check_operands(x: torch.Tensor, conv_weight: torch.Tensor,
                   bn: tuple, prelu_weight: Optional[torch.Tensor]) -> None:
    """Raise for operands the kernel does not take: ``x``, the weight and
    the slopes not bf16 (TypeError), BatchNorm's four tensors not 64 fp32
    values (TypeError, ValueError), any of them on another device than
    ``x`` (ValueError), or more tiles than the kernel counts (ValueError)."""
    for name, t in (("x", x), ("conv_weight", conv_weight),
                    ("prelu_weight", prelu_weight)):
        if t is not None and t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    for t in bn:
        if t.dtype != torch.float32:
            raise TypeError(f"BatchNorm tensors must be float32, got {t.dtype}")
        if tuple(t.shape) != (C_OUT,):
            raise ValueError(f"BatchNorm tensors must be ({C_OUT},), got "
                             f"{tuple(t.shape)}")
    if any(t is not None and t.device != x.device
           for t in (conv_weight, prelu_weight, *bn)):
        raise ValueError("parameters must be on the input's device")
    b, _, t, h, w = x.shape
    py, px = POOL_TILE
    tiles = b * t * -(-out_size(out_size(h)) // py) * \
        -(-out_size(out_size(w)) // px)
    if tiles >= 2 ** 31 - 1:
        raise ValueError(f"input {tuple(x.shape)} is {tiles} tiles, past "
                         f"the kernel's 2^31 - 1")


def av_stem(
    x: torch.Tensor,
    conv_weight: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float,
    prelu_weight: Optional[torch.Tensor],
) -> torch.Tensor:
    """``(B, 1, T, H, W)`` -> ``(B, 64, T, Hp, Wp)``, the stem's pooled
    output, with PReLU, or with Swish for ``prelu_weight=None``. Launches
    K5 for a CUDA tensor, whose result is a view of a contiguous ``(B, T,
    64, Hp, Wp)`` tensor (the frames the ResNet trunk reads); the twin runs
    only for a CPU tensor."""
    global launches
    check_shapes(x, conv_weight, prelu_weight)
    bn = (bn_weight, bn_bias, bn_mean, bn_var)
    if x.device.type == "cpu":
        return av_stem_plain(x, conv_weight, *bn, eps, prelu_weight)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_operands(x, conv_weight, bn, prelu_weight)
    xs = x.contiguous()
    b, _, t, h, w = xs.shape
    hp, wp = out_size(out_size(h)), out_size(out_size(w))
    out = torch.empty((b, t, C_OUT, hp, wp), dtype=torch.bfloat16,
                      device=x.device)
    packed = pack_weights(conv_weight)
    bn = [p.contiguous() for p in bn]
    swish = prelu_weight is None
    slope = None if swish else prelu_weight.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lipsync_av_stem(
            xs.data_ptr(), packed.data_ptr(), *(p.data_ptr() for p in bn),
            None if swish else slope.data_ptr(), float(eps), out.data_ptr(),
            b, t, h, w, int(swish), stream)
    if err != 0:
        raise RuntimeError(f"av_stem kernel launch failed: cudaError {err}")
    with build.COUNT_LOCK:
        launches += 1
    return out.transpose(1, 2)


def blocks_per_sm(aligned: bool = True, swish: bool = False) -> int:
    """Blocks of the kernel one SM holds at once (CUDA's occupancy
    calculator): the variant that stages by 4-byte copies (``aligned``:
    W even) or the one that loads pixel by pixel; the PReLU or the Swish
    instantiation."""
    n = _library().lipsync_av_stem_blocks_per_sm(int(aligned), int(swish))
    if n < 0:
        raise RuntimeError(f"av_stem occupancy query failed: cudaError {-n}")
    return n


def _library() -> ctypes.CDLL:
    lib = build.library("av_stem")
    fn = lib.lipsync_av_stem
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.lipsync_av_stem_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int
    return lib
