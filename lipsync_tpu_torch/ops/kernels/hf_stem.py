"""K2: the fused high-frequency stem kernel (``csrc/hf_stem.cu``), its
wrapper and its twin.

Counterpart of ``ops/pallas/hf_stem.py::hf_stem_fused`` in the JAX package:
``relu(BN_eval(conv1(laplacian(video))))`` of the artifact branch. The
wrapper takes the module parameters in torch layouts, folds BatchNorm and
the conv bias into one scale and shift exactly as the JAX wrapper does, and
launches the CUDA kernel for a CUDA tensor. The plain twin
(:func:`hf_stem_plain`: ``F.conv2d`` + ``F.conv3d`` + BN + ReLU in fp32)
runs only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import build

C_OUT = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel in this process (the CPU twin does not count).
launches = 0


def out_size(n: int) -> int:
    """Output extent of a k3 / stride 2 / pad 1 axis."""
    return (n - 1) // 2 + 1


def fold_bn(
    conv_bias: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm after a biased conv as ``y * scale + shift`` (fp32)."""
    inv = torch.rsqrt(bn_var.float() + eps)
    g = bn_weight.float()
    scale = g * inv
    shift = (conv_bias.float() - bn_mean.float()) * inv * g + bn_bias.float()
    return scale, shift


def hf_stem_plain(
    video: torch.Tensor,
    lap_weight: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Twin of the kernel in plain PyTorch: fp32 arithmetic on the input,
    output in the input dtype, ``(B, T, Ho, Wo, 32)`` channels-last."""
    b, t, h, w, c = video.shape
    with torch.autocast(video.device.type, enabled=False):
        frames = video.float().reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        lap = F.conv2d(frames, lap_weight.float(), padding=1)
        x = lap.reshape(b, t, c, h, w).transpose(1, 2)  # (B, 3, T, H, W)
        y = F.conv3d(x, conv_weight.float(), conv_bias.float(),
                     stride=(1, 2, 2), padding=1)
        y = F.batch_norm(y, bn_mean.float(), bn_var.float(),
                         bn_weight.float(), bn_bias.float(), False, 0.0, eps)
        y = F.relu(y)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(video.dtype)


def hf_stem(
    video: torch.Tensor,
    lap_weight: torch.Tensor,
    conv_weight: torch.Tensor,
    conv_bias: torch.Tensor,
    bn_weight: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``(B, T, H, W, 3)`` video -> ``(B, T, Ho, Wo, 32)`` in the video's
    dtype. ``lap_weight`` is the Conv2d weight ``(3, 3, 3, 3)`` (OIHW),
    ``conv_weight`` the Conv3d weight ``(32, 3, 3, 3, 3)`` (OITHW). Launches
    K2 for a CUDA tensor; the twin runs only for a CPU tensor."""
    global launches
    if video.dim() != 5 or video.shape[-1] != 3:
        raise ValueError(f"expected (B, T, H, W, 3), got {tuple(video.shape)}")
    if tuple(lap_weight.shape) != (3, 3, 3, 3):
        raise ValueError(f"lap_weight must be (3,3,3,3), got "
                         f"{tuple(lap_weight.shape)}")
    if tuple(conv_weight.shape) != (C_OUT, 3, 3, 3, 3):
        raise ValueError(f"conv_weight must be (32,3,3,3,3), got "
                         f"{tuple(conv_weight.shape)}")
    args = (lap_weight, conv_weight, conv_bias, bn_weight, bn_bias, bn_mean,
            bn_var)
    if video.device.type == "cpu":
        return hf_stem_plain(video, *args, eps=eps)
    if video.device.type != "cuda":
        raise ValueError(f"unsupported device {video.device}")
    if video.dtype not in _DTYPES:
        raise TypeError(f"video must be float32 or bfloat16, got {video.dtype}")
    if not video.is_contiguous():
        raise ValueError("video must be contiguous (channels-last)")
    if any(p.device != video.device for p in args):
        raise ValueError("parameters must be on the video's device")
    b, t, h, w, _ = video.shape
    if b * t == 0 or h == 0 or w == 0:
        raise ValueError(f"empty video {tuple(video.shape)}")
    ho, wo = out_size(h), out_size(w)
    wlap = lap_weight.float().permute(2, 3, 1, 0).contiguous()  # dy,dx,ci,co
    w1 = conv_weight.float().permute(2, 3, 4, 1, 0).contiguous()
    scale, shift = fold_bn(conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps)
    out = torch.empty((b, t, ho, wo, C_OUT), dtype=video.dtype,
                      device=video.device)
    lib = _library()
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        err = lib.lipsync_hf_stem(
            video.data_ptr(), _DTYPES[video.dtype], wlap.data_ptr(),
            w1.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, t, h, w, ho, wo, stream,
        )
    if err != 0:
        raise RuntimeError(f"hf_stem kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("hf_stem")
    fn = lib.lipsync_hf_stem
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib
