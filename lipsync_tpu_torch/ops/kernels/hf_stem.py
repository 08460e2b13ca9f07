"""K2: the fused high-frequency stem kernel (``csrc/hf_stem.cu``), its
wrapper and its twin.

Counterpart of ``ops/pallas/hf_stem.py::hf_stem_fused`` in the JAX package:
``relu(BN_eval(conv1(laplacian(video))))`` of the artifact branch. The
wrapper takes the module parameters in torch layouts, folds BatchNorm and
the conv bias into one scale and shift exactly as the JAX wrapper does,
picks the run of output frames per block (:func:`run_length`), and
launches the CUDA kernel for a CUDA tensor. The kernel packs conv1 for the
tensor cores in its prologue; :func:`pack_w1` is that packing in plain
torch, the reference that the CPU tests hold the fragment order to. The
plain twin
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
K_STEPS = 12  # conv1's K = 3 frames x 32 (27 taps + 5 zero rows), by 8
TILE = 16     # output tile edge of one block

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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv1_matrix(conv_weight: torch.Tensor) -> torch.Tensor:
    """conv1 ``(32, 3, 3, 3, 3)`` (OITHW) as the kernel's ``(96, 32)`` GEMM
    operand: row ``dt*32 + (dx*3 + dy)*3 + ci``; rows 27-31 of each frame
    are zero."""
    w = conv_weight.float().permute(2, 4, 3, 1, 0).reshape(3, 27, C_OUT)
    return F.pad(w, (0, 0, 0, 5)).reshape(3 * 32, C_OUT)


def pack_w1(conv_weight: torch.Tensor) -> torch.Tensor:
    """conv1 packed for ``mma.sync m16n8k8`` TF32 as the kernel's prologue
    packs it into shared memory, flat fp32: entry
    ``[ks][nt][lane][4]`` holds the B fragment of k-step ``ks`` and 8-column
    tile ``nt`` for ``lane = 4*g + tig``: ``hi[k0][n], hi[k0+4][n],
    lo[k0][n], lo[k0+4][n]`` with ``k0 = 8*ks + tig``, ``n = 8*nt + g``,
    ``hi = tf32(w)`` and ``lo = tf32(w - hi)``."""
    wk = conv1_matrix(conv_weight)
    hi = tf32_round(wk)
    lo = tf32_round(wk - hi)
    ar = lambda n: torch.arange(n, device=wk.device)  # noqa: E731
    ks = ar(K_STEPS).view(-1, 1, 1, 1)
    nt = ar(C_OUT // 8).view(1, -1, 1, 1)
    g = ar(8).view(1, 1, -1, 1)
    tig = ar(4).view(1, 1, 1, -1)
    k0, n = (8 * ks + tig).expand(-1, 4, 8, -1), (8 * nt + g).expand(
        K_STEPS, -1, -1, 4)
    frag = torch.stack([hi[k0, n], hi[k0 + 4, n], lo[k0, n], lo[k0 + 4, n]],
                       dim=-1)
    return frag.reshape(-1).contiguous()


def run_length(b: int, t: int, h: int, w: int, n_sms: int) -> int:
    """Output frames per block. A block costs about its run plus the two
    halo Laplacians and its start (~1.5 frames), and the blocks run in waves
    of two per SM: pick the run that minimises waves x (run + 1.5), the
    longer run on a tie."""
    tiles = -(-out_size(h) // TILE) * -(-out_size(w) // TILE)
    slots = 2 * n_sms

    def cost(run):
        waves = -(-b * tiles * -(-t // run) // slots)
        return waves * (run + 1.5)

    return min(range(t, 0, -1), key=cost)


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
    wlap = lap_weight.float().contiguous()
    w1 = conv_weight.float().contiguous()
    scale, shift = fold_bn(conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps)
    out = torch.empty((b, t, ho, wo, C_OUT), dtype=video.dtype,
                      device=video.device)
    n_sms = torch.cuda.get_device_properties(video.device).multi_processor_count
    lib = _library()
    with torch.cuda.device(video.device):
        stream = torch.cuda.current_stream(video.device).cuda_stream
        err = lib.lipsync_hf_stem(
            video.data_ptr(), _DTYPES[video.dtype], wlap.data_ptr(),
            w1.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, t, h, w, ho, wo,
            run_length(b, t, h, w, n_sms), stream,
        )
    if err != 0:
        raise RuntimeError(f"hf_stem kernel launch failed: cudaError {err}")
    launches += 1
    return out


def blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the kernel for ``dtype`` that one SM holds at once (CUDA's
    occupancy calculator)."""
    n = _library().lipsync_hf_stem_blocks_per_sm(_DTYPES[dtype])
    if n < 0:
        raise RuntimeError(f"hf_stem occupancy query failed: cudaError {-n}")
    return n


def _library() -> ctypes.CDLL:
    lib = build.library("hf_stem")
    fn = lib.lipsync_hf_stem
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    occ = lib.lipsync_hf_stem_blocks_per_sm
    occ.argtypes = [ctypes.c_int]
    occ.restype = ctypes.c_int
    return lib
