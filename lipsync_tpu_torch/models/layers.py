"""Shared building blocks of the lip-sync model.

Counterpart of ``models/layers.py`` in the JAX package, written as torch
modules that carry the reference checkpoint's parameter names
(``nn.Sequential`` indices: ``<block>.0`` conv, ``<block>.1`` BatchNorm;
packed ``in_proj_weight``/``in_proj_bias`` attention). Convolution blocks
work on channels-first tensors (torch's NC[D]HW); the encoders permute from
the package's channels-last layouts at their boundary. Every BatchNorm is
:class:`BatchNorm`: eps 1e-5, momentum 0.1 (torch's convention, flax's
0.9), and flax's running-variance rule. ``ConvBNAct(lowering="int8")`` runs
its convolution through :func:`int8_conv` (K3) with the same parameters;
``lowering="shift_matmul"`` (the JAX package's ``ShiftMatmulConv``, stride
1 only) is the plain convolution. Padding is one int per spatial dim
(torch's form) or a ``(lo, hi)`` pair per dim (JAX's); unequal pairs are
padded explicitly (:func:`explicit_padding`).

Data parallelism keeps the global batch's numbers (the JAX package's mesh
runs one program over it): a BatchNorm given a process group normalises
with the statistics of every rank's rows (:meth:`BatchNorm.forward`);
inside :func:`batch_shard` dropout draws its mask for the global batch
and keeps this rank's rows; and ``int8_conv``'s activation scale is the
abs-max over every in-process shard (``parallel.mesh.all_max``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import int8_conv as int8_conv_k3
from lipsync_tpu_torch.ops.kernels.int8_conv import (
    int8_conv_dequant,
    int8_conv_int32,
)
from lipsync_tpu_torch.ops.kernels.int8_quant import (
    INV_127,
    absmax,
    absmax_quantize,
    quantize,
    quantize_int8,
)
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.parallel.collectives import all_gather_rows

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of an ``(N, C, ...)`` tensor of any rank that
    normalises as ``nn.BatchNorm{1,2,3}d`` does and keeps their buffer
    names, but updates ``running_var`` with the *biased* batch variance, as
    flax's ``nn.BatchNorm`` does (torch's own modules use the unbiased one,
    so their statistics drift from the JAX package's by n/(n-1) on the
    update term). ``momentum=None`` is torch's cumulative average.

    The update is torch's, corrected in place: with ``old`` the variance
    before the step, ``m`` the step's factor and ``n`` the values per
    channel, torch writes ``(1-m) old + m var n/(n-1)``, and
    ``((n-1) new + (1-m) old) / n`` turns that into ``(1-m) old + m var``
    without another pass over the activations. While ``update_stats`` is
    False a training-mode forward normalises with the batch statistics and
    leaves every buffer as it was (see :func:`frozen_batch_stats`).

    With ``process_group`` set (:func:`set_process_group`), a
    training-mode forward uses the statistics of the global batch, every
    rank's rows: each rank's count, mean and biased variance (two passes
    over its rows) are gathered over the group with their gradients
    (``parallel.collectives.all_gather_rows``, one collective forward and
    one backward) and combined as ``mean = sum n_i mean_i / N`` and
    ``var = sum n_i (var_i + (mean_i - mean)^2) / N``. Every rank updates
    its buffers with the same global mean and biased variance. Eval mode
    runs no collective."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum=0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True
        self.process_group = None

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected (N, C, ...), got {tuple(x.shape)}")

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        c = x.shape[1]
        var_i, mean_i = torch.var_mean(x, dims, correction=0)
        n_i = x.new_full((1,), x.numel() // c)
        rows = all_gather_rows(torch.cat([n_i, mean_i, var_i])[None])
        n, means, variances = rows[:, :1].detach(), rows[:, 1:c + 1], \
            rows[:, c + 1:]
        weight = n / n.sum()
        mean = (weight * means).sum(0)
        var = (weight * (variances + (means - mean).square())).sum(0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = torch.addcmul(self.bias.view(shape), x - mean.view(shape),
                            scale.view(shape))
        if self.update_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_forward(x)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        old = self.running_var.clone()
        out = super().forward(x)
        with torch.no_grad():
            m = (self.momentum if self.momentum is not None
                 else 1.0 / float(self.num_batches_tracked))
            n = x.numel() // x.shape[1]
            # A new tensor: autograd holds the one that the op updated.
            self.running_var = torch.add(self.running_var * ((n - 1) / n),
                                         old, alpha=(1 - m) / n)
        return out


def batch_norms(model: nn.Module) -> Iterator[BatchNorm]:
    return (m for m in model.modules() if isinstance(m, BatchNorm))


def set_process_group(model: nn.Module, group) -> None:
    """Make every BatchNorm of ``model`` use the global batch of ``group``
    in training mode (None: this process's batch)."""
    for bn in batch_norms(model):
        bn.process_group = group


_shard = threading.local()


@contextlib.contextmanager
def batch_shard(shard: Optional[mesh_lib.ProcessShard]):
    """While open, the calling thread's training forwards run on rank
    ``shard.rank``'s block of a global batch of ``shard.world`` equal
    blocks: :func:`dropout` draws its mask for the global batch, as one
    process would, and keeps this block's rows. Every rank must hold the
    same RNG state."""
    prev = getattr(_shard, "value", None)
    _shard.value = shard
    try:
        yield
    finally:
        _shard.value = prev


def dropout(x: torch.Tensor, p: float, training: bool,
            feature: bool = False) -> torch.Tensor:
    """``F.dropout`` (``feature``: ``F.dropout3d``'s whole-channel masks of
    a 5-d input). Inside :func:`batch_shard` the mask is the global batch's
    rows of this shard: the mask that one process draws for the whole
    batch, so the sharded step computes the same function."""
    fn = F.dropout3d if feature else F.dropout
    shard = getattr(_shard, "value", None)
    if not training or p == 0.0 or shard is None or shard.world == 1:
        return fn(x, p, training)
    b = x.shape[0]
    if feature:  # torch draws one contiguous (B, C, 1, ...) noise tensor
        ones = x.new_ones((b * shard.world, x.shape[1]) + (1,) * (x.dim() - 2))
    else:  # torch draws noise laid out in memory as ``x`` is
        order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
        shape = (b * shard.world,) + tuple(x.shape[1:])
        ones = x.new_ones([shape[d] for d in order]).permute(
            [order.index(d) for d in range(x.dim())])
    mask = fn(ones, p, True)
    return x * mask[shard.rank * b:(shard.rank + 1) * b]


class Dropout(nn.Dropout):
    """``nn.Dropout`` through :func:`dropout`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training)


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
    """While open, training-mode forwards of ``model`` normalise with batch
    statistics and update no BatchNorm buffer."""
    bns = list(batch_norms(model))
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


def compute_in(x: torch.Tensor):
    """Autocast to ``x``'s dtype when it is bf16, else nothing: a module
    that opens with this computes in the precision of what it is given."""
    if x.dtype == torch.bfloat16:
        return torch.autocast(x.device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's default ``nn.GELU()``."""
    return F.gelu(x)


Padding = Sequence[Union[int, Tuple[int, int]]]


def padding_pairs(padding: Padding) -> Tuple[Tuple[int, int], ...]:
    """``padding`` per spatial dim as ``(lo, hi)`` pairs (one int ``p`` is
    ``(p, p)``)."""
    return tuple((int(p), int(p)) if isinstance(p, (int, np.integer))
                 else (int(p[0]), int(p[1])) for p in padding)


def explicit_padding(x: torch.Tensor, padding: Padding, value: float,
                     window: Optional[Sequence[int]] = None,
                     channels_last: bool = False
                     ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """``(x, ints)`` for torch's symmetric padding: where it computes
    ``padding`` (every pair equal, and for a pool of ``window`` at most
    half of it), ``x`` as it is and the pairs' ints; otherwise ``x`` padded
    with ``value`` over its spatial dims (those after the channels, or
    before them with ``channels_last``) and zeros."""
    pairs = padding_pairs(padding)
    if all(lo == hi for lo, hi in pairs) and (window is None or all(
            lo <= k // 2 for (lo, _), k in zip(pairs, window))):
        return x, tuple(lo for lo, _ in pairs)
    flat = tuple(v for pair in reversed(pairs) for v in pair)
    if channels_last:
        flat = (0, 0) + flat
    return F.pad(x, flat, value=value), (0,) * len(pairs)


# 1/127 rounded to float32, as the compiled JAX package multiplies by it
# (``ops/kernels/int8_quant.py`` says why).
_INV_127 = INV_127


def int8_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Sequence[int],
    padding: Padding,
) -> torch.Tensor:
    """Counterpart of the JAX package's ``layers.Int8Conv``: post-training
    dynamic quantization of one 2-d or 3-d convolution (channels-first
    ``x``, torch weight layout). Weights quantize per output channel
    (``max|w| / 127`` as a product with ``_INV_127``, floored at 1e-12),
    activations per *tensor* over the whole batch (every shard of an
    in-process mesh), symmetric. On a CUDA tensor K4 writes the int8
    activation channels-last: outside a mesh in one launch that also
    computes the scale and K3's epilogue scale (:func:`absmax_quantize`);
    in a mesh's shard as ``max|x|`` over the frames it owns
    (:func:`absmax`), reduced over the shards by ``all_max``, then
    :func:`quantize`. K3 convolves int8 x int8 -> int32 and dequantizes in
    its epilogue as ``acc * (x_scale * w_scale)`` plus the bias, in fp32,
    written in ``x``'s dtype (:func:`int8_conv_dequant`): no elementwise
    torch pass over the activation or the output. A CPU tensor takes the
    twins of each, by the same route. Because the activation scale is per
    tensor, a window's quantization grid depends on its batch-mates, as in
    the JAX package. Inference only: K3 has no backward. Returns the
    channels-last result as a channels-first view.

    Every width that the JAX package computes runs (:func:`_k3_geometry`
    says how a convolution that K3 refuses is reshaped, exactly), and
    every padding: K3 pads symmetrically, so unequal ``(lo, hi)`` pairs pad
    the int8 activation with zeros before it (a zero quantizes to 0, so
    this is the convolution of the zero-padded ``x``, exactly)."""
    w32 = weight.float()
    w_scale = torch.clamp(
        w32.abs().amax(dim=tuple(range(1, w32.dim()))) * _INV_127,
        min=1e-12)
    w_q = quantize_int8(w32, w_scale.view(-1, *[1] * (w32.dim() - 1)))
    w_q = w_q.movedim(1, -1)
    cout = w_q.shape[0]
    extra = -cout % 8
    if bias is not None:
        bias = bias.float()
    if extra:  # K3 writes C_out in multiples of 8: zero rows, cut below
        w_q = F.pad(w_q, (0, 0) * (w_q.dim() - 1) + (0, extra))
        w_scale = F.pad(w_scale, (0, extra))
        if bias is not None:
            bias = F.pad(bias, (0, extra))
    core = mesh_lib.frame_core()
    if core is None and not mesh_lib.in_lockstep():
        x_q, _, scale = absmax_quantize(x, w_scale)
    else:
        # Over every in-process shard of the batch; a frame-sharded encode
        # counts only the frames each shard owns.
        x_scale = torch.clamp(
            mesh_lib.all_max(absmax(x, core)) * _INV_127, min=1e-12)
        x_q = quantize(x, x_scale)
        scale = x_scale * w_scale
    x_q, padding = explicit_padding(x_q, padding, 0, channels_last=True)
    groups, width = _k3_geometry(tuple(x_q.shape), tuple(w_q.shape),
                                 stride, padding)
    if groups == 1:
        if width != x_q.shape[-1]:
            x_q, w_q = _pad_channels(x_q, width), _pad_channels(w_q, width)
        y = int8_conv_dequant(x_q, w_q.contiguous(), scale, bias, x.dtype,
                              stride, padding)
    else:  # channel groups of at most ``width``, summed exactly in int32
        acc = None
        for lo in range(0, x_q.shape[-1], width):
            hi = min(lo + width, x_q.shape[-1])
            part = int8_conv_int32(_pad_channels(x_q[..., lo:hi], width),
                                   _pad_channels(w_q[..., lo:hi], width),
                                   stride, padding)
            acc = part if acc is None else acc + part
        y = acc.float() * scale
        if bias is not None:
            y = y + bias
        y = y.to(x.dtype)
    if extra:
        y = y[..., :cout].contiguous()
    return y.movedim(-1, 1)


def _k3_geometry(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                 stride: Sequence[int], padding: Sequence[int]
                 ) -> Tuple[int, int]:
    """``(groups, width)``: K3 takes the convolution as it is (``width ==
    C_in``, one group), or with ``C_in`` zero-padded to ``width``, a
    multiple of 32 (a halo tile that does not fit in shared memory goes to
    the ``wgmma`` loop), or as the fewest groups of at most ``width``
    channels each, a multiple of 32 whose K fits the ``wgmma`` loop's tap
    table. Zero channels add nothing to the sums, so each way is exact."""
    c = x_shape[-1]
    if int8_conv_k3.takes(x_shape, w_shape, stride, padding):
        return 1, c
    taps = int(np.prod(w_shape[1:-1]))
    # WGMMA_MAX_K is a multiple of K_STEP: K fits when taps * width does.
    most = 32 * (int8_conv_k3.WGMMA_MAX_K // taps // 32)
    if most == 0:
        raise ValueError(f"no int8 convolution takes {taps} taps with "
                         f"weights {w_shape}")
    wide = -(-c // 32) * 32
    groups = -(-wide // most)
    return groups, -(-wide // groups // 32) * 32


def _pad_channels(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (channels last) with zero channels up to ``width``,
    contiguous."""
    return F.pad(t, (0, width - t.shape[-1])).contiguous()


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> ReLU (``act=False`` drops the ReLU), N-d by the
    rank of ``kernel_size``. ``lowering="int8"`` runs the convolution as
    :func:`int8_conv` on the same parameters (inference only);
    ``"shift_matmul"`` is the plain convolution, at stride 1 only, as the
    JAX package's ``ShiftMatmulConv`` computes it. ``padding`` takes ints
    or ``(lo, hi)`` pairs per dim; unequal pairs pad the input with zeros
    before a convolution with none (:func:`explicit_padding`)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        stride: Sequence[int],
        padding: Padding,
        bias: bool = False,
        act: bool = True,
        lowering: str = "conv",
    ):
        if lowering not in ("conv", "shift_matmul", "int8"):
            raise ValueError(f"unknown conv lowering {lowering!r}")
        if lowering == "shift_matmul" and any(s != 1 for s in stride):
            raise ValueError("shift_matmul lowering supports stride 1 only")
        nd = len(kernel_size)
        pairs = padding_pairs(padding)
        symmetric = all(lo == hi for lo, hi in pairs)
        layers = [
            _CONV[nd](in_channels, out_channels, tuple(kernel_size),
                      stride=tuple(stride),
                      padding=tuple(lo for lo, _ in pairs) if symmetric
                      else 0, bias=bias),
            BatchNorm(out_channels),
        ]
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)
        self.lowering = lowering
        # Unequal pairs, which the convolution module (padding 0) leaves to
        # forward; None where the module pads as torch does.
        self.unequal_padding = None if symmetric else pairs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        if self.lowering != "int8":
            if self.unequal_padding is not None:
                x, _ = explicit_padding(x, self.unequal_padding, 0)
            return super().forward(x)
        if self.training:
            raise RuntimeError("the int8 lowering is for inference only")
        x = int8_conv(x, conv.weight, conv.bias, conv.stride,
                      self.unequal_padding or conv.padding)
        for layer in list(self)[1:]:
            x = layer(x)
        return x


class ResidualBlockND(nn.Module):
    """ConvBNReLU -> ConvBN (+ 1x1 ConvBN shortcut when the stride or width
    changes) -> ReLU; 3-d for video, 2-d for audio."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        stride: Sequence[int],
        lowering: str = "conv",
    ):
        super().__init__()
        nd = len(kernel_size)
        pad = [(k - 1) // 2 for k in kernel_size]
        self.conv1 = ConvBNAct(in_channels, out_channels, kernel_size, stride,
                               pad, lowering=lowering)
        self.conv2 = ConvBNAct(out_channels, out_channels, kernel_size,
                               [1] * nd, pad, act=False, lowering=lowering)
        if any(s != 1 for s in stride) or in_channels != out_channels:
            self.downsample = ConvBNAct(in_channels, out_channels, [1] * nd,
                                        stride, [0] * nd, act=False,
                                        lowering=lowering)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


def max_pool_same(
    x: torch.Tensor,
    window: Sequence[int],
    strides: Sequence[int],
    padding: Padding,
) -> torch.Tensor:
    """Max pool over the spatial dims of a channels-first tensor, padding
    with -inf (torch's MaxPool). ``padding`` is an int or a ``(lo, hi)``
    pair per spatial dim; what torch's pool cannot pad (unequal pairs, or
    more than half the window) is padded with -inf first."""
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[len(window)]
    x, pad = explicit_padding(x, padding, float("-inf"), window)
    return pool(x, tuple(window), tuple(strides), pad)


class MultiHeadAttention(nn.Module):
    """Batch-first multi-head attention with torch's packed parameters
    (``in_proj_weight`` ``(3D, D)``, ``in_proj_bias``, ``out_proj``): plain
    matmul + softmax. Attention-weight dropout applies in training only."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads, self.dropout = dim, num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor
    ) -> torch.Tensor:
        d, h = self.dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:d], b[:d])
        k = F.linear(key, w[d : 2 * d], b[d : 2 * d])
        v = F.linear(value, w[2 * d :], b[2 * d :])

        def split(t):  # (B, T, D) -> (B, H, T, dh)
            bsz, t_len, _ = t.shape
            return t.reshape(bsz, t_len, h, d // h).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        logits = (q @ k.transpose(-2, -1)) * (1.0 / (d // h) ** 0.5)
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        weights = dropout(weights, self.dropout, self.training)
        out = (weights @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], d))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer, exact GELU: the semantics of
    ``nn.TransformerEncoderLayer(norm_first=True, activation="gelu",
    batch_first=True)``, with its parameter names."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads, dropout)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.dropout(self.self_attn(h, h, h))
        h = self.dropout(gelu_exact(self.linear1(self.norm2(x))))
        return x + self.dropout(self.linear2(h))


def interp_linear_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation along axis 1 of ``(B, T, D)``:
    ``F.interpolate(mode="linear", align_corners=False)``."""
    if x.shape[1] == out_len:
        return x
    y = F.interpolate(x.transpose(1, 2), size=out_len, mode="linear",
                      align_corners=False)
    return y.transpose(1, 2)
