"""Auto-AVSR's audio-visual conformer as a lip-sync deepfake detector.

The audio-visual speech encoder of Ma, Haliassos, Fernandez-Lopez, Chen,
Petridis and Pantic, *Auto-AVSR: Audio-Visual Speech Recognition with
Automatic Labels* (ICASSP 2023, arXiv:2303.14307; code:
mpc001/auto_avsr, its ESPnet-derived ``e2e_asr_conformer_av`` model, the
conformer ``Encoder``, ``Conv3dResNet`` and ``Conv1dResNet``), in eval
mode, without its decoder and CTC layer (the recogniser's output side),
with a detection head: the mean of the fused features over time, then one
linear map to a logit for P(REAL), as ``LipSyncModel`` emits. The head is
this system's own; no published head is copied.

Inputs, as the engine hands them over:
  visual: ``(B, T, H, W)`` grey mouth crops in [0, 1]
  audio:  ``(B, 1, 640 T)`` PCM at 16 kHz (640 samples a 25 fps frame)
Output: ``(B,)`` fp32 logits.

The forward:

1. Video (``encoder.frontend``, ``Conv3dResNet``): the centre ``H - 2 *
   crop_margin`` square, ``(x - 0.421) / 0.165``; Conv3d 1->64 k(5,7,7)
   s(1,2,2), BatchNorm, Swish, max-pool (1,3,3)/(1,2,2) (one kernel, K5's
   Swish instantiation, in bf16 on the card); each frame through ResNet-18
   with Swish, average-pooled to 512; ``encoder.embed.0`` projects it to
   ``adim``.
2. Audio (``aux_encoder.frontend``, ``Conv1dResNet``): the window's PCM
   normalised to zero mean and unit variance over the window, trimmed to
   ``640 T`` samples; Conv1d 1->64 k80 s4, BatchNorm, Swish; BasicBlocks
   [2, 2, 2, 2] at 64-512, strides 1/2/2/2; ``AvgPool1d(21, 20, padding
   1)``: T frames of 512; ``aux_encoder.embed.0`` projects them.
3. Each encoder: the relative positional encoding (``x * sqrt(adim)`` and
   a ``2T - 1``-row sinusoidal table), ``elayers`` conformer blocks, then
   ``after_norm``. A block: ``x + FFN(LN x) / 2`` (macaron), relative-
   position self-attention, the convolution module (LN, pointwise to
   ``2 adim``, GLU, depthwise Conv1d of ``cnn_module_kernel``, BatchNorm,
   Swish, pointwise), ``x + FFN(LN x) / 2``, then ``norm_final``.
4. Fusion (``MLPHead``): ``cat(video, audio)`` over channels (video
   first), Linear to ``fusion_hdim``, BatchNorm1d, ReLU, Linear to
   ``adim``.
5. Head: mean over time, linear to one logit.

Attention is ESPnet's ``RelPositionMultiHeadedAttention`` (``latest``):
``scores = ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k)`` with
learned per-head biases ``pos_bias_u``, ``pos_bias_v`` and a bias-free
``linear_pos`` over the table, where ``rel_shift`` takes, for query i and
key j, the table row of relative position ``i - j`` (:func:`rel_shift`, a
strided view, no copy).

Parameters carry the published module tree's names
(``encoder.frontend.frontend3D.0.weight``,
``encoder.encoders.3.self_attn.linear_pos.weight``,
``aux_encoder.frontend.trunk.layer1.0.conv1.weight``,
``fusion.fc1.weight``, ...), so a checkpoint's state dict maps onto them
by name.

Precision. ``dtype=torch.bfloat16`` stores the weights of every
convolution, linear map and the positional biases in bf16 and keeps the
activations in bf16; BatchNorm and LayerNorm keep fp32 parameters and
compute in fp32 (BatchNorm's kernel reads bf16 and stores bf16, LayerNorm
runs on an fp32 copy, rounded back), attention's softmax runs in fp32 on
the bf16 scores and is rounded once, and the PCM normalisation runs in
fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lipsync_tpu_torch.models.avhubert import (
    MEAN,
    RESNET_WIDTHS,
    STD,
    ResEncoder,
    Swish,
    grey_pixels,
)
from lipsync_tpu_torch.utils import profiling

SAMPLES_PER_FRAME = 640  # 16 kHz PCM a 25 fps video frame
# Samples a column of the predictor's framed PCM: the log-mel hop at 16 kHz,
# so that a PCM window is cut and aligned exactly as a log-mel window is.
PCM_HOP = 160
PCM_EPS = 1e-8  # auto_avsr's layer_norm(x, x.shape, eps=1e-8) of the PCM
LN_EPS = 1e-12  # ESPnet's LayerNorm
STEM_HALO = 2   # the 3D stem's temporal half-width


@dataclasses.dataclass(frozen=True)
class AutoAVSRConfig:
    """The detector's geometry. The defaults are Auto-AVSR's published
    widths (``adim``, ``aheads``, ``eunits``, ``elayers``,
    ``cnn_module_kernel``, ``fusion_hdim``, the same for both encoders) at
    a 96-frame window. ``audio_frames`` is the window's length in log-mel
    hops (4 a video frame), the unit in which ``Predictor.predict`` cuts
    and aligns audio windows; ``mel_bins`` is the log-mel that its policy
    reads (the model itself takes PCM)."""

    video_frames: int = 96
    crop_size: int = 96
    crop_margin: int = 4  # a side: 96 -> 88, Auto-AVSR's centre crop
    mel_bins: int = 80
    audio_frames: int = 384  # 4 * video_frames
    adim: int = 768
    aheads: int = 12
    eunits: int = 3072
    elayers: int = 12
    cnn_module_kernel: int = 31
    fusion_hdim: int = 8192


def frame_pcm(pcm: np.ndarray, target_frames: Optional[int] = None
              ) -> np.ndarray:
    """Mono PCM -> fp32 ``(160, T)`` in the log-mel's columns: ``T = 1 +
    len(pcm) // 160``, as many as the centred log-mel has; column c holds
    samples ``160 c`` to ``160 c + 159`` (zeros past the end). With
    ``target_frames``, cut to that many columns or padded by repeating the
    last one, as ``ops/mel.py::pad_or_truncate_frames`` does the mel."""
    pcm = np.asarray(pcm, np.float32)
    t = 1 + pcm.shape[0] // PCM_HOP
    padded = np.zeros(t * PCM_HOP, np.float32)
    padded[:pcm.shape[0]] = pcm
    framed = padded.reshape(t, PCM_HOP).T
    if target_frames is not None:
        if t < target_frames:
            framed = np.concatenate(
                [framed, np.repeat(framed[:, -1:], target_frames - t, 1)], 1)
        framed = framed[:, :target_frames]
    return np.ascontiguousarray(framed)


def rel_positions(t: int, dim: int) -> torch.Tensor:
    """ESPnet's ``RelPositionalEncoding`` table for ``t`` frames, fp32
    ``(2t - 1, dim)``: row r holds relative position ``t - 1 - r`` (from
    ``t - 1`` down to ``-(t - 1)``), as ``[sin(p w_i), cos(p w_i)]``
    interleaved with ``w_i = 10000^(-2i / dim)``."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / dim))
    table = torch.empty(2 * t - 1, dim)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """``(..., T, 2T - 1)`` scores against the table's rows -> ``(..., T,
    T)``: entry ``(i, j)`` is column ``T - 1 - i + j``, the row of relative
    position ``i - j``. A strided view of ``x`` (made contiguous first)."""
    x = x.contiguous()
    t = x.shape[-2]
    if x.shape[-1] != 2 * t - 1:
        raise ValueError(f"expected (..., T, 2T - 1), got {tuple(x.shape)}")
    stride = list(x.stride())
    stride[-2] = 2 * t - 2
    return x.as_strided(x.shape[:-1] + (t,), stride,
                        x.storage_offset() + t - 1)


def normalise_pcm(audio: torch.Tensor, frames: int) -> torch.Tensor:
    """``(B, 1, S)`` PCM -> fp32 ``(B, 1, 640 frames)``: zero mean and unit
    variance over each window's samples (``eps`` 1e-8), then trimmed to
    ``640 frames`` samples, as ``Conv1dResNet`` trims."""
    x = audio.float()
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"expected (B, 1, S) PCM, got {tuple(audio.shape)}")
    n = frames * SAMPLES_PER_FRAME
    if x.shape[-1] < n:
        raise ValueError(f"{frames} frames take {n} samples, got "
                         f"{x.shape[-1]}")
    x = F.layer_norm(x, x.shape[-1:], eps=PCM_EPS)
    return x[..., :n]


class LayerNorm(nn.LayerNorm):
    """ESPnet's LayerNorm (eps 1e-12), computed in fp32 (its parameters
    stay fp32) and stored back in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


# ------------------------------------------------------------- front ends
class BasicBlock1D(nn.Module):
    """``Conv1dResNet``'s BasicBlock: conv k3, BN, Swish, conv k3, BN, the
    shortcut added (k1 conv + BN where the shape changes), Swish."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv1d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm1d(cout)
        self.relu1 = Swish()
        self.conv2 = nn.Conv1d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm1d(cout)
        self.relu2 = Swish()
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv1d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm1d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + shortcut)


class ResNet1D(nn.Module):
    """ResNet-18-1D over the raw waveform: Conv1d 1->64 k80 s4 p38, BN,
    Swish, four stages, ``AvgPool1d(21, 20, padding=1)`` (640 samples a
    frame in, one frame out)."""

    def __init__(self):
        super().__init__()
        c = RESNET_WIDTHS[0]
        self.conv1 = nn.Conv1d(1, c, 80, 4, 38, bias=False)
        self.bn1 = nn.BatchNorm1d(c)
        self.relu = Swish()
        cin = c
        for i, (cout, stride) in enumerate(zip(RESNET_WIDTHS, (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock1D(cin, cout, stride), BasicBlock1D(cout, cout, 1)))
            cin = cout
        self.avgpool = nn.AvgPool1d(21, 20, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.avgpool(x)


class Conv1dResNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.trunk = ResNet1D()

    def forward(self, pcm: torch.Tensor) -> torch.Tensor:
        """``(B, 1, 640 T)`` -> ``(B, T, 512)``."""
        return self.trunk(pcm).transpose(1, 2)


# ---------------------------------------------------------- the conformer
class PositionwiseFeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, hidden)
        self.w_2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(F.relu(self.w_1(x)))


class RelPositionMultiHeadedAttention(nn.Module):
    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.h, self.d_k = heads, dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.d_k))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``x`` ``(B, T, D)``, ``pos`` the ``(2T - 1, D)`` table."""
        b, t, d = x.shape
        h, dk = self.h, self.d_k
        q = self.linear_q(x).view(b, t, h, dk)
        k = self.linear_k(x).view(b, t, h, dk).transpose(1, 2)
        v = self.linear_v(x).view(b, t, h, dk).transpose(1, 2)
        p = self.linear_pos(pos).view(2 * t - 1, h, dk).transpose(0, 1)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        ac = torch.matmul(q_u, k.transpose(-2, -1))
        bd = rel_shift(torch.matmul(q_v, p.transpose(-2, -1)))
        scores = (ac + bd) / math.sqrt(dk)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        return self.linear_out(out)


class ConvolutionModule(nn.Module):
    """Pointwise Conv1d to twice the width, GLU, depthwise Conv1d (kernel
    ``kernel``, padding half of it), BatchNorm1d, Swish, pointwise Conv1d.
    The pointwise convolutions run as linear maps over ``(B, T, C)``."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"the depthwise kernel must be odd, got {kernel}")
        self.pointwise_cov1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(channels, channels, kernel,
                                        padding=(kernel - 1) // 2,
                                        groups=channels)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_cov2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pw1, pw2 = self.pointwise_cov1, self.pointwise_cov2
        y = F.glu(F.linear(x, pw1.weight[..., 0], pw1.bias), dim=-1)
        y = F.silu(self.norm(self.depthwise_conv(y.transpose(1, 2))))
        return F.linear(y.transpose(1, 2), pw2.weight[..., 0], pw2.bias)


class ConformerLayer(nn.Module):
    """ESPnet's conformer ``EncoderLayer`` with ``macaron_style`` and the
    convolution module, pre-LayerNorm, in eval mode."""

    def __init__(self, cfg: AutoAVSRConfig):
        super().__init__()
        d = cfg.adim
        self.self_attn = RelPositionMultiHeadedAttention(cfg.aheads, d)
        self.feed_forward = PositionwiseFeedForward(d, cfg.eunits)
        self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.eunits)
        self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel)
        self.norm_ff = LayerNorm(d)
        self.norm_mha = LayerNorm(d)
        self.norm_ff_macaron = LayerNorm(d)
        self.norm_conv = LayerNorm(d)
        self.norm_final = LayerNorm(d)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class Encoder(nn.Module):
    """One modality's encoder: its front end, ``embed`` (the projection to
    ``adim``, then the relative positional encoding, which holds no
    parameter), the conformer blocks and ``after_norm``."""

    def __init__(self, cfg: AutoAVSRConfig, frontend: nn.Module):
        super().__init__()
        d = cfg.adim
        self.frontend = frontend
        self.embed = nn.Sequential(nn.Linear(RESNET_WIDTHS[-1], d))
        self.encoders = nn.ModuleList(ConformerLayer(cfg)
                                      for _ in range(cfg.elayers))
        self.after_norm = LayerNorm(d)
        self._tables: Dict[Tuple[int, torch.device, torch.dtype],
                           torch.Tensor] = {}

    def positions(self, t: int, ref: torch.Tensor) -> torch.Tensor:
        """The ``(2t - 1, adim)`` table in ``ref``'s dtype on its device,
        made once per length."""
        key = (t, ref.device, ref.dtype)
        table = self._tables.get(key)
        if table is None:
            table = rel_positions(t, ref.shape[-1]).to(ref.device, ref.dtype)
            self._tables[key] = table
        return table

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, adim)`` projected features -> the encoder's output:
        the positional encoding, the blocks, ``after_norm``."""
        pos = self.positions(x.shape[1], x)
        x = x * math.sqrt(x.shape[-1])
        for layer in self.encoders:
            x = layer(x, pos)
        return self.after_norm(x)


class MLPHead(nn.Module):
    """Auto-AVSR's fusion: Linear, BatchNorm1d over the hidden channels,
    ReLU, Linear."""

    def __init__(self, idim: int, hdim: int, odim: int):
        super().__init__()
        self.fc1 = nn.Linear(idim, hdim)
        self.bn1 = nn.BatchNorm1d(hdim)
        self.fc2 = nn.Linear(hdim, odim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        y = F.relu(self.bn1(self.fc1(x).reshape(b * t, -1)))
        return self.fc2(y).view(b, t, -1)


class AutoAVSR(nn.Module):
    """Auto-AVSR's AV conformer encoder (eval mode) and the detection head;
    see the module's docstring."""

    # Frames on each side of a frame that its video features depend on:
    # the 3D stem's temporal half-width (the trunk and the projection see
    # one frame; the positional encoding and the conformer come after).
    temporal_halo = STEM_HALO

    @staticmethod
    def host_pixels(crops):
        """The host's crops as this model takes them: grey. RGB ones (a
        trailing axis of 3, in the crops' channel order) are turned grey
        with cv2's luma weights."""
        return grey_pixels(crops) if crops.shape[-1] == 3 else crops

    @staticmethod
    def host_audio(audio: np.ndarray) -> np.ndarray:
        """The host's audio windows as this model takes them: ``(N, 1,
        S)`` PCM, as it comes; a predictor's framed PCM, ``(N, 160, C[,
        1])`` with column c holding samples ``160 c`` to ``160 c + 159``,
        is laid end to end."""
        if audio.ndim == 4:
            audio = audio[..., 0]
        if audio.ndim != 3 or audio.shape[1] not in (1, PCM_HOP):
            raise ValueError(f"expected (N, 1, S) PCM or (N, {PCM_HOP}, C) "
                             f"framed PCM, got {audio.shape}")
        if audio.shape[1] == 1:
            return audio
        return audio.transpose(0, 2, 1).reshape(audio.shape[0], 1, -1)

    def audio_shape(self) -> Tuple[int, ...]:
        """One window's audio as the engine takes it: ``(1, 640 T)``."""
        return (1, self.config.video_frames * SAMPLES_PER_FRAME)

    def __init__(self, config: AutoAVSRConfig = AutoAVSRConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if config.audio_frames * PCM_HOP != \
                config.video_frames * SAMPLES_PER_FRAME:
            raise ValueError(
                f"audio_frames must be 4 a video frame: {config.audio_frames}"
                f" for {config.video_frames} frames")
        self.config, self.dtype = config, dtype
        d = config.adim
        self.encoder = Encoder(config, ResEncoder("swish", "auto_avsr"))
        self.aux_encoder = Encoder(config, Conv1dResNet())
        self.fusion = MLPHead(2 * d, config.fusion_hdim, d)
        self.head = nn.Linear(d, 1)
        for m in self.modules():  # norms stay fp32
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear,
                              RelPositionMultiHeadedAttention)):
                m.to(dtype)

    def _pixels(self, visual: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W)`` in [0, 1] -> the normalised centre crop
        ``(B, 1, T, h, w)`` in the model's dtype."""
        m = self.config.crop_margin
        h, w = visual.shape[-2:]
        x = visual.float()[..., m:h - m, m:w - m]
        return ((x - MEAN) / STD).to(self.dtype).unsqueeze(1)

    def forward(self, visual: torch.Tensor,
                audio: torch.Tensor) -> torch.Tensor:
        v_feat, _ = self.encode_visual(visual)
        return self.score_encoded(v_feat, None, visual, audio)

    def encode_visual(
        self, visual: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[Any]]:
        """``((B, T, adim) projected video features, None)`` for ``(B, T,
        H, W)`` pixels; T need not equal ``video_frames``."""
        if visual.dim() != 4:
            raise ValueError(
                f"AutoAVSR expects (B, T, H, W) grey, got {tuple(visual.shape)}")
        with profiling.span("auto_avsr.video", device=visual.device):
            feat = self.encoder.frontend(self._pixels(visual))
            return self.encoder.embed[0](feat), None

    def encode_audio(self, audio: torch.Tensor, frames: int) -> torch.Tensor:
        """``(B, 1, S)`` PCM -> ``(B, frames, adim)`` projected audio
        features."""
        x = normalise_pcm(audio, frames).to(self.dtype)
        return self.aux_encoder.embed[0](self.aux_encoder.frontend(x))

    def score_encoded(self, v_feat: torch.Tensor, v_map: Optional[Any],
                      raw_visual: Optional[torch.Tensor],
                      audio: torch.Tensor) -> torch.Tensor:
        """Everything after the video features: both encoders, the audio
        front end, fusion and the head."""
        b, t, _ = v_feat.shape
        dev = v_feat.device
        profiling.count("auto_avsr.encoder_tokens", b * t)
        with profiling.span("auto_avsr.video_encoder", device=dev):
            v = self.encoder.encode(v_feat)
        with profiling.span("auto_avsr.audio", device=dev):
            a = self.encode_audio(audio, t)
        with profiling.span("auto_avsr.audio_encoder", device=dev):
            a = self.aux_encoder.encode(a)
        with profiling.span("auto_avsr.fusion", device=dev):
            x = self.fusion(torch.cat([v, a], dim=-1))
            return self.head(x.mean(dim=1)).squeeze(-1).float()
