"""AV-HuBERT LARGE as a lip-sync deepfake detector.

The audio-visual speech encoder of Shi, Hsu, Lakhotia and Mohamed,
*Learning Audio-Visual Speech Representation by Masked Multimodal Cluster
Prediction* (ICLR 2022, arXiv:2201.02184; code: facebookresearch/av_hubert,
``avhubert/hubert.py`` and ``avhubert/resnet.py``), in eval mode, with a
detection head: the mean of the encoder's output over time, then one
linear map to a logit for P(REAL), as ``LipSyncModel`` emits. The head is
this system's own; no published head is copied.

Inputs, as the engine hands them over:
  visual: ``(B, T, H, W)`` grey mouth crops in [0, 1]
  audio:  ``(B, F, 4T[, 1])`` log-mel dB, ``F = mel_bins`` (26)
Output: ``(B,)`` fp32 logits.

The forward:

1. Pixels: the centre ``H - 2 * crop_margin`` square, ``(x - 0.421) /
   0.165``.
2. Video (``feature_extractor_video``): Conv3d 1->64 k(5,7,7) s(1,2,2),
   BatchNorm, PReLU, max-pool (1,3,3)/(1,2,2) (one kernel, K5, in bf16 on
   the card: :meth:`ResEncoder.stem`); then each frame through a
   ResNet-18 trunk (BasicBlocks [2, 2, 2, 2], widths 64-512, PReLU),
   average-pooled to 512 and projected to the encoder's width.
3. Audio (``feature_extractor_audio``): every 4 consecutive mel frames
   stacked, frame after frame, into one ``4F`` vector per video frame,
   layer-normalised without affine, projected to the encoder's width.
4. Fusion: audio and video features concatenated over channels (audio
   first, as ``AVHubertModel`` concatenates them), LayerNorm, linear back
   to the encoder's width.
5. Encoder: ``x + GELU(conv(x))`` with the weight-normalised grouped
   positional convolution (its last output step dropped: ``SamePad``),
   then pre-LayerNorm transformer layers and a final LayerNorm.
6. Head: mean over time, linear to one logit.

Parameters carry the published module tree's names
(``feature_extractor_video.resnet.frontend3D.0.weight``,
``encoder.pos_conv.0.weight_g``, ``encoder.layers.3.self_attn.q_proj.
weight``, ...), so a checkpoint's state dict maps onto them by name. The
positional convolution's weight norm (``g * v / ||v||``, the norm per tap)
is folded into one weight when a state dict is loaded.

Precision. ``dtype=torch.bfloat16`` stores the weights of every
convolution, linear map and PReLU in bf16 and keeps the activations in
bf16; BatchNorm and LayerNorm keep fp32 parameters and compute in fp32
(BatchNorm's kernel reads bf16 and stores bf16; LayerNorm runs on an fp32
copy, rounded back) and attention's softmax runs in fp32 inside
``scaled_dot_product_attention``. The positional convolution's
``g`` and ``v`` stay fp32 and its folded weight is stored in ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lipsync_tpu_torch.ops.kernels import av_stem
from lipsync_tpu_torch.utils import profiling

MEAN, STD = 0.421, 0.165  # of the grey pixels in [0, 1]
STACK = 4  # mel frames per video frame (AV-HuBERT's stack_order_audio)
RESNET_WIDTHS = (64, 128, 256, 512)
STEM_T = 5  # the 3D stem's temporal kernel
# cv2's luma weights for 8-bit RGB -> grey (fixed point, 15 fractional
# bits: OpenCV's RGB2GRAY for CV_8U, equal to cv2.cvtColor at every pixel)
LUMA_U8 = (9798, 19235, 3735)
LUMA_SHIFT = 15
LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class AVHubertConfig:
    """The detector's geometry. The defaults are AV-HuBERT LARGE at the
    system's 32-frame window; ``embed_dim``, ``ffn_dim`` and ``heads`` are
    fairseq's ``encoder_embed_dim``, ``encoder_ffn_embed_dim`` and
    ``encoder_attention_heads``."""

    video_frames: int = 32
    crop_size: int = 96
    crop_margin: int = 4  # a side: 96 -> 88, AV-HuBERT's centre crop
    mel_bins: int = 26
    audio_frames: int = 128  # STACK * video_frames
    encoder_layers: int = 24
    embed_dim: int = 1024
    ffn_dim: int = 4096
    heads: int = 16
    conv_pos: int = 128
    conv_pos_groups: int = 16


def grey_pixels(rgb):
    """RGB crops (``(..., 3)``, in the crops' channel order) to grey with
    cv2's luma weights: uint8 as ``cv2.COLOR_RGB2GRAY`` computes it
    (fixed point, rounded), floats as the weighted sum. numpy in, numpy
    out."""
    if rgb.dtype == np.uint8:
        r, g, b = LUMA_U8
        acc = (rgb[..., 0].astype(np.int32) * r
               + rgb[..., 1].astype(np.int32) * g
               + rgb[..., 2].astype(np.int32) * b
               + (1 << (LUMA_SHIFT - 1))) >> LUMA_SHIFT
        return acc.astype(np.uint8)
    r, g, b = LUMA
    return (rgb[..., 0] * r + rgb[..., 1] * g + rgb[..., 2] * b).astype(
        np.float32)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over every dim but the last (the
    taps of a Conv1d weight normalised with ``dim=2``)."""
    return g * v / v.norm(dim=(0, 1), keepdim=True)


def stack_audio(audio: torch.Tensor, frames: int) -> torch.Tensor:
    """``(B, F, 4T[, 1])`` -> ``(B, T, 4F)``: every 4 consecutive mel
    frames side by side, frame after frame (AV-HuBERT's ``stacker``)."""
    if audio.dim() == 4:
        audio = audio[..., 0]
    b, f, t_a = audio.shape
    if t_a != STACK * frames:
        raise ValueError(f"AV-HuBERT takes {STACK} mel frames per video "
                         f"frame: {t_a} for {frames} frames")
    return audio.transpose(1, 2).reshape(b, frames, STACK * f)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in fp32 (its parameters stay fp32) and
    stored back in the input's dtype: CUDA's layer norm takes no bf16
    input with fp32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Swish(nn.Module):
    """``x * sigmoid(x)``, computed as one operation (``F.silu``: in bf16 the
    exact product rounded once)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x)


ACTIVATIONS = ("prelu", "swish")


def activation(kind: str, channels: int) -> nn.Module:
    """The ResNet's activation: PReLU (one slope a channel, AV-HuBERT) or
    Swish (no parameter, Auto-AVSR)."""
    if kind == "prelu":
        return nn.PReLU(channels)
    if kind == "swish":
        return Swish()
    raise ValueError(f"activation must be one of {ACTIVATIONS}, got {kind!r}")


class BasicBlock(nn.Module):
    """ResNet BasicBlock: conv3x3, BN, act, conv3x3, BN, the shortcut added
    (1x1 conv + BN where the shape changes), act; act is PReLU or Swish."""

    def __init__(self, cin: int, cout: int, stride: int, act: str = "prelu"):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu1 = activation(act, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.relu2 = activation(act, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + shortcut)


class ResNetTrunk(nn.Module):
    """ResNet-18's four stages over single frames, average-pooled."""

    def __init__(self, act: str = "prelu"):
        super().__init__()
        cin = RESNET_WIDTHS[0]
        for i, (cout, stride) in enumerate(zip(RESNET_WIDTHS, (1, 2, 2, 2))):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, cout, stride, act),
                BasicBlock(cout, cout, 1, act)))
            cin = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3))


def stem_takes_kernel(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether K5 runs the 3D stem: a bf16 CUDA input, the module in eval
    mode and no gradient recorded. Everything else (the CPU, fp32,
    training) runs the module chain."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and not module.training
            and not torch.is_grad_enabled())


class ResEncoder(nn.Module):
    """The 3D stem over the clip, then the trunk on each frame: AV-HuBERT's
    ``ResEncoder`` with PReLU, Auto-AVSR's ``Conv3dResNet`` with Swish (the
    same modules under the same names). ``name`` prefixes K5's span and
    counters (``<name>.stem``, ``<name>.stem_calls``,
    ``<name>.stem_outputs``)."""

    def __init__(self, act: str = "prelu", name: str = "avhubert"):
        super().__init__()
        c = RESNET_WIDTHS[0]
        self.name = name
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, c, (STEM_T, 7, 7), (1, 2, 2), (STEM_T // 2, 3, 3),
                      bias=False),
            nn.BatchNorm3d(c), activation(act, c),
            nn.MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)))
        self.trunk = ResNetTrunk(act)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """``frontend3D``: ``(B, 1, T, H, W)`` -> ``(B, C, T, h, w)``, by
        K5 where :func:`stem_takes_kernel` says so (a view of the ``(B, T,
        C, h, w)`` frames it writes), else by the module chain."""
        if not stem_takes_kernel(x, self):
            return self.frontend3D(x)
        b, _, t, h, w = x.shape
        profiling.count(f"{self.name}.stem_calls", 1)
        profiling.count(f"{self.name}.stem_outputs",
                        b * t * av_stem.out_size(h) * av_stem.out_size(w))
        with profiling.span(f"{self.name}.stem", device=x.device):
            return av_stem.av_stem(x, *av_stem.operands(self.frontend3D))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, 1, T, H, W)`` -> ``(B, T, 512)``."""
        x = self.stem(x)  # (B, C, T, h, w)
        b, c, t, h, w = x.shape
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        return self.trunk(x).view(b, t, -1)


class VideoFeatures(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.resnet = ResEncoder()
        self.proj = nn.Linear(RESNET_WIDTHS[-1], dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.resnet(x))


class AudioFeatures(nn.Module):
    def __init__(self, mel_bins: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(STACK * mel_bins, dim)

    def forward(self, stacked: torch.Tensor) -> torch.Tensor:
        """``(B, T, 4F)`` fp32 -> ``(B, T, dim)``: the per-frame layer
        norm (no affine) in fp32, then the projection in its dtype."""
        x = F.layer_norm(stacked.float(), stacked.shape[-1:])
        return self.proj(x.to(self.proj.weight.dtype))


class PosConv(nn.Module):
    """The encoder's positional convolution: a grouped Conv1d whose weight
    is ``g * v / ||v||`` (``weight_g``, ``weight_v``), padded by half its
    kernel, its last output step dropped when the kernel is even
    (``SamePad``). The forward runs on the weight and bias that
    :meth:`fold` stored in the compute dtype."""

    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.empty(dim, dim // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(dim))
        nn.init.normal_(self.weight_v)
        self.register_buffer("folded_weight", None, persistent=False)
        self.register_buffer("folded_bias", None, persistent=False)

    def fold(self, dtype: torch.dtype) -> None:
        with torch.no_grad():
            self.folded_weight = fold_weight_norm(
                self.weight_g.float(), self.weight_v.float()).to(dtype)
            self.folded_bias = self.bias.detach().to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, D)`` -> ``(B, T, D)``, before the GELU."""
        y = F.conv1d(x.transpose(1, 2), self.folded_weight, self.folded_bias,
                     padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[..., :-1]
        return y.transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape

        def split(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class EncoderLayer(nn.Module):
    """Pre-LayerNorm transformer layer (``layer_norm_first``)."""

    def __init__(self, dim: int, ffn: int, heads: int):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.self_attn_layer_norm = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn)
        self.fc2 = nn.Linear(ffn, dim)
        self.final_layer_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class Encoder(nn.Module):
    def __init__(self, cfg: AVHubertConfig):
        super().__init__()
        d = cfg.embed_dim
        self.pos_conv = nn.ModuleList(
            [PosConv(d, cfg.conv_pos, cfg.conv_pos_groups)])
        self.layers = nn.ModuleList(
            EncoderLayer(d, cfg.ffn_dim, cfg.heads)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + F.gelu(self.pos_conv[0](x))
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x)


class AVHubert(nn.Module):
    """AV-HuBERT (eval mode) and the detection head; see the module's
    docstring."""

    # Frames on each side of a frame that its visual features depend on:
    # the 3D stem's temporal half-width (the trunk sees one frame).
    temporal_halo = STEM_T // 2

    @staticmethod
    def host_pixels(crops):
        """The host's crops as this model takes them: grey. RGB ones (a
        trailing axis of 3, in the crops' channel order; no grey crop is 3
        pixels wide) are turned grey with cv2's luma weights."""
        return grey_pixels(crops) if crops.shape[-1] == 3 else crops

    @staticmethod
    def host_audio(audio):
        """The host's mel windows as this model takes them: ``(N, F, T_a,
        1)``."""
        return audio[..., None] if audio.ndim == 3 else audio

    def audio_shape(self):
        """One window's mel as the host hands it over: ``(F, T_a)``."""
        return (self.config.mel_bins, self.config.audio_frames)

    def __init__(self, config: AVHubertConfig = AVHubertConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.config, self.dtype = config, dtype
        d = config.embed_dim
        self.feature_extractor_video = VideoFeatures(d)
        self.feature_extractor_audio = AudioFeatures(config.mel_bins, d)
        self.layer_norm = LayerNorm(2 * d)
        self.post_extract_proj = nn.Linear(2 * d, d)
        self.encoder = Encoder(config)
        self.head = nn.Linear(d, 1)
        for m in self.modules():  # norms and the weight norm stay fp32
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.PReLU)):
                m.to(dtype)
        self.encoder.pos_conv[0].fold(dtype)

    def load_state_dict(self, state_dict: Mapping[str, Any],
                        strict: bool = True, assign: bool = False):
        """Load, then fold the positional convolution's weight norm."""
        out = super().load_state_dict(state_dict, strict=strict,
                                      assign=assign)
        self.encoder.pos_conv[0].fold(self.dtype)
        return out

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
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``((B, T, D) video features, None)`` for ``(B, T, H, W)``
        pixels; T need not equal ``video_frames``."""
        if visual.dim() != 4:
            raise ValueError(
                f"AVHubert expects (B, T, H, W) grey, got {tuple(visual.shape)}")
        with profiling.span("avhubert.visual", device=visual.device):
            return self.feature_extractor_video(self._pixels(visual)), None

    def score_encoded(self, v_feat: torch.Tensor, v_map: Optional[Any],
                      raw_visual: Optional[torch.Tensor],
                      audio: torch.Tensor) -> torch.Tensor:
        """Everything after the video features: audio features, fusion,
        encoder, head."""
        b, t, _ = v_feat.shape
        a_feat = self.feature_extractor_audio(stack_audio(audio, t))
        x = self.layer_norm(torch.cat([a_feat, v_feat], dim=-1))
        x = self.post_extract_proj(x)
        profiling.count("avhubert.encoder_tokens", b * t)
        with profiling.span("avhubert.encoder", device=x.device):
            x = self.encoder(x)
        return self.head(x.mean(dim=1)).squeeze(-1).float()
