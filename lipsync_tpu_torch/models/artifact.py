"""Artifact detection branch (raw + delta + Laplacian high-frequency).

Counterpart of ``models/artifact.py`` in the JAX package:

1. Temporal-inconsistency detector: Conv3d D->D/2->D/4 (+BN+ReLU) over the
   visual feature map, global average pooled. (JAX lowers these convs as
   shift-and-matmul; a plain ``Conv3d`` is the same function.)
2. Delta branch: the frame difference of the feature map through the same
   detector weights; a one-frame map gives a zero delta.
3. High-frequency branch: a per-frame 3x3 Laplacian (3->3 channel mix),
   then Conv3d 3->32->64 with spatial stride 2, global average pooled. In
   eval mode the Laplacian + conv1 + BN + ReLU run as the fused kernel K2
   (``ops/kernels/hf_stem.py``); training mode (batch-statistics BN) is a
   different function and runs the modules. ``fold_stem`` (the JAX
   package's ``_FoldedStemConvBN``, a serving lowering) composes the
   Laplacian into conv1's kernel (:func:`compose_spatial`) and runs one
   (3, 5, 5) Conv3d instead, in either mode, with the same parameters; it
   does not launch K2.

Layouts are channels-last at the boundary: feature map ``(B, T, H, W, D)``,
raw clip ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lipsync_tpu_torch.models.layers import BatchNorm, compute_in
from lipsync_tpu_torch.ops.kernels.hf_stem import hf_stem


def _laplacian_kernel_3ch() -> torch.Tensor:
    """Per-channel spatial Laplacian as a Conv2d weight ``(out, in, 3, 3)``."""
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    w = torch.zeros(3, 3, 3, 3)
    for i in range(3):
        w[i, i] = k
    return w


def compose_spatial(lap_weight: torch.Tensor,
                    conv_weight: torch.Tensor) -> torch.Tensor:
    """A per-frame 2-d filter ``(m, i, kh, kw)`` composed into the following
    3-d conv ``(o, m, kt, bh, bw)``, in fp32: for cross-correlations
    ``z = k2 * (k1 * x)`` the composed kernel is ``K[o, i, t, a+p, b+q] =
    sum_m k1[m, i, a, b] k2[o, m, t, p, q]``, an ``(o, i, kt, kh+bh-1,
    kw+bw-1)`` kernel whose one conv over ``x`` (with summed padding) equals
    the pair except at outputs whose receptive field reaches the
    intermediate's zero-padding ring: the first and last strided row and
    column."""
    k1, k2 = lap_weight.float(), conv_weight.float()
    kh, kw = k1.shape[2], k1.shape[3]
    o, _, kt, bh, bw = k2.shape
    out = k2.new_zeros(o, k1.shape[1], kt, kh + bh - 1, kw + bw - 1)
    for a in range(kh):
        for b in range(kw):
            out[:, :, :, a : a + bh, b : b + bw] += torch.einsum(
                "mi,omtpq->oitpq", k1[:, :, a, b], k2)
    return out


def _conv_bn_relu_stack(dims, stride) -> nn.Sequential:
    """Sequential(Conv3d, BN, ReLU, Conv3d, BN, ReLU), k3 pad 1, biased."""
    layers = []
    for c_in, c_out in zip(dims[:-1], dims[1:]):
        layers += [
            nn.Conv3d(c_in, c_out, 3, stride=stride, padding=1, bias=True),
            BatchNorm(c_out),
            nn.ReLU(),
        ]
    return nn.Sequential(*layers)


class TemporalInconsistencyDetector(nn.Module):
    def __init__(self, feature_dim: int = 256):
        super().__init__()
        self.temporal_conv = _conv_bn_relu_stack(
            (feature_dim, feature_dim // 2, feature_dim // 4), 1
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W, D)`` -> fp32 ``(B, D/4)``, computed in ``x``'s
        dtype."""
        with compute_in(x):
            out = self.temporal_conv(x.permute(0, 4, 1, 2, 3)).float()
        return out.mean(dim=(2, 3, 4))  # (B, D/4)


class HighFrequencyDetector(nn.Module):
    def __init__(self, out_dim: int = 64, fold_stem: bool = False):
        super().__init__()
        self.fold_stem = fold_stem
        self.laplacian = nn.Conv2d(3, 3, 3, padding=1, bias=False)
        with torch.no_grad():
            self.laplacian.weight.copy_(_laplacian_kernel_3ch())
        self.conv3d = _conv_bn_relu_stack((3, 32, out_dim), (1, 2, 2))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W, 3)`` -> fp32 ``(B, out_dim)``; a bf16 clip runs the
        convolutions in bf16 (K2 accumulates in fp32 either way)."""
        b, t, h, w, c = video.shape
        with compute_in(video):
            if self.fold_stem:
                conv = self.conv3d[0]
                x = F.conv3d(video.permute(0, 4, 1, 2, 3),
                             compose_spatial(self.laplacian.weight,
                                             conv.weight),
                             conv.bias, stride=(1, 2, 2), padding=(1, 2, 2))
                x = self.conv3d[1:3](x)
            elif self.training:
                frames = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
                lap = self.laplacian(frames).reshape(b, t, c, h, w)
                x = self.conv3d[:3](lap.transpose(1, 2))
            else:
                conv, bn = self.conv3d[0], self.conv3d[1]
                x = hf_stem(
                    video.contiguous(), self.laplacian.weight, conv.weight,
                    conv.bias, bn.weight, bn.bias, bn.running_mean,
                    bn.running_var, bn.eps,
                ).permute(0, 4, 1, 2, 3)  # (B, 32, T, Ho, Wo)
            x = self.conv3d[3:](x).float()
        return x.mean(dim=(2, 3, 4))  # (B, out_dim)


class ArtifactDetector(nn.Module):
    def __init__(self, visual_feature_dim: int = 256, embed_dim: int = 256,
                 use_delta_map: bool = True, use_high_freq: bool = True,
                 high_freq_dim: int = 64, fold_hf_stem: bool = False):
        super().__init__()
        self.use_delta_map = use_delta_map
        self.temporal_detector = TemporalInconsistencyDetector(
            visual_feature_dim
        )
        in_dim = embed_dim + (visual_feature_dim // 4) * (1 + use_delta_map)
        if use_high_freq:
            self.high_freq_detector = HighFrequencyDetector(
                high_freq_dim, fold_stem=fold_hf_stem)
            in_dim += high_freq_dim
        else:
            self.high_freq_detector = None
        self.artifact_fusion = nn.Sequential(
            nn.Linear(in_dim, embed_dim), nn.ReLU(),
            nn.Linear(embed_dim, embed_dim // 2), nn.ReLU(),
        )

    def forward(
        self,
        visual_features: torch.Tensor,
        cls_output: torch.Tensor,
        raw_video: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        feats = [self.temporal_detector(visual_features)]
        if self.use_delta_map:
            if visual_features.shape[1] > 1:
                delta = visual_features[:, 1:] - visual_features[:, :-1]
            else:
                delta = torch.zeros_like(visual_features)
            feats.append(self.temporal_detector(delta))  # shared weights
        if self.high_freq_detector is not None and raw_video is not None:
            feats.append(self.high_freq_detector(raw_video))
        combined = torch.cat([cls_output, *feats], dim=-1)
        return self.artifact_fusion(combined)
