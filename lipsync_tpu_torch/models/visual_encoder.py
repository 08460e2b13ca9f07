"""3D-ResNet visual encoder over mouth-crop clips.

Counterpart of ``models/visual_encoder.py`` in the JAX package: stem Conv3d
3->64 k(3,7,7) s(1,2,2) + max-pool (1,3,3)/(1,2,2), four residual stages
64->64->128->256->feature_dim with spatial-only strides, spatial-only
average pooling. Input ``(B, T, H, W, 3)``; pooled output ``(B, T, D)``;
feature map ``(B, T, H', W', D)``.

Precision: the stem and layers 1-2 always run in fp32. ``dtype`` (default:
the input's) sets the precision of layers 3-4 (autocast for bf16) and of
the feature map, which the artifact branch's convolutions consume; the
pooled output is fp32. On BatchNorm-calibrated weights, bf16 in the stem
alone moves P(REAL) by up to ~1e-2 against fp32, more than the 4e-3 the
served path is held to (PERF.md). ``conv_lowering="int8"`` runs every
convolution through K3 (``layers.int8_conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.layers import (
    ConvBNAct,
    ResidualBlockND,
    compute_in,
    dropout,
    max_pool_same,
)


class VisualEncoder(nn.Module):
    def __init__(self, feature_dim: int = 256, base_channels: int = 64,
                 dropout: float = 0.1, conv_lowering: str = "conv"):
        super().__init__()
        c = base_channels
        self.dropout = dropout
        low = conv_lowering
        self.stem = ConvBNAct(3, c, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                              lowering=low)
        self.layer1 = ResidualBlockND(c, c, (3, 3, 3), (1, 1, 1), low)
        self.layer2 = ResidualBlockND(c, c * 2, (3, 3, 3), (1, 2, 2), low)
        self.layer3 = ResidualBlockND(c * 2, c * 4, (3, 3, 3), (1, 2, 2), low)
        self.layer4 = ResidualBlockND(c * 4, feature_dim, (3, 3, 3), (1, 2, 2),
                                      low)

    @property
    def temporal_halo(self) -> int:
        """How many frames on each side of a frame its outputs depend on:
        the temporal half-widths of the main path's convolutions (none of
        them strides in time; the shortcuts are 1x1x1)."""
        convs = [self.stem[0]]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            convs += [layer.conv1[0], layer.conv2[0]]
        return sum((c.kernel_size[0] - 1) // 2 for c in convs)

    def forward(self, x: torch.Tensor, return_map: bool = False,
                dtype: Optional[torch.dtype] = None):
        if x.dim() != 5:
            raise ValueError(
                f"VisualEncoder expects (B, T, H, W, 3), got {tuple(x.shape)}"
            )
        out = self.stem(x.float().permute(0, 4, 1, 2, 3))  # (B, C, T, H, W)
        out = max_pool_same(out, (1, 3, 3), (1, 2, 2),
                            ((0, 0), (1, 1), (1, 1)))
        out = self.layer2(self.layer1(out)).to(dtype or x.dtype)
        with compute_in(out):
            out = self.layer4(self.layer3(out))
            out = dropout(out, self.dropout, self.training, feature=True)
        pooled = out.float().mean(dim=(3, 4)).transpose(1, 2)  # (B, T, D)
        if return_map:
            return pooled, out.permute(0, 2, 3, 4, 1)  # (B, T, H', W', D)
        return pooled
