"""2D-ResNet encoder over log-mel spectrograms.

Counterpart of ``models/audio_encoder.py`` in the JAX package: stem Conv2d
1->64 k7 s2 + max-pool k3 s2, four residual stages; ``preserve_audio_temporal``
sets the layer3 stride to (2, 1) instead of (2, 2); frequency-only average
pooling. Input ``(B, F, T, 1)``; output ``(B, T', D)``.
``conv_lowering="int8"`` runs every convolution through K3
(``layers.int8_conv``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.layers import (
    ConvBNAct,
    ResidualBlockND,
    dropout,
    max_pool_same,
)


class AudioEncoder(nn.Module):
    def __init__(self, feature_dim: int = 256, base_channels: int = 64,
                 dropout: float = 0.1, preserve_audio_temporal: bool = True,
                 conv_lowering: str = "conv"):
        super().__init__()
        c = base_channels
        self.dropout = dropout
        layer3_stride = (2, 1) if preserve_audio_temporal else (2, 2)
        low = conv_lowering
        self.stem = ConvBNAct(1, c, (7, 7), (2, 2), (3, 3), lowering=low)
        self.layer1 = ResidualBlockND(c, c, (3, 3), (1, 1), low)
        self.layer2 = ResidualBlockND(c, c * 2, (3, 3), (2, 2), low)
        self.layer3 = ResidualBlockND(c * 2, c * 4, (3, 3), layer3_stride, low)
        self.layer4 = ResidualBlockND(c * 4, feature_dim, (3, 3), (2, 1), low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(
                f"AudioEncoder expects (B, F, T, 1), got {tuple(x.shape)}"
            )
        out = self.stem(x.permute(0, 3, 1, 2))  # (B, 1, F, T)
        out = max_pool_same(out, (3, 3), (2, 2), ((1, 1), (1, 1)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        out = dropout(out, self.dropout, self.training)
        return out.mean(dim=2).transpose(1, 2)  # (B, T', D)
