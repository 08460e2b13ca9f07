"""Feature projection + bidirectional gated cross-modal attention.

Counterpart of ``models/fusion.py`` in the JAX package (``FeatureProjection``
and ``CrossModalAttention``): audio is linearly interpolated to the visual
token rate, video attends to audio and audio to video, and a per-token
sigmoid gate blends the two before a Linear+ReLU fuse. Tokens are
``(B, T, D)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.layers import (
    MultiHeadAttention,
    interp_linear_time,
)


class FeatureProjection(nn.Module):
    def __init__(self, visual_dim: int = 256, audio_dim: int = 256,
                 embed_dim: int = 256):
        super().__init__()
        self.visual_proj = nn.Linear(visual_dim, embed_dim)
        self.audio_proj = nn.Linear(audio_dim, embed_dim)

    def forward(
        self, visual_feat: torch.Tensor, audio_feat: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.visual_proj(visual_feat), self.audio_proj(audio_feat)


class CrossModalAttention(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.v2a_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.a2v_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.gate = nn.Sequential(
            nn.Linear(2 * embed_dim, embed_dim), nn.GELU(),
            nn.Linear(embed_dim, 1), nn.Sigmoid(),
        )
        self.fuse = nn.Sequential(nn.Linear(embed_dim, embed_dim), nn.ReLU())

    def forward(
        self, visual_emb: torch.Tensor, audio_emb: torch.Tensor
    ) -> torch.Tensor:
        audio_emb = interp_linear_time(audio_emb, visual_emb.shape[1])
        v_out = visual_emb + self.v2a_attn(visual_emb, audio_emb, audio_emb)
        a_out = audio_emb + self.a2v_attn(audio_emb, visual_emb, visual_emb)
        g = self.gate(torch.cat([v_out, a_out], dim=-1))
        return self.fuse(g * v_out + (1.0 - g) * a_out)
