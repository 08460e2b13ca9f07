"""MLP head emitting one logit for P(REAL).

Counterpart of ``models/classifier.py`` in the JAX package:
Linear -> GELU -> Dropout -> LayerNorm -> Linear(1), named ``net.<i>``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.layers import Dropout


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 dropout: float = 0.1):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(in_dim, hidden_dim), nn.GELU(), Dropout(dropout),
            nn.LayerNorm(hidden_dim, eps=1e-5), nn.Linear(hidden_dim, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x).squeeze(-1)
