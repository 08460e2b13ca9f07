"""Multi-scale temporal transformer with CLS aggregation.

Counterpart of ``models/temporal.py::TemporalTransformer`` in the JAX
package: parallel Conv1d branches (k=3, 5, 7) + BN + GELU, concatenated and
projected back with a residual add; a learnable CLS token is prepended and
N pre-norm encoder layers run over the ``(1+T)``-token sequence; the CLS
output is returned. :func:`temporal_aggregation` is the reference's legacy
masked mean over time, which no model wires in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.layers import (
    BatchNorm,
    TransformerEncoderLayer,
)


class _Encoder(nn.Module):
    """Holds the layers under ``transformer.layers.<i>``, the reference's
    ``nn.TransformerEncoder`` naming."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class TemporalTransformer(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.1,
                 pre_conv: bool = True, multi_scale_pre_conv: bool = True):
        super().__init__()
        self.multi_scale = pre_conv and multi_scale_pre_conv
        if self.multi_scale:
            for k in (3, 5, 7):
                self.add_module(f"branch_k{k}", nn.Sequential(
                    nn.Conv1d(embed_dim, embed_dim, k, padding=k // 2,
                              bias=False),
                    BatchNorm(embed_dim),
                    nn.GELU(),
                ))
            self.pre_scale_proj = nn.Linear(3 * embed_dim, embed_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)
        self.transformer = _Encoder([
            TransformerEncoderLayer(embed_dim, num_heads, 4 * embed_dim,
                                    dropout)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, d = x.shape
        if self.multi_scale:
            xc = x.transpose(1, 2)  # (B, D, T)
            branches = [
                getattr(self, f"branch_k{k}")(xc) for k in (3, 5, 7)
            ]
            x = x + self.pre_scale_proj(torch.cat(branches, 1).transpose(1, 2))
        cls = self.cls_token.to(x.dtype).expand(b, 1, d)
        tokens = self.transformer(torch.cat([cls, x], dim=1))
        return tokens[:, 0]


def temporal_aggregation(
    x: torch.Tensor, lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Masked global-average pooling over time, the JAX package's
    ``temporal_aggregation`` (the reference's parameter-free legacy
    ``TemporalAggregation``): the mean over axis 1, or with ``lengths``
    (``(B,)`` valid lengths) the mean over ``t < lengths[b]``, with
    zero-length rows divided by 1.

    Args:
        x: ``(B, T, D)`` fused features.
        lengths: optional ``(B,)`` integer tensor of valid lengths.

    Returns:
        ``(B, D)`` pooled features.
    """
    if x.ndim != 3:
        raise ValueError(
            f"temporal_aggregation expects (B, T, D), got {tuple(x.shape)}"
        )
    if lengths is None:
        return x.mean(dim=1)
    lengths = torch.as_tensor(lengths, device=x.device)
    if lengths.ndim != 1 or lengths.shape[0] != x.shape[0]:
        raise ValueError("lengths must be (B,) and match the batch size")
    steps = torch.arange(x.shape[1], device=x.device)
    mask = (steps[None, :] < lengths[:, None]).to(x.dtype)[..., None]
    denom = lengths.clamp(min=1).to(x.dtype)[:, None]
    return (x * mask).sum(dim=1) / denom
