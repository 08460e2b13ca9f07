"""Training losses: BCE + two contrastive objectives.

Counterpart of ``training/losses.py`` in the JAX package, on tensors, with
the same static-shape masking: a masked mean reproduces the reference's
"skip-if-empty" semantics (an absent class contributes no term and the
term count shrinks), and a ``sample_mask`` row counts nowhere, neither as a
term nor as a negative.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# Finite sentinel for masked similarities (|sim| <= 1/temperature << 1e9),
# so that a fully masked row's max stays finite and 0-weights remove it.
_NEG = -1e9


def bce_with_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean binary cross-entropy on logits; ``sample_mask`` (B,) excludes
    padded rows from the mean."""
    per_sample = -(labels * F.logsigmoid(logits)
                   + (1.0 - labels) * F.logsigmoid(-logits))
    if sample_mask is None:
        return per_sample.mean()
    m = sample_mask.float()
    return (per_sample * m).sum() / m.sum().clamp(min=1.0)


def _pooled_normalize(tokens: torch.Tensor) -> torch.Tensor:
    """Mean over time, then L2-normalise with the norm clamped at 1e-12 as
    ``sqrt(max(sum(x^2), 1e-24))``, whose gradient stays finite at an
    all-zero vector."""
    pooled = tokens.mean(dim=1)
    sq = (pooled * pooled).sum(dim=-1, keepdim=True)
    return pooled / sq.clamp(min=1e-24).sqrt()


def sync_contrastive_loss(
    visual_tokens: torch.Tensor,
    audio_tokens: torch.Tensor,
    audio_tokens_negatives: Sequence[torch.Tensor],
    real_mask: Optional[torch.Tensor] = None,
    temperature: float = 0.07,
) -> torch.Tensor:
    """InfoNCE of (video, aligned audio) against time-shifted negatives,
    averaged over REAL samples only."""
    if len(audio_tokens_negatives) == 0:
        return visual_tokens.new_zeros(())
    if real_mask is None:
        real_mask = torch.ones(visual_tokens.shape[0], dtype=torch.bool,
                               device=visual_tokens.device)
    real_f = real_mask.float()
    inv_t = 1.0 / max(temperature, 1e-6)
    v = _pooled_normalize(visual_tokens)
    a = _pooled_normalize(audio_tokens)
    pos = (v * a).sum(dim=-1) * inv_t
    negs = torch.stack(
        [(v * _pooled_normalize(an)).sum(dim=-1) * inv_t
         for an in audio_tokens_negatives],
        dim=1,
    )
    logits = torch.cat([pos[:, None], negs], dim=1)
    per_sample = torch.logsumexp(logits, dim=1) - logits[:, 0]
    n_real = real_f.sum()
    loss = (per_sample * real_f).sum() / n_real.clamp(min=1.0)
    return torch.where(n_real > 0, loss, torch.zeros_like(loss))


def cross_modal_contrastive_loss(
    visual_tokens: torch.Tensor,
    audio_tokens: torch.Tensor,
    labels: torch.Tensor,
    temperature: float = 0.07,
    fake_margin: float = 0.10,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batch InfoNCE on real pairs + a margin push-down of the diagonal
    against the hardest negative for fake pairs."""
    labels = labels.reshape(-1)
    v = _pooled_normalize(visual_tokens)
    a = _pooled_normalize(audio_tokens)
    sim = (v @ a.T) / max(temperature, 1e-6)
    b = sim.shape[0]
    diag = torch.diagonal(sim)

    if sample_mask is None:
        valid = torch.ones(b, device=sim.device)
    else:
        valid = sample_mask.reshape(-1).float()
    is_real = (labels >= 0.5).float()
    real_f = is_real * valid
    fake_f = (1.0 - is_real) * valid
    n_real, n_fake, n_valid = real_f.sum(), fake_f.sum(), valid.sum()

    neg = torch.full_like(sim, _NEG)
    sim_cols = torch.where(valid[None, :] > 0, sim, neg)
    sim_rows = torch.where(valid[:, None] > 0, sim, neg)

    row_ce = torch.logsumexp(sim_cols, dim=1) - diag
    col_ce = torch.logsumexp(sim_rows, dim=0) - diag
    real_row = (row_ce * real_f).sum() / n_real.clamp(min=1.0)
    real_col = (col_ce * real_f).sum() / n_real.clamp(min=1.0)

    eye = torch.eye(b, dtype=torch.bool, device=sim.device)
    hardest_row = torch.where(eye, neg, sim_cols).max(dim=1).values
    hardest_col = torch.where(eye, neg, sim_rows).max(dim=0).values
    row_loss = (F.relu(diag - hardest_row + fake_margin) * fake_f).sum() \
        / n_fake.clamp(min=1.0)
    col_loss = (F.relu(diag - hardest_col + fake_margin) * fake_f).sum() \
        / n_fake.clamp(min=1.0)
    fake_term = 0.5 * (row_loss + col_loss)

    has_real = (n_real > 0).float()
    has_fake = ((n_fake > 0) & (n_valid > 1)).float()
    total = has_real * (real_row + real_col) + has_fake * fake_term
    n_terms = 2.0 * has_real + has_fake
    out = total / n_terms.clamp(min=1.0)
    return torch.where(n_terms > 0, out, torch.zeros_like(out))
