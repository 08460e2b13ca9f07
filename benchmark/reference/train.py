"""Plain reference of one training step of the lip-sync model.

The objective of the published training loop: BCE with logits, plus 0.1 x a
cross-modal InfoNCE (real pairs) with a margin push-down of fake pairs'
diagonal, plus 0.2 x a sync InfoNCE of (video, aligned audio) against the
audio rolled in time by a shift drawn from +-{5, 10, 15} mel frames, scored
by a second forward. That forward updates no BatchNorm statistics and draws
the same dropout masks as the first. Before the forwards the batch is
augmented on its device (speed warp, flip, rotation with a reflected
border, brightness, contrast, Gaussian noise; each jitter with p = 0.5).
Adam (betas 0.9 / 0.999, eps 1e-8, no weight decay) updates every
parameter.

The random draws are inputs that both sides take from the same seeds: the
augmentation's from a generator on the batch's device, the shift's from a
host generator, dropout's from the device's default generator, each drawn in
the order a step makes them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.model import Run, forward

SHIFTS = (5, 10, 15, -5, -10, -15)
NEG = -1e9


# ------------------------------------------------------------- augmentation
def draw_augment(gen: torch.Generator, visual_shape, audio_shape,
                 speed=(0.9, 1.1), rotation=15.0, brightness=(0.8, 1.2),
                 contrast=(0.8, 1.2)) -> Dict[str, torch.Tensor]:
    b, dev = visual_shape[0], gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

    def gate():
        return torch.rand(b, generator=gen, device=dev) > 0.5

    return {
        "speed": uniform(*speed), "flip": gate(),
        "angle": uniform(-rotation, rotation),
        "brightness": uniform(*brightness), "do_brightness": gate(),
        "contrast": uniform(*contrast), "do_contrast": gate(),
        "do_visual_noise": gate(),
        "visual_noise": torch.randn(tuple(visual_shape), generator=gen,
                                    device=dev),
        "do_audio_noise": gate(),
        "audio_noise": torch.randn(tuple(audio_shape[:3]), generator=gen,
                                   device=dev),
    }


def _reflect(idx, n):
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx < n, idx, 2 * n - 1 - idx)


def _speed_index(t, speed):
    base = torch.linspace(0.0, float(t - 1), t, device=speed.device)
    return (base[None] * speed[:, None]).clamp(0.0, float(t - 1)).long()


def _rotate(frames, angle_deg):
    """Bilinear rotation about (w/2, h/2) by the inverse map, reflected
    border (cv2.warpAffine with BORDER_REFLECT)."""
    b, t, h, w, c = frames.shape
    theta = angle_deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=frames.device),
        torch.arange(w, dtype=torch.float32, device=frames.device),
        indexing="ij")
    dx, dy = xx - w / 2.0, yy - h / 2.0
    sx = cos * dx - sin * dy + w / 2.0
    sy = sin * dx + cos * dy + h / 2.0
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx = (sx - x0)[:, None, :, :, None]
    wy = (sy - y0)[:, None, :, :, None]
    flat = frames.reshape(b, t, h * w, c)

    def at(yi, xi):
        lin = (_reflect(yi.long(), h) * w + _reflect(xi.long(), w)
               ).reshape(b, 1, h * w, 1)
        return torch.gather(flat, 2, lin.expand(b, t, h * w, c)).reshape(
            b, t, h, w, c)

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bottom = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bottom * wy


def augment(gen, visual, audio, visual_noise_std=0.02, audio_noise_std=0.01):
    """``visual`` (B, T, H, W, 3) in [0, 1], ``audio`` (B, F, Ta, 1) dB."""
    d = draw_augment(gen, tuple(visual.shape), tuple(audio.shape))
    audio = audio[..., 0]
    b, t = visual.shape[:2]
    f, t_a = audio.shape[1:]

    def each(x, ndim):
        return x.reshape((b,) + (1,) * (ndim - 1))

    rows = torch.arange(b, device=visual.device)[:, None]
    visual = visual[rows, _speed_index(t, d["speed"])]
    audio = torch.gather(audio, 2, _speed_index(t_a, d["speed"])[:, None, :]
                         .expand(b, f, t_a))
    visual = torch.where(each(d["flip"], 5), visual.flip(3), visual)
    visual = _rotate(visual, d["angle"])
    visual = torch.where(each(d["do_brightness"], 5),
                         (visual * each(d["brightness"], 5)).clamp(0, 1),
                         visual)
    mean = visual.mean(dim=(1, 2, 3, 4), keepdim=True)
    visual = torch.where(
        each(d["do_contrast"], 5),
        ((visual - mean) * each(d["contrast"], 5) + mean).clamp(0, 1), visual)
    visual = torch.where(each(d["do_visual_noise"], 5),
                         (visual + d["visual_noise"] * visual_noise_std
                          ).clamp(0, 1), visual)
    audio = torch.where(each(d["do_audio_noise"], 3),
                        (audio + d["audio_noise"] * audio_noise_std
                         ).clamp(-80, 0), audio)
    return visual, audio[..., None]


# ------------------------------------------------------------------ losses
def _pooled_unit(tokens):
    pooled = tokens.mean(dim=1)
    sq = (pooled * pooled).sum(dim=-1, keepdim=True)
    return pooled / sq.clamp(min=1e-24).sqrt()


def bce(logits, labels, mask):
    per = -(labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return (per * mask).sum() / mask.sum().clamp(min=1.0)


def cross_modal_loss(v_tok, a_tok, labels, mask, temperature=0.07,
                     margin=0.10):
    v, a = _pooled_unit(v_tok), _pooled_unit(a_tok)
    sim = (v @ a.T) / temperature
    b = sim.shape[0]
    diag = torch.diagonal(sim)
    real = (labels >= 0.5).float() * mask
    fake = (labels < 0.5).float() * mask
    n_real, n_fake, n_valid = real.sum(), fake.sum(), mask.sum()
    neg = torch.full_like(sim, NEG)
    cols = torch.where(mask[None, :] > 0, sim, neg)
    rows = torch.where(mask[:, None] > 0, sim, neg)
    row_ce = torch.logsumexp(cols, dim=1) - diag
    col_ce = torch.logsumexp(rows, dim=0) - diag
    real_term = ((row_ce * real).sum() + (col_ce * real).sum()) \
        / n_real.clamp(min=1.0)
    eye = torch.eye(b, dtype=torch.bool, device=sim.device)
    hard_row = torch.where(eye, neg, cols).max(dim=1).values
    hard_col = torch.where(eye, neg, rows).max(dim=0).values
    fake_term = 0.5 * (
        (F.relu(diag - hard_row + margin) * fake).sum()
        + (F.relu(diag - hard_col + margin) * fake).sum()) \
        / n_fake.clamp(min=1.0)
    has_real = (n_real > 0).float()
    has_fake = ((n_fake > 0) & (n_valid > 1)).float()
    terms = 2.0 * has_real + has_fake
    return (has_real * real_term + has_fake * fake_term) / terms.clamp(min=1.0)


def sync_loss(v_tok, a_tok, a_neg, real, temperature=0.07):
    v = _pooled_unit(v_tok)
    pos = (v * _pooled_unit(a_tok)).sum(-1) / temperature
    neg = (v * _pooled_unit(a_neg)).sum(-1) / temperature
    logits = torch.stack([pos, neg], dim=1)
    per = torch.logsumexp(logits, dim=1) - logits[:, 0]
    n = real.sum()
    return (per * real).sum() / n.clamp(min=1.0)


# -------------------------------------------------------------------- step
class Adam:
    """torch.optim.Adam's update, written out: lr, betas (0.9, 0.999),
    eps 1e-8."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.step_count = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.step_count += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1 = 1 - b1 ** self.step_count
        c2 = math.sqrt(1 - b2 ** self.step_count)
        for k, g in grads.items():
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / c2 + eps
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_step(params: Dict[str, torch.Tensor], cfg: Mapping, batch,
               adam: Adam, aug_gen: torch.Generator,
               shift_gen: torch.Generator, precision, dropout: float,
               keep_rows: Optional[int] = None
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One step on ``batch`` (``visual`` uint8 (B, T, H, W, 3), ``audio``
    (B, F, Ta, 1), ``label`` (B,), ``sample_mask`` (B,)): updates ``params``
    in place and returns the loss and the gradients. ``keep_rows`` keeps
    only the first rows of the batch for the losses (a fault that the
    comparison must catch)."""
    visual = batch["visual"].float() / 255.0
    with torch.no_grad():
        visual, audio = augment(aug_gen, visual, batch["audio"].float())
    shift = SHIFTS[int(torch.randint(len(SHIFTS), (), generator=shift_gen))]
    labels = batch["label"].float()
    mask = batch["sample_mask"].float()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if v.is_floating_point() and k in adam.m}
    weights = dict(params)
    weights.update(leaves)
    dev = visual.device
    rng = (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
           else torch.get_rng_state())
    run = Run(precision, training=True, dropout=dropout)
    logits, aux = forward(weights, cfg, visual, audio, run, return_aux=True)
    if dev.type == "cuda":
        torch.cuda.set_rng_state(rng, dev)
    else:
        torch.set_rng_state(rng)
    _, aux_neg = forward(weights, cfg, visual, torch.roll(audio, shift, 2),
                         run, return_aux=True)
    rows = slice(None) if keep_rows is None else slice(0, keep_rows)
    v_tok, a_tok = aux["visual_tokens"][rows], aux["audio_tokens"][rows]
    lab, msk = labels[rows], mask[rows]
    loss = bce(logits[rows], lab, msk) \
        + 0.1 * cross_modal_loss(v_tok, a_tok, lab, msk) \
        + 0.2 * sync_loss(v_tok, a_tok, aux_neg["audio_tokens"][rows],
                          ((lab >= 0.5) & (msk > 0)).float())
    names: List[str] = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    grads = dict(zip(names, grads))
    adam.step(params, grads)
    return float(loss.detach()), grads


def trainable(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters Adam updates: every float tensor but BatchNorm's
    running statistics."""
    return {k: v for k, v in params.items() if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))}
