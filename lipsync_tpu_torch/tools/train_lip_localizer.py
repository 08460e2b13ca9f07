"""Train the lip-localizer CNN on synthetic faces with known lip boxes.

    python -m lipsync_tpu_torch.tools.train_lip_localizer --out weights/lip_localizer.npz

The port's counterpart of the JAX package's ``scripts/train_lip_localizer.py``:
the same face renderer, dataset, initialisation, optimiser (Adam), loss
(Huber, delta 0.1), batch draws and validation IoU, with the network as
``preprocessing/lip_localizer.py::LipLocalizerNet`` on the card (cuda:0
unless ``--device`` says otherwise). The CNN regresses the raw lip extent
inside the heuristic mouth box (``face_detection.face_bbox_to_mouth_bbox``
of a jittered face box).

Training data is rendered here with its own face family: single-ellipse
lips, stacked two-lip style and open-mouth interiors, with position, scale,
colour, noise and occluders randomized. The crop-agreement evaluation uses
a separately written renderer, so its IoU is not a memorized pixel pattern.

Writes ``--out`` (``np.savez`` of the flat parameter set that the numpy
``LipLocalizer`` loads) and a ``.json`` beside it with the same keys as the
JAX script's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.preprocessing import lip_localizer as ll
from lipsync_tpu_torch.preprocessing.face_detection import (
    face_bbox_to_mouth_bbox,
)
from lipsync_tpu_torch.utils.device import (
    DeviceLike,
    disable_tf32,
    get_device,
)

HUBER_DELTA = 0.1
LOG_EVERY = 500


def render_training_face(rng: np.random.RandomState):
    """One face frame + (heuristic mouth box, raw lip box), draw for draw
    the JAX script's renderer.

    Lip styles: 0 = filled ellipse (+ dark interior when open, the
    phoneme-generator look), 1 = stacked upper/lower lip ellipses around
    a dark mouth line, 2 = asymmetric two-lip. Returns None when the
    jittered heuristic box misses the lips (skip)."""
    h = int(rng.uniform(100, 220))
    w = int(rng.uniform(120, 280))
    face_w = int(rng.uniform(0.30, 0.62) * min(h, w) * 1.3)
    face_h = int(face_w * rng.uniform(1.15, 1.5))
    cx = int(rng.uniform(face_w * 0.55, w - face_w * 0.55))
    cy = int(rng.uniform(face_h * 0.55, h - face_h * 0.55))
    skin = np.asarray((205, 170, 150)) * rng.uniform(0.5, 1.2)
    lip_color = np.asarray((140, 60, 60)) * rng.uniform(0.6, 1.35)
    noise = rng.uniform(0, 15)

    frame = rng.randint(0, 40, size=(h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    face = (
        ((yy - cy) / (face_h / 2)) ** 2 + ((xx - cx) / (face_w / 2)) ** 2
    ) < 1
    frame[face] = skin
    for ex in (cx - face_w // 4, cx + face_w // 4):
        eye = ((yy - (cy - face_h // 5)) ** 2 + (xx - ex) ** 2) < (
            face_w * rng.uniform(0.04, 0.08)
        ) ** 2
        frame[eye] = (40, 30, 30)
    if rng.rand() < 0.5:  # nose shadow distractor
        nose = (np.abs(xx - cx) < face_w * 0.05) & (
            np.abs(yy - (cy + face_h * 0.05)) < face_h * 0.08
        )
        frame[nose] = skin * 0.85

    # Lips. With prob 0.5 the whole mouth is tilted by up to 25 degrees
    # (pose tilt).
    mcy = cy + int(rng.uniform(0.24, 0.34) * face_h)
    mcx = cx + int(rng.uniform(-0.04, 0.04) * face_w)
    mhw = int(rng.uniform(0.13, 0.24) * face_w)  # half width
    style = rng.randint(3)
    openness = rng.uniform(0, 1)
    theta = np.deg2rad(rng.uniform(-25, 25)) if rng.rand() < 0.5 else 0.0
    dxr = (xx - mcx) * np.cos(theta) + (yy - mcy) * np.sin(theta)
    dyr = -(xx - mcx) * np.sin(theta) + (yy - mcy) * np.cos(theta)
    if style == 0:
        ay = max(2.0, face_h * (0.018 + 0.075 * openness))
        lips = ((dyr / ay) ** 2 + (dxr / mhw) ** 2) < 1
        frame[lips] = lip_color
        if openness > 0.25:
            inner = (
                (dyr / max(1.0, ay * 0.55)) ** 2
                + (dxr / max(2.0, mhw * 0.7)) ** 2
            ) < 1
            frame[inner] = lip_color * 0.4
        lip_mask = lips
    else:
        gap = max(1, int(face_h * 0.015 * (0.3 + openness)))
        t_up = max(2, int(face_h * rng.uniform(0.025, 0.045)))
        t_lo = (t_up if style == 1
                else max(2, int(t_up * rng.uniform(1.2, 1.8))))
        upper = (
            ((dyr + gap + t_up // 2) / max(1, t_up / 2)) ** 2
            + (dxr / mhw) ** 2
        ) < 1
        lower = (
            ((dyr - gap - t_lo // 2) / max(1, t_lo / 1.6)) ** 2
            + (dxr / mhw) ** 2
        ) < 1
        line = (np.abs(dyr) < gap) & (np.abs(dxr) < mhw * 0.9)
        frame[upper | lower] = lip_color
        frame[line] = (45, 15, 15)
        lip_mask = upper | lower | line

    ys, xs = np.where(lip_mask)
    if ys.size == 0:
        return None
    gt = (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)

    # Stress augmentations, applied after the target is taken (it stays
    # the pre-occlusion lip extent): partial occluder, lighting ramp,
    # motion blur. Their probabilities keep the easy regime the majority.
    if rng.rand() < 0.35:
        occ_w = max(2, int((gt[2] - gt[0]) * rng.uniform(0.12, 0.35)))
        occ_h = max(2, int((gt[3] - gt[1]) * rng.uniform(0.5, 1.6)))
        side = rng.randint(2)
        ox1 = gt[0] - occ_w // 3 if side == 0 else gt[2] - 2 * occ_w // 3
        oy1 = int(gt[1] + (gt[3] - gt[1]) * rng.uniform(-0.3, 0.5))
        col = (skin * rng.uniform(0.8, 1.1) if rng.rand() < 0.5
               else np.asarray((35.0, 35.0, 40.0)))
        frame[max(0, oy1): oy1 + occ_h, max(0, ox1): ox1 + occ_w] = col
    if rng.rand() < 0.4:
        ang = rng.uniform(0, 2 * np.pi)
        ramp = (xx * np.cos(ang) + yy * np.sin(ang)).astype(np.float32)
        ramp = (ramp - ramp.min()) / max(1e-6, ramp.max() - ramp.min())
        lo_, hi_ = rng.uniform(0.45, 0.85), rng.uniform(1.0, 1.35)
        frame = frame * (lo_ + (hi_ - lo_) * ramp)[..., None]
    if rng.rand() < 0.3:
        k = int(rng.uniform(4, 14))
        csum = np.cumsum(np.pad(frame, ((0, 0), (k, 0), (0, 0))), axis=1)
        frame = (csum[:, k:] - csum[:, :-k]) / k

    if noise > 0:
        frame = frame + rng.randn(h, w, 3) * noise
    frame = np.clip(frame, 0, 255).astype(np.uint8)

    # Cascade-like jitter on the face box, then the reference heuristic.
    jscale = rng.uniform(0.88, 1.15)
    jx = int(rng.uniform(-0.06, 0.06) * face_w)
    jy = int(rng.uniform(-0.06, 0.06) * face_h)
    jw, jh = int(face_w * jscale), int(face_h * jscale)
    fx1 = max(0, cx + jx - jw // 2)
    fy1 = max(0, cy + jy - jh // 2)
    heur = face_bbox_to_mouth_bbox(fx1, fy1, jw, jh, w, h)
    hx1, hy1, hx2, hy2 = heur
    if hx2 - hx1 < 10 or hy2 - hy1 < 8:
        return None
    # Target: raw lip box in normalized heuristic-patch coords. Keep only
    # samples where the lips are at least mostly inside the box (the
    # production box contains them by construction).
    bw, bh = hx2 - hx1, hy2 - hy1
    tgt = np.array(
        [(gt[0] - hx1) / bw, (gt[1] - hy1) / bh,
         (gt[2] - hx1) / bw, (gt[3] - hy1) / bh], np.float32,
    )
    if tgt[0] < -0.2 or tgt[1] < -0.2 or tgt[2] > 1.2 or tgt[3] > 1.2:
        return None
    patch = ll.extract_patch(frame, heur)
    if patch is None:
        return None
    return patch, tgt


def build_dataset(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` rendered samples: patches ``(n, PATCH, PATCH, 3)`` float32 and
    targets ``(n, 4)`` float32."""
    rng = np.random.RandomState(seed)
    patches = np.empty((n, ll.PATCH, ll.PATCH, 3), np.float32)
    targets = np.empty((n, 4), np.float32)
    i = 0
    while i < n:
        s = render_training_face(rng)
        if s is None:
            continue
        patches[i], targets[i] = s
        i += 1
    return patches, targets


def loss_fn(net: ll.LipLocalizerNet, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Mean Huber loss at delta 0.1 (``optax.huber_loss``'s definition:
    0.5 d^2 inside delta, delta (|d| - delta / 2) outside)."""
    return F.huber_loss(net(x), y, delta=HUBER_DELTA)


def train_step(net: ll.LipLocalizerNet, opt: torch.optim.Optimizer,
               x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One Adam step on one batch; returns the batch's loss (before the
    step) and leaves the gradients in ``net``."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, x, y)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(net: ll.LipLocalizerNet, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 added outside the
    square root, bias-corrected moments."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def val_iou(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-sample IoU of normalized boxes, both clipped to the patch."""
    p_ = np.clip(pred, 0.0, 1.0)
    t_ = np.clip(target, 0.0, 1.0)
    ix1 = np.maximum(p_[:, 0], t_[:, 0])
    iy1 = np.maximum(p_[:, 1], t_[:, 1])
    ix2 = np.minimum(p_[:, 2], t_[:, 2])
    iy2 = np.minimum(p_[:, 3], t_[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area = (
        (p_[:, 2] - p_[:, 0]).clip(0) * (p_[:, 3] - p_[:, 1]).clip(0)
        + (t_[:, 2] - t_[:, 0]) * (t_[:, 3] - t_[:, 1]) - inter
    )
    return inter / np.maximum(area, 1e-6)


def train(
    px: np.ndarray, ty: np.ndarray, vx: np.ndarray, vy: np.ndarray, *,
    steps: int, batch_size: int = 256, lr: float = 3e-3, seed: int = 0,
    device: DeviceLike = None, log: Callable[[str], None] = print,
) -> Tuple[ll.LipLocalizerNet, List[dict], np.ndarray]:
    """Train from ``init_params(RandomState(1))`` on ``device`` (cuda:0
    unless the caller asks for another) in fp32 (TF32 off). Batches are
    ``RandomState(seed + 7).randint`` draws, as in the JAX script. Every
    ``LOG_EVERY`` steps and at the last, the validation IoU is logged.

    Returns the trained net, the logged rows (``step``, ``loss``,
    ``val_iou_mean``, ``val_iou_p10``) and the last validation IoUs."""
    dev = get_device(device)
    disable_tf32()
    net = ll.LipLocalizerNet.from_params(
        ll.init_params(np.random.RandomState(1))).to(dev)
    opt = make_optimizer(net, lr)
    px_d, ty_d = torch.from_numpy(px).to(dev), torch.from_numpy(ty).to(dev)
    vx_d = torch.from_numpy(vx).to(dev)
    rng = np.random.RandomState(seed + 7)
    history, iou = [], np.zeros(len(vy), np.float32)
    for it in range(steps):
        idx = torch.from_numpy(
            rng.randint(0, len(px), size=batch_size)).to(dev)
        loss = train_step(net, opt, px_d[idx], ty_d[idx])
        if it % LOG_EVERY == 0 or it == steps - 1:
            with torch.no_grad():
                pv = net(vx_d).cpu().numpy()
            iou = val_iou(pv, vy)
            row = {"step": it, "loss": float(loss),
                   "val_iou_mean": float(iou.mean()),
                   "val_iou_p10": float(np.percentile(iou, 10))}
            history.append(row)
            log(f"step {it}: loss {row['loss']:.5f}  val raw-lip IoU "
                f"mean {row['val_iou_mean']:.3f} p10 "
                f"{row['val_iou_p10']:.3f}")
    return net, history, iou


def save(net: ll.LipLocalizerNet, out: Path, meta: dict) -> Path:
    """``np.savez`` of the flat parameter set into ``out`` and ``meta`` as
    JSON beside it (``out`` with suffix ``.json``)."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **net.to_params())
    out.with_suffix(".json").write_text(json.dumps(meta, indent=1))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=ll.DEFAULT_WEIGHTS)
    p.add_argument("--n-train", type=int, default=40000)
    p.add_argument("--n-val", type=int, default=3000)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; 'cpu' to run on "
                        "the CPU)")
    args = p.parse_args(argv)
    device = get_device(args.device)

    t0 = time.time()
    print(f"rendering {args.n_train}+{args.n_val} faces ...", flush=True)
    px, ty = build_dataset(args.n_train, args.seed)
    vx, vy = build_dataset(args.n_val, args.seed + 10_000)
    print(f"  done in {time.time() - t0:.0f}s", flush=True)

    net, _, iou = train(px, ty, vx, vy, steps=args.steps,
                        batch_size=args.batch_size, lr=args.lr,
                        seed=args.seed, device=device,
                        log=lambda line: print(line, flush=True))
    meta = {
        "steps": args.steps, "n_train": args.n_train, "lr": args.lr,
        "seed": args.seed, "val_raw_lip_iou_mean": round(float(iou.mean()), 4),
        "val_raw_lip_iou_p10": round(float(np.percentile(iou, 10)), 4),
        "trained_sec": round(time.time() - t0, 1),
    }
    save(net, args.out, meta)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
