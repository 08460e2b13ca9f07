"""Plain reference of AV-HuBERT LARGE as a detector: forward, BatchNorm
calibration and the parameter table, in fp32 PyTorch with no kernel, cache
or batching.

It follows the published model (Shi et al., ICLR 2022, arXiv:2201.02184;
facebookresearch/av_hubert, ``avhubert/hubert.py``, ``avhubert/resnet.py``
and the LARGE configurations) in eval mode:

* pixels: ``(B, T, H, W)`` grey in [0, 1], the centre square cut by
  ``crop_margin`` a side (96 -> 88), ``(x - 0.421) / 0.165``;
* video: Conv3d 1->64 k(5,7,7) s(1,2,2) p(2,3,3) no bias, BatchNorm, PReLU,
  max-pool (1,3,3)/(1,2,2)/(0,1,1); each frame through ResNet-18
  (BasicBlocks [2, 2, 2, 2] at 64/128/256/512, strides 1/2/2/2, PReLU, 1x1
  conv + BatchNorm shortcuts where the shape changes), average-pooled,
  linear 512 -> D;
* audio: ``(B, F, 4T)`` log-mel, every 4 consecutive frames stacked frame
  after frame to ``(B, T, 4F)``, layer norm over the ``4F`` features with
  no affine, linear 4F -> D;
* fusion: ``cat([audio, video])`` over channels (``AVHubertModel``'s
  order), LayerNorm(2D), linear 2D -> D;
* encoder: ``x + GELU(conv(x))``, the positional Conv1d D -> D of kernel
  ``conv_pos`` (padding half of it, ``conv_pos_groups`` groups) whose
  weight is ``g * v / ||v||`` with the norm per tap (``weight_norm`` with
  ``dim=2``), its last output step dropped (``SamePad``); then pre-LN
  layers ``x + MHA(LN(x))``, ``x + fc2(GELU(fc1(LN(x))))`` (q scaled by
  ``head_dim ** -0.5``, biases everywhere); then LayerNorm;
* head (assumed, no published head): mean over T, linear D -> 1.

Parameters are a flat dict under the published module tree's names
(:func:`param_shapes`).

Precision follows ``model.py``'s convention (``Part``, ``Run``,
``lower``): the parts are ``visual_low`` (the 3D stem and trunk layers
1-2), ``visual_high`` (layers 3-4, the pooling and the video projection),
``audio`` (the audio projection) and ``tokens`` (fusion, encoder, head).
In a bf16 part every convolution and linear map rounds its operands and
bias to bf16 and sums in fp32, every stored activation (a product, a
BatchNorm, a PReLU, a residual sum, a LayerNorm, a GELU, a pooled mean) is
rounded to bf16, a PReLU's slope is rounded to bf16 as its weight is
stored, and attention rounds its softmax weights to
bf16 before they meet the values (as a fused attention kernel does);
BatchNorm, LayerNorm and softmax compute in fp32. The weight norm is
computed in fp32 from ``g`` and ``v``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import model as flagship
from benchmark.reference.model import (
    Part,
    Run,
    batch_norm,
    fp32_precision,
    round_bf16,
)

MEAN, STD = 0.421, 0.165
STACK = 4
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
STEM_T = 5

Params = Mapping[str, torch.Tensor]


def geometry(cfg: Mapping) -> Dict[str, int]:
    """Sizes from a configuration's ``model`` block."""
    return {
        "frames": int(cfg.get("video_frames", 32)),
        "crop": int(cfg.get("crop_size", 96)),
        "margin": int(cfg.get("crop_margin", 4)),
        "mels": int(cfg.get("mel_bins", 26)),
        "audio_frames": int(cfg.get("audio_frames", 128)),
        "layers": int(cfg.get("encoder_layers", 24)),
        "D": int(cfg.get("embed_dim", 1024)),
        "ffn": int(cfg.get("ffn_dim", 4096)),
        "heads": int(cfg.get("heads", 16)),
        "conv_pos": int(cfg.get("conv_pos", 128)),
        "groups": int(cfg.get("conv_pos_groups", 16)),
    }


def _blocks():
    """``(stage, prefix, c_in, c_out, stride)`` of each trunk BasicBlock
    (stages 1-4)."""
    out, cin = [], WIDTHS[0]
    for i, (cout, stride) in enumerate(zip(WIDTHS, STRIDES), 1):
        out.append((i, f"layer{i}.0", cin, cout, stride))
        out.append((i, f"layer{i}.1", cout, cout, 1))
        cin = cout
    return out


def param_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer by the published name, with its shape
    (``()`` for a BatchNorm's ``num_batches_tracked``)."""
    g = geometry(cfg)
    d = g["D"]
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, n):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = (n,)
        out[f"{prefix}.num_batches_tracked"] = ()

    def lin(prefix, cin, cout):
        out[f"{prefix}.weight"] = (cout, cin)
        out[f"{prefix}.bias"] = (cout,)

    def ln(prefix, n):
        out[f"{prefix}.weight"] = (n,)
        out[f"{prefix}.bias"] = (n,)

    r = "feature_extractor_video.resnet"
    out[f"{r}.frontend3D.0.weight"] = (WIDTHS[0], 1, STEM_T, 7, 7)
    bn(f"{r}.frontend3D.1", WIDTHS[0])
    out[f"{r}.frontend3D.2.weight"] = (WIDTHS[0],)
    for _, prefix, cin, cout, stride in _blocks():
        p = f"{r}.trunk.{prefix}"
        out[f"{p}.conv1.weight"] = (cout, cin, 3, 3)
        bn(f"{p}.bn1", cout)
        out[f"{p}.relu1.weight"] = (cout,)
        out[f"{p}.conv2.weight"] = (cout, cout, 3, 3)
        bn(f"{p}.bn2", cout)
        out[f"{p}.relu2.weight"] = (cout,)
        if stride != 1 or cin != cout:
            out[f"{p}.downsample.0.weight"] = (cout, cin, 1, 1)
            bn(f"{p}.downsample.1", cout)
    lin("feature_extractor_video.proj", WIDTHS[-1], d)
    lin("feature_extractor_audio.proj", STACK * g["mels"], d)
    ln("layer_norm", 2 * d)
    lin("post_extract_proj", 2 * d, d)
    out["encoder.pos_conv.0.weight_g"] = (1, 1, g["conv_pos"])
    out["encoder.pos_conv.0.weight_v"] = (d, d // g["groups"], g["conv_pos"])
    out["encoder.pos_conv.0.bias"] = (d,)
    for i in range(g["layers"]):
        p = f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{p}.self_attn.{n}", d, d)
        ln(f"{p}.self_attn_layer_norm", d)
        lin(f"{p}.fc1", d, g["ffn"])
        lin(f"{p}.fc2", g["ffn"], d)
        ln(f"{p}.final_layer_norm", d)
    ln("encoder.layer_norm", d)
    lin("head", d, 1)
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, one draw per tensor in table
    order: fan-in-scaled normal convolution and linear weights (``v`` of
    the weight norm too), small biases, PReLU slopes near 0.25, norm scales
    near 1 with small shifts, ``g`` of the weight norm in [1, 2].
    BatchNorm statistics start at mean 0, variance 1; :func:`calibrate`
    sets them from a batch."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out: Dict[str, torch.Tensor] = {}
    for key, shape in param_shapes(cfg).items():
        leaf = key.rpartition(".")[2]
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        if leaf in ("running_mean", "running_var"):
            out[key] = (torch.zeros if leaf == "running_mean"
                        else torch.ones)(shape, device=device)
            continue
        if leaf == "weight_g":
            out[key] = 1.0 + torch.rand(shape, generator=gen, device=device)
            continue
        z = torch.randn(shape, generator=gen, device=device)
        if len(shape) >= 2:
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif ".relu" in key or key.endswith("frontend3D.2.weight"):
            v = 0.25 + 0.05 * z
        elif leaf == "weight":  # BatchNorm and LayerNorm scales
            v = 1.0 + 0.1 * z
        else:  # biases and norm shifts
            v = 0.05 * z
        out[key] = v.contiguous()
    return out


# ---------------------------------------------------------------- layers
def linear(part: Part, params: Params, prefix: str, x):
    """``model.linear`` over the last axis of ``x`` of any rank: the rows
    are flattened first, so that an int8 weight scale lies on the output
    channels."""
    y = flagship.linear(part, params, prefix, x.reshape(-1, x.shape[-1]))
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _prelu(part: Part, params: Params, prefix: str, x):
    w = params[f"{prefix}.weight"]
    if part.math == "bf16":
        w = round_bf16(w)
    return part.out(F.prelu(x, w))


def _conv(part: Part, params: Params, prefix: str, x, fn, **kw):
    return part.product(lambda a, k, c: fn(a, k, c, **kw), x,
                        params[f"{prefix}.weight"], None)


def _layer_norm(part: Part, params: Params, prefix: str, x):
    n = x.shape[-1]
    return part.out(F.layer_norm(x, (n,), params[f"{prefix}.weight"],
                                 params[f"{prefix}.bias"], 1e-5))


def _gelu(part: Part, x):
    return part.out(F.gelu(x))


def _block(run, part, params, prefix, x, cin, cout, stride):
    out = _conv(part, params, f"{prefix}.conv1", x, F.conv2d, stride=stride,
                padding=1)
    out = _prelu(part, params, f"{prefix}.relu1",
                 batch_norm(run, part, params, f"{prefix}.bn1", out))
    out = _conv(part, params, f"{prefix}.conv2", out, F.conv2d, padding=1)
    out = batch_norm(run, part, params, f"{prefix}.bn2", out)
    if stride != 1 or cin != cout:
        short = _conv(part, params, f"{prefix}.downsample.0", x, F.conv2d,
                      stride=stride)
        short = batch_norm(run, part, params, f"{prefix}.downsample.1",
                           short)
    else:
        short = x
    return _prelu(part, params, f"{prefix}.relu2", part.out(out + short))


def video(run: Run, params: Params, cfg: Mapping, visual: torch.Tensor):
    """``(B, T, H, W)`` in [0, 1] -> ``(B, T, D)`` video features."""
    g = geometry(cfg)
    low, high = run.parts["visual_low"], run.parts["visual_high"]
    m = g["margin"]
    h, w = visual.shape[-2:]
    x = ((visual.float()[..., m:h - m, m:w - m] - MEAN) / STD).unsqueeze(1)
    r = "feature_extractor_video.resnet"
    x = _conv(low, params, f"{r}.frontend3D.0", x, F.conv3d,
              stride=(1, 2, 2), padding=(STEM_T // 2, 3, 3))
    x = batch_norm(run, low, params, f"{r}.frontend3D.1", x)
    x = _prelu(low, params, f"{r}.frontend3D.2", x)
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    b, c, t, hh, ww = x.shape
    x = x.transpose(1, 2).reshape(b * t, c, hh, ww)
    for stage, prefix, cin, cout, stride in _blocks():
        part = low if stage <= 2 else high
        x = _block(run, part, params, f"{r}.trunk.{prefix}", x, cin, cout,
                   stride)
    x = high.out(x.mean(dim=(2, 3))).view(b, t, -1)
    return linear(high, params, "feature_extractor_video.proj", x)


def audio(run: Run, params: Params, mel: torch.Tensor, frames: int):
    """``(B, F, 4T[, 1])`` dB -> ``(B, T, D)`` audio features."""
    if mel.dim() == 4:
        mel = mel[..., 0]
    b, f, _ = mel.shape
    x = mel.float().transpose(1, 2).reshape(b, frames, STACK * f)
    x = F.layer_norm(x, (STACK * f,))
    return linear(run.parts["audio"], params, "feature_extractor_audio.proj",
                  x)


def attention(part: Part, params: Params, prefix: str, x, heads: int):
    b, t, d = x.shape

    def proj(name):
        y = linear(part, params, f"{prefix}.{name}", x)
        return y.reshape(b, t, heads, d // heads).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    logits = part.matmul(q * (d // heads) ** -0.5, k.transpose(-2, -1))
    weights = torch.softmax(logits, dim=-1)
    if part.math == "bf16":
        weights = round_bf16(weights)
    out = part.out(part.matmul(weights, v)).transpose(1, 2)
    return linear(part, params, f"{prefix}.out_proj", out.reshape(b, t, d))


def encoder(run: Run, params: Params, cfg: Mapping, x: torch.Tensor):
    g = geometry(cfg)
    part = run.parts["tokens"]
    p = "encoder.pos_conv.0"
    gw, vw = params[f"{p}.weight_g"], params[f"{p}.weight_v"]
    weight = gw * vw / vw.norm(dim=(0, 1), keepdim=True)
    y = part.product(
        lambda a, k, c: F.conv1d(a, k, c, padding=g["conv_pos"] // 2,
                                 groups=g["groups"]),
        x.transpose(1, 2), weight, params[f"{p}.bias"])
    if g["conv_pos"] % 2 == 0:
        y = y[..., :-1]
    x = part.out(x + _gelu(part, y.transpose(1, 2)))
    for i in range(g["layers"]):
        q = f"encoder.layers.{i}"
        h = _layer_norm(part, params, f"{q}.self_attn_layer_norm", x)
        x = part.out(x + attention(part, params, f"{q}.self_attn", h,
                                   g["heads"]))
        h = _layer_norm(part, params, f"{q}.final_layer_norm", x)
        h = _gelu(part, linear(part, params, f"{q}.fc1", h))
        x = part.out(x + linear(part, params, f"{q}.fc2", h))
    return _layer_norm(part, params, "encoder.layer_norm", x)


def forward(params: Params, cfg: Mapping, visual: torch.Tensor,
            mel: torch.Tensor, run: Run) -> torch.Tensor:
    """Logits ``(B,)`` for ``visual`` ``(B, T, H, W)`` in [0, 1] and
    ``mel`` ``(B, F, 4T[, 1])`` dB."""
    part = run.parts["tokens"]
    v = video(run, params, cfg, visual)
    a = audio(run, params, mel, v.shape[1])
    x = _layer_norm(part, params, "layer_norm", torch.cat([a, v], dim=-1))
    x = linear(part, params, "post_extract_proj", x)
    x = encoder(run, params, cfg, x)
    return linear(part, params, "head", part.out(x.mean(dim=1))).squeeze(-1)


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], cfg: Mapping,
              visual: torch.Tensor, mel: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics, in place, to the biased
    statistics that a batch produces, layer after layer in fp32."""
    stats: Dict[str, torch.Tensor] = {}
    video(Run(fp32_precision(), calibrate=stats), params, cfg, visual)
    for k, v in stats.items():
        params[k].copy_(v)


def logits_in_blocks(params: Params, cfg: Mapping, visual_u8: torch.Tensor,
                     mel: torch.Tensor, precision, block: int
                     ) -> torch.Tensor:
    """Eval-mode logits of uint8 grey windows in blocks of ``block``
    rows (each block one batch, so a per-tensor int8 scale is the
    block's)."""
    outs: List[torch.Tensor] = []
    run = Run(precision)
    with torch.no_grad():
        for lo in range(0, visual_u8.shape[0], block):
            v = visual_u8[lo:lo + block].float() / 255.0
            outs.append(forward(params, cfg, v, mel[lo:lo + block], run))
    return torch.cat(outs)
