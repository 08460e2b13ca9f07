"""Plain reference of Auto-AVSR's audio-visual conformer as a detector:
forward, BatchNorm calibration and the parameter table, in fp32 PyTorch
with no kernel, cache or batching.

It follows the published model (Ma et al., ICASSP 2023, arXiv:2303.14307;
mpc001/auto_avsr, ``espnet/nets/pytorch_backend/e2e_asr_conformer_av.py``
and the conformer ``Encoder``, ``Conv3dResNet``, ``Conv1dResNet``,
``RelPositionMultiHeadedAttention``, ``ConvolutionModule`` and ``MLPHead``
it builds) in eval mode, without the decoder and the CTC layer:

* pixels: ``(B, T, H, W)`` grey in [0, 1], the centre square cut by
  ``crop_margin`` a side (96 -> 88), ``(x - 0.421) / 0.165``;
* video: Conv3d 1->64 k(5,7,7) s(1,2,2) p(2,3,3) no bias, BatchNorm,
  Swish, max-pool (1,3,3)/(1,2,2)/(0,1,1); each frame through ResNet-18
  (BasicBlocks [2, 2, 2, 2] at 64/128/256/512, strides 1/2/2/2, Swish, 1x1
  conv + BatchNorm shortcuts where the shape changes), average-pooled,
  linear 512 -> adim (``encoder.embed.0``);
* audio: ``(B, 1, S)`` PCM at 16 kHz normalised over each window's samples
  (mean 0, variance 1, eps 1e-8: auto_avsr's ``layer_norm(x, x.shape)``),
  the first ``640 T`` samples; Conv1d 1->64 k80 s4 p38 no bias,
  BatchNorm, Swish, BasicBlock1Ds [2, 2, 2, 2] (k3) at 64-512, strides
  1/2/2/2, ``AvgPool1d(21, 20, 1)`` (zeros counted), linear 512 -> adim
  (``aux_encoder.embed.0``);
* each encoder: ``x * sqrt(adim)`` and the relative positional table
  (``2T - 1`` rows, row r the position ``T - 1 - r``, sines on even and
  cosines on odd features, ESPnet's ``RelPositionalEncoding``); ``elayers``
  conformer blocks (pre-LN with ESPnet's eps 1e-12):
  ``x + FFN_mac(LN x) / 2``, ``x + MHA(LN x)``, ``x + Conv(LN x)``,
  ``x + FFN(LN x) / 2``, ``LN`` (``norm_final``); then ``after_norm``.
  FFN: ``w_2(ReLU(w_1 x))``. MHA: ``softmax(((q + u) k^T + S) / sqrt(d_k))
  v`` then ``linear_out``, where ``S[i, j] = (q_i + v) . p_r`` with ``p =
  linear_pos(table)`` (no bias) and r the table row of relative position
  ``i - j`` (:func:`rel_term`: gathered by index here, where the source
  pads and reshapes). Conv: pointwise Conv1d to ``2 adim``, GLU, depthwise
  Conv1d (kernel ``cnn_module_kernel``, padding half of it, bias),
  BatchNorm1d, Swish, pointwise Conv1d;
* fusion: ``cat([video, audio])`` (the source's order), Linear(2 adim ->
  fusion_hdim), BatchNorm1d, ReLU, Linear(fusion_hdim -> adim);
* head (assumed, no published head): mean over T, linear adim -> 1.

Departures from the source, each also listed in the configuration's
``assumed``: the head; the PCM normalised per window rather than per
utterance (a window is what the detector scores); no dropout (eval);
the relative shift by an explicit index where the source pads and views.

Parameters are a flat dict under the published module tree's names
(:func:`param_shapes`).

Precision follows ``model.py``'s convention (``Part``, ``Run``,
``lower``) over four parts: ``visual_low`` (the 3D stem and trunk layers
1-2), ``visual_high`` (layers 3-4, the pooling and the video projection),
``audio`` (the PCM ResNet-1D and its projection) and ``tokens`` (both
conformer encoders, the fusion and the head). In a bf16 part every
convolution and linear map rounds its operands and bias to bf16 and sums
in fp32; every stored activation (a product, a BatchNorm, a Swish, a GLU,
a residual sum, a LayerNorm, a pooled mean, ``x * sqrt(adim)``, the table,
``q + u``, ``q + v``, each attention product and their scaled sum) is
rounded to bf16; the softmax is computed in fp32 from the rounded scores
and rounded once; the PCM normalisation is fp32.
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
WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
STEM_T = 5
SAMPLES_PER_FRAME = 640
PCM_EPS = 1e-8
LN_EPS = 1e-12
PARTS = ("visual_low", "visual_high", "audio", "tokens")

Params = Mapping[str, torch.Tensor]


def geometry(cfg: Mapping) -> Dict[str, int]:
    """Sizes from a configuration's ``model`` block."""
    frames = int(cfg.get("video_frames", 96))
    return {
        "frames": frames,
        "crop": int(cfg.get("crop_size", 96)),
        "margin": int(cfg.get("crop_margin", 4)),
        "samples": frames * SAMPLES_PER_FRAME,
        "D": int(cfg.get("adim", 768)),
        "heads": int(cfg.get("aheads", 12)),
        "ffn": int(cfg.get("eunits", 3072)),
        "layers": int(cfg.get("elayers", 12)),
        "kernel": int(cfg.get("cnn_module_kernel", 31)),
        "hidden": int(cfg.get("fusion_hdim", 8192)),
    }


def _blocks():
    """``(stage, prefix, c_in, c_out, stride)`` of each ResNet BasicBlock
    (stages 1-4), 2-d and 1-d alike."""
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

    def lin(prefix, cin, cout, bias=True):
        out[f"{prefix}.weight"] = (cout, cin)
        if bias:
            out[f"{prefix}.bias"] = (cout,)

    def ln(prefix, n):
        out[f"{prefix}.weight"] = (n,)
        out[f"{prefix}.bias"] = (n,)

    def resnet(prefix, k):
        for _, name, cin, cout, stride in _blocks():
            p = f"{prefix}.{name}"
            out[f"{p}.conv1.weight"] = (cout, cin) + k
            bn(f"{p}.bn1", cout)
            out[f"{p}.conv2.weight"] = (cout, cout) + k
            bn(f"{p}.bn2", cout)
            if stride != 1 or cin != cout:
                out[f"{p}.downsample.0.weight"] = (cout, cin) + (1,) * len(k)
                bn(f"{p}.downsample.1", cout)

    def conformer(prefix):
        h, dk = g["heads"], d // g["heads"]
        for i in range(g["layers"]):
            p = f"{prefix}.encoders.{i}"
            out[f"{p}.self_attn.pos_bias_u"] = (h, dk)
            out[f"{p}.self_attn.pos_bias_v"] = (h, dk)
            for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
                lin(f"{p}.self_attn.{n}", d, d)
            lin(f"{p}.self_attn.linear_pos", d, d, bias=False)
            for ff in ("feed_forward", "feed_forward_macaron"):
                lin(f"{p}.{ff}.w_1", d, g["ffn"])
                lin(f"{p}.{ff}.w_2", g["ffn"], d)
            c = f"{p}.conv_module"
            out[f"{c}.pointwise_cov1.weight"] = (2 * d, d, 1)
            out[f"{c}.pointwise_cov1.bias"] = (2 * d,)
            out[f"{c}.depthwise_conv.weight"] = (d, 1, g["kernel"])
            out[f"{c}.depthwise_conv.bias"] = (d,)
            bn(f"{c}.norm", d)
            out[f"{c}.pointwise_cov2.weight"] = (d, d, 1)
            out[f"{c}.pointwise_cov2.bias"] = (d,)
            for n in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv",
                      "norm_final"):
                ln(f"{p}.{n}", d)
        ln(f"{prefix}.after_norm", d)

    v = "encoder.frontend"
    out[f"{v}.frontend3D.0.weight"] = (WIDTHS[0], 1, STEM_T, 7, 7)
    bn(f"{v}.frontend3D.1", WIDTHS[0])
    resnet(f"{v}.trunk", (3, 3))
    lin("encoder.embed.0", WIDTHS[-1], d)
    conformer("encoder")
    a = "aux_encoder.frontend.trunk"
    out[f"{a}.conv1.weight"] = (WIDTHS[0], 1, 80)
    bn(f"{a}.bn1", WIDTHS[0])
    resnet(a, (3,))
    lin("aux_encoder.embed.0", WIDTHS[-1], d)
    conformer("aux_encoder")
    lin("fusion.fc1", 2 * d, g["hidden"])
    bn("fusion.bn1", g["hidden"])
    lin("fusion.fc2", g["hidden"], d)
    lin("head", d, 1)
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, one draw per tensor in table
    order: fan-in-scaled normal convolution and linear weights, small
    biases, norm scales near 1 with small shifts, the attention's
    positional biases ``0.1 z``. BatchNorm statistics start at mean 0,
    variance 1; :func:`calibrate` sets them from a batch."""
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
        z = torch.randn(shape, generator=gen, device=device)
        if leaf.startswith("pos_bias"):
            v = 0.1 * z
        elif len(shape) >= 2:
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
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


def _pointwise(part: Part, params: Params, prefix: str, x):
    """A k1 Conv1d over ``(B, T, C)`` as a linear map."""
    w, b = params[f"{prefix}.weight"][..., 0], params[f"{prefix}.bias"]
    y = part.product(F.linear, x.reshape(-1, x.shape[-1]), w, b)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _conv(part: Part, params: Params, prefix: str, x, fn, **kw):
    return part.product(lambda a, k, c: fn(a, k, c, **kw), x,
                        params[f"{prefix}.weight"], params.get(
                            f"{prefix}.bias"))


def swish(part: Part, x):
    return part.out(F.silu(x))


def _layer_norm(part: Part, params: Params, prefix: str, x):
    n = x.shape[-1]
    return part.out(F.layer_norm(x, (n,), params[f"{prefix}.weight"],
                                 params[f"{prefix}.bias"], LN_EPS))


def _block(run, part, params, prefix, x, cin, cout, stride, conv):
    out = _conv(part, params, f"{prefix}.conv1", x, conv, stride=stride,
                padding=1)
    out = swish(part, batch_norm(run, part, params, f"{prefix}.bn1", out))
    out = _conv(part, params, f"{prefix}.conv2", out, conv, padding=1)
    out = batch_norm(run, part, params, f"{prefix}.bn2", out)
    if stride != 1 or cin != cout:
        short = _conv(part, params, f"{prefix}.downsample.0", x, conv,
                      stride=stride)
        short = batch_norm(run, part, params, f"{prefix}.downsample.1",
                           short)
    else:
        short = x
    return swish(part, part.out(out + short))


def video(run: Run, params: Params, cfg: Mapping, visual: torch.Tensor):
    """``(B, T, H, W)`` in [0, 1] -> ``(B, T, adim)`` projected video
    features."""
    g = geometry(cfg)
    low, high = run.parts["visual_low"], run.parts["visual_high"]
    m = g["margin"]
    h, w = visual.shape[-2:]
    x = ((visual.float()[..., m:h - m, m:w - m] - MEAN) / STD).unsqueeze(1)
    r = "encoder.frontend"
    x = _conv(low, params, f"{r}.frontend3D.0", x, F.conv3d,
              stride=(1, 2, 2), padding=(STEM_T // 2, 3, 3))
    x = swish(low, batch_norm(run, low, params, f"{r}.frontend3D.1", x))
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    b, c, t, hh, ww = x.shape
    x = x.transpose(1, 2).reshape(b * t, c, hh, ww)
    for stage, prefix, cin, cout, stride in _blocks():
        part = low if stage <= 2 else high
        x = _block(run, part, params, f"{r}.trunk.{prefix}", x, cin, cout,
                   stride, F.conv2d)
    x = high.out(x.mean(dim=(2, 3))).view(b, t, -1)
    return linear(high, params, "encoder.embed.0", x)


def normalise_pcm(pcm: torch.Tensor, frames: int) -> torch.Tensor:
    """``(B, 1, S)`` -> ``(B, 1, 640 frames)`` fp32: each window's samples
    to mean 0 and variance 1 (biased, eps 1e-8), then the first ``640
    frames``."""
    x = pcm.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) / torch.sqrt(var + PCM_EPS)
    return x[..., :frames * SAMPLES_PER_FRAME]


def audio(run: Run, params: Params, pcm: torch.Tensor, frames: int):
    """``(B, 1, S)`` PCM -> ``(B, frames, adim)`` projected audio
    features."""
    part = run.parts["audio"]
    a = "aux_encoder.frontend.trunk"
    x = normalise_pcm(pcm, frames)
    x = _conv(part, params, f"{a}.conv1", x, F.conv1d, stride=4, padding=38)
    x = swish(part, batch_norm(run, part, params, f"{a}.bn1", x))
    for _, prefix, cin, cout, stride in _blocks():
        x = _block(run, part, params, f"{a}.{prefix}", x, cin, cout, stride,
                   F.conv1d)
    x = part.out(F.avg_pool1d(x, 21, 20, 1))
    return linear(part, params, "aux_encoder.embed.0", x.transpose(1, 2))


def rel_table(t: int, d: int) -> torch.Tensor:
    """``(2t - 1, d)``: row r the sinusoid of relative position ``t - 1 -
    r``, ``sin(p w_i)`` at feature ``2i``, ``cos(p w_i)`` at ``2i + 1``,
    ``w_i = 10000^(-2i/d)``."""
    pos = (t - 1 - torch.arange(2 * t - 1, dtype=torch.float32))[:, None]
    w = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                  * (-math.log(10000.0) / d))
    out = torch.zeros(2 * t - 1, d)
    out[:, 0::2] = torch.sin(pos * w)
    out[:, 1::2] = torch.cos(pos * w)
    return out


def rel_term(scores: torch.Tensor) -> torch.Tensor:
    """``(..., T, 2T - 1)`` products against the table's rows -> ``(...,
    T, T)``: entry ``(i, j)`` is the product against the row of relative
    position ``i - j``, row ``T - 1 - (i - j)``, gathered by index."""
    t = scores.shape[-2]
    i = torch.arange(t, device=scores.device)[:, None]
    j = torch.arange(t, device=scores.device)[None, :]
    rows = (t - 1 - (i - j)).expand(*scores.shape[:-1], t)
    return torch.gather(scores, -1, rows)


def attention(part: Part, params: Params, prefix: str, x, table,
              heads: int):
    b, t, d = x.shape
    dk = d // heads

    def proj(name):
        return linear(part, params, f"{prefix}.{name}", x).reshape(
            b, t, heads, dk)

    def bias(name):
        u = params[f"{prefix}.{name}"]
        return round_bf16(u) if part.math == "bf16" else u

    q, k, v = proj("linear_q"), proj("linear_k"), proj("linear_v")
    p = linear(part, params, f"{prefix}.linear_pos", table).reshape(
        2 * t - 1, heads, dk).transpose(0, 1)
    q_u = part.out(q + bias("pos_bias_u")).transpose(1, 2)
    q_v = part.out(q + bias("pos_bias_v")).transpose(1, 2)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    ac = part.out(part.matmul(q_u, k.transpose(-2, -1)))
    bd = rel_term(part.out(part.matmul(q_v, p.transpose(-2, -1))))
    scores = part.out(part.out(ac + bd) / math.sqrt(dk))
    weights = part.out(torch.softmax(scores, dim=-1))
    out = part.out(part.matmul(weights, v)).transpose(1, 2)
    return linear(part, params, f"{prefix}.linear_out", out.reshape(b, t, d))


def _ffn(part, params, prefix, x):
    h = part.out(F.relu(linear(part, params, f"{prefix}.w_1", x)))
    return linear(part, params, f"{prefix}.w_2", h)


def conv_module(run, part, params, prefix, x, kernel):
    y = part.out(F.glu(_pointwise(part, params, f"{prefix}.pointwise_cov1",
                                  x), dim=-1))
    y = _conv(part, params, f"{prefix}.depthwise_conv", y.transpose(1, 2),
              F.conv1d, padding=(kernel - 1) // 2, groups=y.shape[-1])
    y = swish(part, batch_norm(run, part, params, f"{prefix}.norm", y))
    return _pointwise(part, params, f"{prefix}.pointwise_cov2",
                      y.transpose(1, 2))


def encoder(run: Run, params: Params, cfg: Mapping, x: torch.Tensor,
            prefix: str):
    """``(B, T, adim)`` projected features -> one encoder's output: the
    positional encoding, the conformer blocks, ``after_norm``."""
    g = geometry(cfg)
    part = run.parts["tokens"]
    t, d = x.shape[1], x.shape[2]
    table = part.out(rel_table(t, d).to(x.device))
    x = part.out(x * math.sqrt(d))
    for i in range(g["layers"]):
        p = f"{prefix}.encoders.{i}"
        h = _layer_norm(part, params, f"{p}.norm_ff_macaron", x)
        x = part.out(x + 0.5 * _ffn(part, params, f"{p}.feed_forward_macaron",
                                    h))
        h = _layer_norm(part, params, f"{p}.norm_mha", x)
        x = part.out(x + attention(part, params, f"{p}.self_attn", h, table,
                                   g["heads"]))
        h = _layer_norm(part, params, f"{p}.norm_conv", x)
        x = part.out(x + conv_module(run, part, params, f"{p}.conv_module",
                                     h, g["kernel"]))
        h = _layer_norm(part, params, f"{p}.norm_ff", x)
        x = part.out(x + 0.5 * _ffn(part, params, f"{p}.feed_forward", h))
        x = _layer_norm(part, params, f"{p}.norm_final", x)
    return _layer_norm(part, params, f"{prefix}.after_norm", x)


def fusion(run: Run, params: Params, x: torch.Tensor):
    """``MLPHead`` over ``(B, T, 2 adim)``, then the detection head."""
    part = run.parts["tokens"]
    b, t, _ = x.shape
    y = linear(part, params, "fusion.fc1", x).reshape(b * t, -1)
    y = part.out(F.relu(batch_norm(run, part, params, "fusion.bn1", y)))
    y = linear(part, params, "fusion.fc2", y).reshape(b, t, -1)
    return linear(part, params, "head", part.out(y.mean(dim=1))).squeeze(-1)


def forward(params: Params, cfg: Mapping, visual: torch.Tensor,
            pcm: torch.Tensor, run: Run) -> torch.Tensor:
    """Logits ``(B,)`` for ``visual`` ``(B, T, H, W)`` in [0, 1] and
    ``pcm`` ``(B, 1, S)`` at 16 kHz."""
    v = encoder(run, params, cfg, video(run, params, cfg, visual), "encoder")
    a = audio(run, params, pcm, v.shape[1])
    a = encoder(run, params, cfg, a, "aux_encoder")
    return fusion(run, params, torch.cat([v, a], dim=-1))


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], cfg: Mapping,
              visual: torch.Tensor, pcm: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics, in place, to the biased
    statistics that a batch produces, layer after layer in fp32 (the
    front ends', the conformers' convolution modules' and the fusion's)."""
    stats: Dict[str, torch.Tensor] = {}
    forward(params, cfg, visual, pcm, Run(fp32_precision(), calibrate=stats))
    for k, v in stats.items():
        params[k].copy_(v)


def logits_in_blocks(params: Params, cfg: Mapping, visual_u8: torch.Tensor,
                     pcm: torch.Tensor, precision, block: int
                     ) -> torch.Tensor:
    """Eval-mode logits of uint8 grey windows and their PCM in blocks of
    ``block`` rows (each block one batch, so a per-tensor int8 scale is
    the block's)."""
    outs: List[torch.Tensor] = []
    run = Run(precision)
    with torch.no_grad():
        for lo in range(0, visual_u8.shape[0], block):
            v = visual_u8[lo:lo + block].float() / 255.0
            outs.append(forward(params, cfg, v, pcm[lo:lo + block], run))
    return torch.cat(outs)
