"""Plain reference of the lip-sync model: forward, BatchNorm calibration and
the parameter table, in fp32 PyTorch with no kernel, cache or batching.

It follows ``LipSyncModel`` of the published system
(PRADUMAN-KR/Multimodal-Lip-Sync-Deepfake-Detection-System,
``app/models/lip_sync_model.py``): a 3D-ResNet visual encoder over 96x96
mouth crops, a 2D-ResNet audio encoder over log-mel, linear projections to a
shared width, gated bidirectional cross-modal attention, a multi-scale
temporal transformer with a CLS token, and an artifact branch (temporal
detector on the feature map and on its frame difference, Laplacian
high-frequency stack on the raw clip), concatenated into an MLP head that
emits one logit for P(REAL). Parameters are a flat dict under the
reference checkpoint's names (:func:`param_shapes`).

Precision. Every tensor is held in fp32, and TF32 is never used (the caller
turns it off). A lower precision is emulated by rounding at the points where
a mixed-precision program rounds, so that the same code states what a
configuration computes and computes it on any device:

* ``math`` of a convolution or matrix product: ``fp32``; ``tf32`` (operands,
  and in training the incoming gradient, rounded to 10 mantissa bits, sums in
  fp32, as tensor cores in TF32 do); ``bf16`` (operands rounded to bf16, sums
  in fp32); ``int8`` / ``int4`` (symmetric quantization, the activation per
  tensor over the whole batch and the weight per output channel, integer sums,
  then ``acc * (x_scale * w_scale) + bias``).
* ``act``: the dtype the part's activations are stored in (``fp32`` or
  ``bf16``): each convolution, BatchNorm and residual sum of a ``bf16`` part
  rounds its output to bf16, as autocast does.

A configuration's precision is a dict from part to ``{"act", "math"}`` over
:data:`PARTS`. :func:`lower` gives the control's: each ``math`` one step
below (fp32 to TF32, bf16 to int8, int8 to int4).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

PARTS = ("visual_low", "visual_high", "audio", "artifact", "tokens")
STEP_DOWN = {"fp32": "tf32", "tf32": "bf16", "bf16": "int8", "int8": "int4",
             "int4": "int4"}
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
INV_7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))

Params = Mapping[str, torch.Tensor]


def fp32_precision() -> Dict[str, Dict[str, str]]:
    return {p: {"act": "fp32", "math": "fp32"} for p in PARTS}


def lower(precision: Mapping[str, Mapping[str, str]]
          ) -> Dict[str, Dict[str, str]]:
    """The control's precision: each part's ``math`` one step down."""
    return {p: {"act": v["act"], "math": STEP_DOWN[v["math"]]}
            for p, v in precision.items()}


# ---------------------------------------------------------------- rounding
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to 10 mantissa bits, nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view_as(x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _RoundBoth(torch.autograd.Function):
    """Rounds the value, and the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _rounder(math_mode: str) -> Optional[Callable]:
    return {"tf32": round_tf32, "bf16": round_bf16}.get(math_mode)


class Part:
    """The arithmetic of one part of the model."""

    def __init__(self, act: str = "fp32", math_mode: str = "fp32"):
        self.act, self.math = act, math_mode

    def out(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: rounded to bf16 in a bf16 part."""
        return round_bf16(x) if self.act == "bf16" else x

    def product(self, fn, x, w, b):
        """``fn(x, w, b)`` (a convolution or linear map) in this part's
        arithmetic, its output stored in the part's dtype."""
        rnd = _rounder(self.math)
        if self.math in ("int8", "int4"):
            return self.out(_quantized(fn, x, w, b, self.math))
        if rnd is not None:
            x, w = _RoundBoth.apply(x, rnd), _RoundBoth.apply(w, rnd)
            if b is not None and self.math == "bf16":
                b = _RoundBoth.apply(b, rnd)
            y = fn(x, w, b)
            y = _RoundGrad.apply(y, rnd)
        else:
            y = fn(x, w, b)
        return self.out(y)

    def matmul(self, a, b):
        rnd = _rounder(self.math)
        if rnd is not None and self.math == "tf32":
            a, b = _RoundBoth.apply(a, rnd), _RoundBoth.apply(b, rnd)
            return _RoundGrad.apply(a @ b, rnd)
        return a @ b


def _quantized(fn, x, w, b, mode):
    """Symmetric quantization: ``x`` per tensor, ``w`` per output channel,
    ``round(v / scale)`` clipped, integer sums (exact in fp32 at these
    sizes but for the largest, where the error is below the quantization
    step by orders), then ``acc * (x_scale * w_scale) + b``. Inference
    only."""
    inv, top = (INV_127, 127.0) if mode == "int8" else (INV_7, 7.0)
    x_scale = torch.clamp(x.abs().amax() * inv, min=1e-12)
    w_scale = torch.clamp(
        w.abs().amax(dim=tuple(range(1, w.dim()))) * inv, min=1e-12)
    shape = (-1,) + (1,) * (w.dim() - 1)
    xq = torch.clamp(torch.round(x / x_scale), -top, top)
    wq = torch.clamp(torch.round(w / w_scale.view(shape)), -top, top)
    acc = fn(xq, wq, None)
    scale = (x_scale * w_scale).view((1, -1) + (1,) * (acc.dim() - 2))
    y = acc * scale
    if b is not None:
        y = y + b.view((1, -1) + (1,) * (acc.dim() - 2))
    return y


# ---------------------------------------------------------------- config
def geometry(cfg: Mapping) -> Dict[str, int]:
    """Widths of the model from a configuration's ``model`` block."""
    d = int(cfg.get("visual_feature_dim", 256))
    e = int(cfg.get("embed_dim", 256))
    return {
        "D": d, "A": int(cfg.get("audio_feature_dim", 256)), "E": e,
        "C": 64, "heads": int(cfg.get("cross_modal_heads", 8)),
        "t_heads": int(cfg.get("temporal_heads", 8)),
        "layers": int(cfg.get("temporal_layers", 4)),
        "hf": 64,
        "frames": int(cfg.get("video_frames", 32)),
        "crop": int(cfg.get("crop_size", 96)),
        "mels": int(cfg.get("mel_bins", 80)),
        "audio_frames": int(cfg.get("audio_frames", 128)),
        "layer3_t": 1 if cfg.get("preserve_audio_temporal", True) else 2,
    }


def _check_supported(cfg: Mapping) -> None:
    for key in ("detect_artifacts", "temporal_pre_conv", "use_delta_artifact",
                "use_high_freq_artifact"):
        if not cfg.get(key, True):
            raise ValueError(f"the reference follows {key}=true only")
    if cfg.get("hf_stem_fold", False):
        raise ValueError("the reference follows hf_stem_fold=false only")


def param_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the model, by the reference
    checkpoint's name, with its shape (``()`` for a BatchNorm's
    ``num_batches_tracked``)."""
    _check_supported(cfg)
    g = geometry(cfg)
    c, d, a, e = g["C"], g["D"], g["A"], g["E"]
    out: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, n):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{leaf}"] = (n,)
        out[f"{prefix}.num_batches_tracked"] = ()

    def conv_bn(prefix, cin, cout, k):
        out[f"{prefix}.0.weight"] = (cout, cin) + tuple(k)
        bn(f"{prefix}.1", cout)

    def encoder(prefix, cin, feat, nd, stem_k):
        k3 = (3,) * nd
        conv_bn(f"{prefix}.stem", cin, c, stem_k)
        widths = [(c, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, feat)]
        for i, (ci, co) in enumerate(widths, 1):
            conv_bn(f"{prefix}.layer{i}.conv1", ci, co, k3)
            conv_bn(f"{prefix}.layer{i}.conv2", co, co, k3)
            if i > 1 or ci != co:
                conv_bn(f"{prefix}.layer{i}.downsample", ci, co, (1,) * nd)

    def linear(prefix, cin, cout, bias=True):
        out[f"{prefix}.weight"] = (cout, cin)
        if bias:
            out[f"{prefix}.bias"] = (cout,)

    def attention(prefix, dim):
        out[f"{prefix}.in_proj_weight"] = (3 * dim, dim)
        out[f"{prefix}.in_proj_bias"] = (3 * dim,)
        linear(f"{prefix}.out_proj", dim, dim)

    encoder("visual_encoder", 3, d, 3, (3, 7, 7))
    encoder("audio_encoder", 1, a, 2, (7, 7))
    linear("projection.visual_proj", d, e)
    linear("projection.audio_proj", a, e)
    attention("cross_modal.v2a_attn", e)
    attention("cross_modal.a2v_attn", e)
    linear("cross_modal.gate.0", 2 * e, e)
    linear("cross_modal.gate.2", e, 1)
    linear("cross_modal.fuse.0", e, e)
    for k in (3, 5, 7):
        out[f"temporal.branch_k{k}.0.weight"] = (e, e, k)
        bn(f"temporal.branch_k{k}.1", e)
    linear("temporal.pre_scale_proj", 3 * e, e)
    out["temporal.cls_token"] = (1, 1, e)
    for i in range(g["layers"]):
        p = f"temporal.transformer.layers.{i}"
        attention(f"{p}.self_attn", e)
        linear(f"{p}.linear1", e, 4 * e)
        linear(f"{p}.linear2", 4 * e, e)
        for n in ("norm1", "norm2"):
            out[f"{p}.{n}.weight"] = (e,)
            out[f"{p}.{n}.bias"] = (e,)
    art = "artifact_detector"
    tc = f"{art}.temporal_detector.temporal_conv"
    for j, (ci, co) in zip((0, 3), ((d, d // 2), (d // 2, d // 4))):
        out[f"{tc}.{j}.weight"] = (co, ci, 3, 3, 3)
        out[f"{tc}.{j}.bias"] = (co,)
        bn(f"{tc}.{j + 1}", co)
    hf = f"{art}.high_freq_detector"
    out[f"{hf}.laplacian.weight"] = (3, 3, 3, 3)
    for j, (ci, co) in zip((0, 3), ((3, 32), (32, g["hf"]))):
        out[f"{hf}.conv3d.{j}.weight"] = (co, ci, 3, 3, 3)
        out[f"{hf}.conv3d.{j}.bias"] = (co,)
        bn(f"{hf}.conv3d.{j + 1}", co)
    linear(f"{art}.artifact_fusion.0", e + 2 * (d // 4) + g["hf"], e)
    linear(f"{art}.artifact_fusion.2", e, e // 2)
    linear("classifier.net.0", e + e // 2, 128)
    out["classifier.net.3.weight"] = (128,)
    out["classifier.net.3.bias"] = (128,)
    linear("classifier.net.4", 128, 1)
    return out


def laplacian_kernel() -> torch.Tensor:
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    w = torch.zeros(3, 3, 3, 3)
    for i in range(3):
        w[i, i] = k
    return w


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device``, in two draws: fan-in-scaled
    normal convolution and linear weights, small biases, BatchNorm and
    LayerNorm scales near 1 with small shifts, the Laplacian's init plus
    noise. BatchNorm statistics start at mean 0, variance 1; call
    :func:`calibrate` to set them from a batch."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sizes = {k: math.prod(s) for k, s in shapes.items()
             if not k.endswith("num_batches_tracked")}
    normal = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        z = normal[at:at + sizes[key]].view(shape)
        at += sizes[key]
        leaf = key.rpartition(".")[2]
        if leaf == "running_mean":
            v = torch.zeros_like(z)
        elif leaf == "running_var":
            v = torch.ones_like(z)
        elif key.endswith("laplacian.weight"):
            v = laplacian_kernel().to(device) + 0.05 * z
        elif key.endswith("cls_token"):
            v = 0.02 * z
        elif len(shape) >= 2:  # convolution and linear weights
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif _is_norm_scale(key, shapes):
            v = 1.0 + 0.1 * z
        else:  # biases and norm shifts
            v = 0.05 * z
        out[key] = v.contiguous()
    return out


def _is_norm_scale(key: str, shapes) -> bool:
    prefix = key[: -len(".weight")] if key.endswith(".weight") else None
    if prefix is None:
        return False
    return (f"{prefix}.running_mean" in shapes or ".norm" in prefix
            or prefix.endswith("net.3"))


# ---------------------------------------------------------------- layers
class Run:
    """One forward's mode: ``training`` (BatchNorm on batch statistics, and
    dropout), ``calibrate`` (batch statistics written into the running
    ones), and the precision by part."""

    def __init__(self, precision, training=False, dropout=0.0,
                 calibrate=None):
        self.parts = {p: Part(v["act"], v["math"])
                      for p, v in precision.items()}
        self.training, self.p = training, dropout
        self.calibrate = calibrate  # dict to fill, or None

    def dropout(self, x, feature=False):
        if not self.training or self.p == 0.0:
            return x
        return (F.dropout3d if feature else F.dropout)(x, self.p, True)


def _conv(nd):
    return {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]


def batch_norm(run: Run, part: Part, params: Params, prefix: str, x):
    w, b = params[f"{prefix}.weight"], params[f"{prefix}.bias"]
    if run.training or run.calibrate is not None:
        if run.calibrate is not None:
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x.detach(), dims, correction=0)
            run.calibrate[f"{prefix}.running_mean"] = mean
            run.calibrate[f"{prefix}.running_var"] = var
        y = F.batch_norm(x, None, None, w, b, True, 0.0, 1e-5)
    else:
        y = F.batch_norm(x, params[f"{prefix}.running_mean"],
                         params[f"{prefix}.running_var"], w, b, False, 0.0,
                         1e-5)
    return part.out(y)


def conv_bn(run, part, params, prefix, x, stride, padding, relu=True,
            bias=None):
    w = params[f"{prefix}.0.weight"]
    nd = w.dim() - 2
    y = part.product(
        lambda a, k, c: _conv(nd)(a, k, c, stride=stride, padding=padding),
        x, w, bias)
    y = batch_norm(run, part, params, f"{prefix}.1", y)
    return F.relu(y) if relu else y


def residual(run, part, params, prefix, x, stride):
    nd = x.dim() - 2
    one = (1,) * nd
    out = conv_bn(run, part, params, f"{prefix}.conv1", x, stride, one)
    out = conv_bn(run, part, params, f"{prefix}.conv2", out, one, one,
                  relu=False)
    if f"{prefix}.downsample.0.weight" in params:
        identity = conv_bn(run, part, params, f"{prefix}.downsample", x,
                           stride, (0,) * nd, relu=False)
    else:
        identity = x
    return F.relu(part.out(out + identity))


def linear(part: Part, params: Params, prefix: str, x):
    return part.product(F.linear, x, params[f"{prefix}.weight"],
                        params.get(f"{prefix}.bias"))


def attention(run, part, params, prefix, query, key, value, heads):
    d = query.shape[-1]
    w, b = params[f"{prefix}.in_proj_weight"], params[f"{prefix}.in_proj_bias"]
    q = part.product(F.linear, query, w[:d], b[:d])
    k = part.product(F.linear, key, w[d:2 * d], b[d:2 * d])
    v = part.product(F.linear, value, w[2 * d:], b[2 * d:])

    def split(t):
        n, t_len, _ = t.shape
        return t.reshape(n, t_len, heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = part.matmul(q, k.transpose(-2, -1)) * (1.0 / (d // heads) ** 0.5)
    weights = torch.softmax(logits, dim=-1)
    weights = run.dropout(weights)
    out = part.matmul(weights, v).transpose(1, 2)
    return linear(part, params, f"{prefix}.out_proj",
                  out.reshape(out.shape[0], out.shape[1], d))


# ---------------------------------------------------------------- model
def visual_encoder(run: Run, params: Params, x: torch.Tensor):
    """``(B, T, H, W, 3)`` in [0, 1] -> pooled ``(B, T, D)`` and the map
    ``(B, T, H', W', D)``."""
    low, high = run.parts["visual_low"], run.parts["visual_high"]
    p = "visual_encoder"
    out = conv_bn(run, low, params, f"{p}.stem", x.permute(0, 4, 1, 2, 3),
                  (1, 2, 2), (1, 3, 3))
    out = F.max_pool3d(out, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    out = residual(run, low, params, f"{p}.layer1", out, (1, 1, 1))
    out = residual(run, low, params, f"{p}.layer2", out, (1, 2, 2))
    out = high.out(out)
    out = residual(run, high, params, f"{p}.layer3", out, (1, 2, 2))
    out = residual(run, high, params, f"{p}.layer4", out, (1, 2, 2))
    out = run.dropout(out, feature=True)
    pooled = out.mean(dim=(3, 4)).transpose(1, 2)
    return pooled, out.permute(0, 2, 3, 4, 1)


def audio_encoder(run: Run, params: Params, x: torch.Tensor, layer3_t: int):
    """``(B, F, T, 1)`` log-mel dB -> ``(B, T', A)``."""
    part, p = run.parts["audio"], "audio_encoder"
    out = conv_bn(run, part, params, f"{p}.stem", x.permute(0, 3, 1, 2),
                  (2, 2), (3, 3))
    out = F.max_pool2d(out, (3, 3), (2, 2), (1, 1))
    out = residual(run, part, params, f"{p}.layer1", out, (1, 1))
    out = residual(run, part, params, f"{p}.layer2", out, (2, 2))
    out = residual(run, part, params, f"{p}.layer3", out, (2, layer3_t))
    out = residual(run, part, params, f"{p}.layer4", out, (2, 1))
    out = run.dropout(out)
    return out.mean(dim=2).transpose(1, 2)


def cross_modal(run, params, v_emb, a_emb, heads):
    part, p = run.parts["tokens"], "cross_modal"
    if a_emb.shape[1] != v_emb.shape[1]:
        a_emb = F.interpolate(a_emb.transpose(1, 2), size=v_emb.shape[1],
                              mode="linear", align_corners=False
                              ).transpose(1, 2)
    v_out = v_emb + attention(run, part, params, f"{p}.v2a_attn", v_emb,
                              a_emb, a_emb, heads)
    a_out = a_emb + attention(run, part, params, f"{p}.a2v_attn", a_emb,
                              v_emb, v_emb, heads)
    g = linear(part, params, f"{p}.gate.0", torch.cat([v_out, a_out], -1))
    g = torch.sigmoid(linear(part, params, f"{p}.gate.2", F.gelu(g)))
    return F.relu(linear(part, params, f"{p}.fuse.0",
                         g * v_out + (1.0 - g) * a_out))


def temporal(run, params, x, heads, layers):
    part, p = run.parts["tokens"], "temporal"
    b, _, d = x.shape
    xc = x.transpose(1, 2)
    branches = []
    for k in (3, 5, 7):
        w = params[f"{p}.branch_k{k}.0.weight"]
        y = part.product(lambda a, kk, c: F.conv1d(a, kk, c, padding=k // 2),
                         xc, w, None)
        y = batch_norm(run, part, params, f"{p}.branch_k{k}.1", y)
        branches.append(F.gelu(y))
    x = x + linear(part, params, f"{p}.pre_scale_proj",
                   torch.cat(branches, 1).transpose(1, 2))
    cls = params[f"{p}.cls_token"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1)
    for i in range(layers):
        q = f"{p}.transformer.layers.{i}"
        h = F.layer_norm(x, (d,), params[f"{q}.norm1.weight"],
                         params[f"{q}.norm1.bias"], 1e-5)
        x = x + run.dropout(attention(run, part, params, f"{q}.self_attn",
                                      h, h, h, heads))
        h = F.layer_norm(x, (d,), params[f"{q}.norm2.weight"],
                         params[f"{q}.norm2.bias"], 1e-5)
        h = run.dropout(F.gelu(linear(part, params, f"{q}.linear1", h)))
        x = x + run.dropout(linear(part, params, f"{q}.linear2", h))
    return x[:, 0]


def _stack(run, part, params, prefix, x, stride):
    """Conv3d(bias) -> BN -> ReLU, twice (k3, pad 1)."""
    for j in (0, 3):
        w, bias = params[f"{prefix}.{j}.weight"], params[f"{prefix}.{j}.bias"]
        x = part.product(
            lambda a, k, c: F.conv3d(a, k, c, stride=stride, padding=1),
            x, w, bias)
        x = F.relu(batch_norm(run, part, params, f"{prefix}.{j + 1}", x))
    return x


def artifact(run, params, v_map, cls_output, raw_video):
    part, p = run.parts["artifact"], "artifact_detector"
    tc = f"{p}.temporal_detector.temporal_conv"

    def detector(fmap):
        out = _stack(run, part, params, tc, part.out(fmap).permute(0, 4, 1, 2,
                                                                   3), 1)
        return out.mean(dim=(2, 3, 4))

    feats = [detector(v_map)]
    if v_map.shape[1] > 1:
        delta = part.out(v_map[:, 1:] - v_map[:, :-1])
    else:
        delta = torch.zeros_like(v_map)
    feats.append(detector(delta))
    hf = f"{p}.high_freq_detector"
    video = part.out(raw_video)
    b, t, h, w, c = video.shape
    frames = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    lap = part.product(lambda a, k, cc: F.conv2d(a, k, cc, padding=1),
                       frames, params[f"{hf}.laplacian.weight"], None)
    lap = lap.reshape(b, t, c, h, w).transpose(1, 2)
    out = _stack(run, part, params, f"{hf}.conv3d", lap, (1, 2, 2))
    feats.append(out.mean(dim=(2, 3, 4)))
    tokens = run.parts["tokens"]
    x = F.relu(linear(tokens, params, f"{p}.artifact_fusion.0",
                      torch.cat([cls_output, *feats], dim=-1)))
    return F.relu(linear(tokens, params, f"{p}.artifact_fusion.2", x))


def forward(params: Params, cfg: Mapping, visual: torch.Tensor,
            audio: torch.Tensor, run: Run, return_aux: bool = False):
    """Logits ``(B,)`` for ``visual`` ``(B, T, H, W, 3)`` in [0, 1] and
    ``audio`` ``(B, F, T_a, 1)`` dB; with ``return_aux`` also the
    projected visual and audio tokens."""
    g = geometry(cfg)
    tokens = run.parts["tokens"]
    v_feat, v_map = visual_encoder(run, params, visual.float())
    a_feat = audio_encoder(run, params, audio.float(), g["layer3_t"])
    v_emb = linear(tokens, params, "projection.visual_proj", v_feat)
    a_emb = linear(tokens, params, "projection.audio_proj", a_feat)
    fused = cross_modal(run, params, v_emb, a_emb, g["heads"])
    cls_output = temporal(run, params, fused, g["t_heads"], g["layers"])
    art = artifact(run, params, v_map, cls_output, visual.float())
    x = torch.cat([cls_output, art], dim=-1)
    x = run.dropout(F.gelu(linear(tokens, params, "classifier.net.0", x)))
    x = F.layer_norm(x, (x.shape[-1],), params["classifier.net.3.weight"],
                     params["classifier.net.3.bias"], 1e-5)
    logits = linear(tokens, params, "classifier.net.4", x).squeeze(-1)
    if return_aux:
        return logits, {"visual_tokens": v_emb, "audio_tokens": a_emb}
    return logits


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], cfg: Mapping,
              visual: torch.Tensor, audio: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics, in place, to the biased
    statistics that a batch produces, layer after layer in fp32: each
    layer's activations then stay near unit scale and the logits spread
    from window to window."""
    stats: Dict[str, torch.Tensor] = {}
    forward(params, cfg, visual, audio, Run(fp32_precision(),
                                            calibrate=stats))
    for k, v in stats.items():
        params[k].copy_(v)


def logits_in_blocks(params: Params, cfg: Mapping, visual_u8: torch.Tensor,
                     audio: torch.Tensor, precision, block: int
                     ) -> torch.Tensor:
    """Eval-mode logits of uint8 windows in blocks of ``block`` rows (each
    block is one batch, so a per-tensor int8 scale is the block's)."""
    outs: List[torch.Tensor] = []
    run = Run(precision)
    with torch.no_grad():
        for lo in range(0, visual_u8.shape[0], block):
            v = visual_u8[lo:lo + block].float() / 255.0
            outs.append(forward(params, cfg, v, audio[lo:lo + block], run))
    return torch.cat(outs)
