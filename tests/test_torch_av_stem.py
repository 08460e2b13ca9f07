"""K5, the 3D stem of AV-HuBERT (PReLU) and of Auto-AVSR (Swish)
(``ops/kernels/av_stem.py``, ``csrc/av_stem.cu``), on the CPU: the twin
against the module chain it stands for, with either activation, the
weights' shared-memory image entry by entry, a model of the kernel's
tiles, halo, GEMM, epilogue and pool on exact values, when ``ResEncoder``
takes the kernel, and what the wrapper refuses. The kernel itself runs on
the card: ``tests/test_torch_av_stem_card.py``.
"""

import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.models import avhubert
from lipsync_tpu_torch.models.avhubert import ResEncoder, stem_takes_kernel
from lipsync_tpu_torch.ops.kernels import av_stem as k5
from lipsync_tpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPES = [(1, 1, 88, 88), (3, 2, 17, 23), (1, 5, 9, 9), (3, 7, 9, 9),
          (1, 7, 17, 23)]


def cpu_conv3d(t, dtype):
    """oneDNN's CPU bf16 Conv3d returns garbage (NaN, inf, or sums off by
    units, and not the same twice) for a clip of one frame, where the
    temporal padding of 2 exceeds it: a fault of the CPU library, not of
    the stem. Such a clip runs on PyTorch's own CPU convolution."""
    if t == 1 and dtype == torch.bfloat16:
        return torch.backends.mkldnn.flags(enabled=False)
    return contextlib.nullcontext()


def encoder(seed, dtype=torch.bfloat16, act="prelu"):
    """A ``ResEncoder`` in eval mode as ``AVHubert`` (``act="prelu"``) or
    ``AutoAVSR`` (``"swish"``) stores it in ``dtype``: convolutions and
    PReLU in ``dtype``, BatchNorm fp32, with running statistics, weight and
    bias drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    enc = ResEncoder(act)
    bn = enc.frontend3D[1]
    with torch.no_grad():
        enc.frontend3D[0].weight.copy_(
            torch.randn(k5.WEIGHT_SHAPE, generator=g) * 0.05)
        bn.running_mean.copy_(torch.randn(64, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(64, generator=g) * 2 + 0.1)
        bn.weight.copy_(torch.randn(64, generator=g) * 0.5 + 1)
        bn.bias.copy_(torch.randn(64, generator=g) * 0.2)
        slopes = torch.rand(64, generator=g) * 0.5
        if act == "prelu":
            enc.frontend3D[2].weight.copy_(slopes)
    for m in enc.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.PReLU)):
            m.to(dtype)
    return enc.eval()


def by_shape(shapes):
    return pytest.mark.parametrize("shape", shapes,
                                   ids=lambda s: "x".join(map(str, s)))


DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "fp32"])


@DTYPES
@by_shape(SHAPES)
def test_twin_is_the_module_chain(shape, dtype):
    """``av_stem_plain`` is ``frontend3D`` bit for bit at odd shapes, and
    the wrapper runs it for a CPU tensor without counting a launch."""
    twin_is_the_module_chain(shape, dtype, "prelu")


@DTYPES
@by_shape(SHAPES)
def test_swish_twin_is_the_module_chain(shape, dtype):
    """So with Swish (no slope: ``prelu_weight=None``)."""
    twin_is_the_module_chain(shape, dtype, "swish")


def twin_is_the_module_chain(shape, dtype, act):
    enc = encoder(1, dtype, act)
    assert (k5.operands(enc.frontend3D)[-1] is None) == (act == "swish")
    b, t, h, w = shape
    x = torch.randn(b, 1, t, h, w,
                    generator=torch.Generator().manual_seed(2)).to(dtype)
    before = k5.launches
    with torch.no_grad(), cpu_conv3d(t, dtype):
        want = enc.frontend3D(x)
        got = k5.av_stem_plain(x, *k5.operands(enc.frontend3D))
        wrapped = k5.av_stem(x, *k5.operands(enc.frontend3D))
    ho, wo = k5.out_size(k5.out_size(h)), k5.out_size(k5.out_size(w))
    assert want.shape == (b, 64, t, ho, wo) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(wrapped, want)
    assert k5.launches == before


def reversed_sum_chain(x, conv_w, gamma, beta, mean, var, eps, slope):
    """The module chain with the conv's 245 products summed in fp32 one by
    one in the reverse tap order: the chain with another order of the
    sum (PReLU, or Swish for ``slope=None``)."""
    b, _, t, h, w = x.shape
    patches = F.pad(x.float(), (3, 3, 3, 3, 2, 2)).unfold(2, 5, 1).unfold(
        3, 7, 2).unfold(4, 7, 2).reshape(b, t, k5.out_size(h),
                                         k5.out_size(w), 1, 245)
    taps = conv_w.float().reshape(64, 245)
    y = torch.zeros(patches.shape[:-2] + (64,))
    for k in reversed(range(245)):
        y = y + patches[..., k] * taps[:, k]
    y = y.permute(0, 4, 1, 2, 3).to(x.dtype)
    y = F.batch_norm(y, mean, var, gamma, beta, False, 0.0, eps)
    y = F.silu(y) if slope is None else F.prelu(y, slope)
    return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))


BOUND_SHAPES = [(2, 5, 88, 88), (3, 7, 60, 71)]


@by_shape(BOUND_SHAPES)
def test_sum_order_bound_covers_another_order(shape):
    """``sum_order_bound``, the card tests' tolerance for K5 against the
    module chain, holds between the chain and the same chain summing its
    conv in another order, at random inputs where some pooled values differ; and
    it is near one bf16 step of each value carried through BatchNorm's
    gain and the activation's slope: its median within 4 steps of the
    pooled output's spacing at that gain and slope. Computed a window at a
    time (``BOUND_CHUNK``), it is the same bound."""
    sum_order_bound_covers_another_order(shape, "prelu")


@by_shape(BOUND_SHAPES)
def test_swish_sum_order_bound_covers_another_order(shape):
    """So with Swish, whose slope the bound takes as 1.1."""
    sum_order_bound_covers_another_order(shape, "swish")


def sum_order_bound_covers_another_order(shape, act):
    enc = encoder(7, act=act)
    b, t, h, w = shape
    x = torch.randn(b, 1, t, h, w,
                    generator=torch.Generator().manual_seed(8)).bfloat16()
    ops = k5.operands(enc.frontend3D)
    with torch.no_grad():
        want = enc.frontend3D(x)
        other = reversed_sum_chain(x, *ops)
        bound = k5.sum_order_bound(x, *ops)
        conv, bn, act_module, _ = enc.frontend3D
        slope = (k5.SWISH_SLOPE if act == "swish"
                 else act_module.weight.float().abs().clamp(min=1))
        gain = (bn.weight.abs() / torch.sqrt(bn.running_var + bn.eps)
                * slope).view(1, 64, 1, 1, 1)
        y = F.max_pool3d(conv(x).float().abs(), (1, 3, 3), (1, 2, 2),
                         (0, 1, 1))
        steps = bound / (gain * k5._step(y) + k5._step(want.float().abs()))
    diff = (other.float() - want.float()).abs()
    assert bound.shape == want.shape
    assert bool((diff > 0).any())
    assert bool((diff <= bound).all()), float((diff / bound).max())
    assert float(steps.median()) <= 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k5, "BOUND_CHUNK", 1)
        assert torch.equal(k5.sum_order_bound(x, *ops), bound)


def test_pack_weights_entry_by_entry():
    """The weights' shared-memory image: K block ``kb``, row ``n``, slot
    ``s``, element ``e`` holds K column ``k = 64 kb + 8 (s ^ n % 8) + e``,
    which is tap ``(dt, dy, dx) = (r // 7, r % 7, k % 8 - 1)`` of tap row
    ``r = k // 8``, and zero for ``k % 8 == 0`` or ``r >= 35``."""
    w = torch.randn(k5.WEIGHT_SHAPE,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    want = torch.zeros(k5.K_BLOCKS * 64 * 64, dtype=torch.bfloat16)
    for kb in range(k5.K_BLOCKS):
        for n in range(64):
            for s in range(8):
                for e in range(8):
                    k = 64 * kb + 8 * (s ^ (n % 8)) + e
                    r, dx = divmod(k, 8)
                    if r < k5.TAP_ROWS and dx > 0:
                        want[(kb * 64 + n) * 64 + 8 * s + e] = \
                            w[n, 0, r // 7, r % 7, dx - 1]
    got = k5.pack_weights(w)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def unpack(image):
    """B ``(K, 64)`` read back from the shared image as the kernel's
    ``wgmma`` descriptor addresses it: column ``n``, K row ``k`` at K block
    ``k // 64``, row ``n``, 16-byte chunk ``(k % 64) // 8`` swizzled with
    ``n % 8``."""
    k = torch.arange(k5.K_BLOCKS * 64)[:, None]
    n = torch.arange(64)[None, :]
    idx = ((k // 64) * 64 + n) * 64 + 8 * (((k % 64) // 8) ^ (n % 8)) + k % 8
    return image[idx]


def kernel_model(x, conv_weight, bn_weight, bn_bias, bn_mean, bn_var, eps,
                 prelu_weight):
    """The kernel's arithmetic in plain torch, tile by tile as it walks
    them: the 5 x 27 x 52 halo of a 5 x 11 pooled tile (rows from 4 py0 - 5,
    columns from 4 px0 - 6, zero outside the clip), GEMM row m = 23 i + j
    gathering K column 8 r + dx' from halo (r // 7, 2 i + r % 7, 2 j + dx')
    (row 35 reads row 34), B from the packed image, the sum rounded to bf16,
    BatchNorm as ``fma(gamma * (y - mean), invstd, beta)``, PReLU (or for
    ``prelu_weight=None`` Swish as ``z / (1 + exp(-z))`` in fp32, rounded),
    and the 3 x 3 max over the conv positions inside the frame. Sums in
    float64."""
    b, _, t, h, w = x.shape
    ho, wo = k5.out_size(h), k5.out_size(w)
    hp, wp = k5.out_size(ho), k5.out_size(wo)
    py_n, px_n = k5.POOL_TILE
    bmat = unpack(k5.pack_weights(conv_weight)).double()[:288]
    invstd = torch.rsqrt(bn_var + eps)
    slope = None if prelu_weight is None else prelu_weight.float()
    m = 64  # zero margin past every halo
    xp = torch.zeros(b, t + 4, h + 2 * m, w + 2 * m, dtype=torch.float64)
    xp[:, 2:t + 2, m:m + h, m:m + w] = x[:, 0].double()
    out = torch.empty(b, t, 64, hp, wp, dtype=torch.bfloat16)
    i = torch.arange(2 * py_n + 1)[:, None]
    j = torch.arange(2 * px_n + 1)[None, :]
    r = torch.arange(36).clamp(max=k5.TAP_ROWS - 1)
    for bi in range(b):
        for ti in range(t):
            for py0 in range(0, hp, py_n):
                for px0 in range(0, wp, px_n):
                    iy0, ix0 = 4 * py0 - 5 + m, 4 * px0 - 6 + m
                    halo = xp[bi, ti:ti + 5, iy0:iy0 + 27, ix0:ix0 + 52]
                    rows = (2 * i + (r % 7)[:, None, None])  # (36, 11, 1)
                    cols = 2 * j[None] + torch.arange(8)[:, None, None, None]
                    a = halo[(r // 7)[None, :, None, None], rows[None],
                             cols]  # (8 dx', 36 r, 11, 23)
                    a = a.permute(2, 3, 1, 0).reshape(-1, 288)
                    y = (a @ bmat).float().bfloat16().float()
                    z = torch.addcmul(bn_bias, bn_weight * (y - bn_mean),
                                      invstd).bfloat16().float()
                    if slope is None:
                        z = (z / (1 + torch.exp(-z))).bfloat16().float()
                    else:
                        z = torch.where(z > 0, z,
                                        (slope * z).bfloat16().float())
                    z = z.reshape(2 * py_n + 1, 2 * px_n + 1, 64)
                    hos = 2 * py0 - 1 + torch.arange(2 * py_n + 1)
                    wos = 2 * px0 - 1 + torch.arange(2 * px_n + 1)
                    inside = (((hos >= 0) & (hos < ho))[:, None]
                              & ((wos >= 0) & (wos < wo))[None, :])
                    z = z.masked_fill(~inside[..., None], float("-inf"))
                    z = z.permute(2, 0, 1)[None]
                    pooled = torch.nn.functional.max_pool2d(
                        torch.nn.functional.pad(z, (0, 1, 0, 1),
                                                value=float("-inf")),
                        3, 2)[0]
                    n_y, n_x = min(py_n, hp - py0), min(px_n, wp - px0)
                    out[bi, ti, :, py0:py0 + n_y, px0:px0 + n_x] = \
                        pooled[:, :n_y, :n_x].bfloat16()
    return out


MODEL_SHAPES = [(1, 3, 9, 9), (2, 2, 17, 23), (1, 1, 40, 50), (1, 6, 1, 3)]


@by_shape(MODEL_SHAPES)
def test_kernel_model_is_the_chain_on_exact_values(shape):
    """On pixels in {-1, 0, 1} / 4 and weights in {-1, 0, 1} / 8 every sum
    is exact in any order (multiples of 1/32 under 8), and BatchNorm with
    eps 0, unit variance and dyadic weight, mean and bias is exact in both
    its formulas: the model of the kernel's tiles, halo, K layout, packed B
    and pool then equals the twin bit for bit, through every tile border
    and frame edge."""
    kernel_model_is_the_chain_on_exact_values(shape, "prelu")


@by_shape(MODEL_SHAPES)
def test_swish_kernel_model_is_the_chain_on_exact_values(shape):
    """So with Swish, whose fp32 formula the model shares with the twin's
    silu."""
    kernel_model_is_the_chain_on_exact_values(shape, "swish")


def kernel_model_is_the_chain_on_exact_values(shape, act):
    g = torch.Generator().manual_seed(4)
    b, t, h, w = shape
    x = (torch.randint(-1, 2, (b, 1, t, h, w), generator=g) / 4).bfloat16()
    cw = (torch.randint(-1, 2, k5.WEIGHT_SHAPE, generator=g) / 8).bfloat16()
    bn = ((torch.randint(1, 3, (64,), generator=g) / 2).float(),
          (torch.randint(-4, 5, (64,), generator=g) / 8).float(),
          (torch.randint(-4, 5, (64,), generator=g) / 8).float(),
          torch.ones(64))
    slope = (torch.randint(0, 4, (64,), generator=g) / 4).bfloat16()
    if act == "swish":
        slope = None
    with cpu_conv3d(t, torch.bfloat16):
        want = k5.av_stem_plain(x, cw, *bn, 0.0, slope)
    got = kernel_model(x, cw, *bn, 0.0, slope)
    assert torch.equal(got.transpose(1, 2), want)


def test_engagement_rule(monkeypatch):
    """K5 runs the stem only for a bf16 CUDA input in eval mode with no
    grad: the CPU, fp32 and training take the module chain. Where it
    runs, ``avhubert.stem`` opens inside ``avhubert.visual`` and the
    counters add one call and its conv positions, only while a profiler
    session is active."""
    enc = encoder(5)
    cuda_bf16 = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    cuda_fp32 = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    x = torch.randn(2, 1, 3, 17, 23).bfloat16()
    with torch.no_grad():
        assert stem_takes_kernel(cuda_bf16, enc)
        assert not stem_takes_kernel(x, enc)
        assert not stem_takes_kernel(cuda_fp32, enc)
        enc.train()
        assert not stem_takes_kernel(cuda_bf16, enc)
        enc.eval()
    assert not stem_takes_kernel(cuda_bf16, enc)  # grad enabled

    calls = []
    monkeypatch.setattr(k5, "av_stem",
                        lambda *a: calls.append(1) or k5.av_stem_plain(*a))
    with torch.no_grad():
        chain = enc(x)
    assert calls == []

    monkeypatch.setattr(avhubert, "stem_takes_kernel", lambda x, m: True)
    profiling.clear()
    with torch.no_grad():
        assert torch.equal(enc(x), chain)
    assert len(calls) == 1
    assert profiling.records() == [] and profiling.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad(), profiling.span("avhubert.visual"):
            enc(x)
    by_name = {r.name: r for r in profiling.records()}
    assert by_name["avhubert.stem"].parent == by_name["avhubert.visual"].id
    assert profiling.counters() == {"avhubert.stem_calls": 1,
                                    "avhubert.stem_outputs": 2 * 3 * 9 * 12}
    profiling.clear()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    enc = encoder(6)
    conv_w, gamma, beta, mean, var, eps, slope = k5.operands(enc.frontend3D)
    bn = (gamma, beta, mean, var)
    x = torch.randn(1, 1, 2, 9, 9).bfloat16()
    for bad in (torch.randn(1, 3, 2, 9, 9).bfloat16(),
                torch.randn(1, 2, 9, 9).bfloat16(),
                torch.zeros(0, 1, 2, 9, 9).bfloat16()):
        with pytest.raises(ValueError):
            k5.av_stem(bad, *k5.operands(enc.frontend3D))
    for bad_w in (conv_w[:32], conv_w[..., :5], conv_w.expand(64, 3, 5, 7, 7)):
        with pytest.raises(ValueError, match="conv_weight"):
            k5.av_stem(x, bad_w, *bn, eps, slope)
    with pytest.raises(ValueError, match="prelu_weight"):
        k5.av_stem(x, conv_w, *bn, eps, slope[:1])
    with pytest.raises(TypeError, match="x must be bfloat16"):
        k5.check_operands(x.float(), conv_w, bn, slope)
    with pytest.raises(TypeError, match="conv_weight must be bfloat16"):
        k5.check_operands(x, conv_w.float(), bn, slope)
    with pytest.raises(TypeError, match="prelu_weight must be bfloat16"):
        k5.check_operands(x, conv_w, bn, slope.float())
    with pytest.raises(TypeError, match="float32"):
        k5.check_operands(x, conv_w, (gamma.bfloat16(), beta, mean, var),
                          slope)
    with pytest.raises(ValueError, match="BatchNorm"):
        k5.check_operands(x, conv_w, (gamma[:8], beta, mean, var), slope)
    with pytest.raises(ValueError, match="tiles"):
        k5.check_operands(torch.empty(2 ** 16, 1, 2 ** 12, 88, 88,
                                      dtype=torch.bfloat16, device="meta"),
                          conv_w.to("meta"),
                          tuple(p.to("meta") for p in bn), slope.to("meta"))
    k5.check_operands(x, conv_w, bn, slope)
    with pytest.raises(ValueError, match="unsupported device"):
        k5.av_stem(x.to("meta"), *(a.to("meta") if torch.is_tensor(a) else a
                                   for a in k5.operands(enc.frontend3D)))


def _reader(name):
    from benchmark.core import cell as cells

    return cells.load_module(cells.metric_path(name), f"m.{name}")


@pytest.mark.parametrize("program", ["with_k5", "parent"])
def test_benchmark_readers(monkeypatch, program):
    """``avhubert.stem_ms.av_bulk`` is the median over the window's groups
    of the ``avhubert.stem`` spans' device time; ``k5_av_stem_roofline``
    the least time of the window's K5 launches (their positions from the
    counters, each the larger of 31,360 operations at the bf16 peak and 40
    bytes at the memory bandwidth) over their kernel time. A program
    without the span, the counters and the kernel (the parent) gives
    neither."""
    from benchmark.core import peaks
    from benchmark.core.trace import Trace
    from benchmark.run import View
    from lipsync_tpu_torch.utils.profiling import SpanRecord

    ms = 1_000_000
    recs, kernels = [], []
    for g, (at, stem_ms) in enumerate(((900, 2.4), (1100, 2.5),
                                       (1500, 2.7))):
        f = 10 * (g + 1)
        recs += [SpanRecord(f, 1, 1, "engine.forward", at * ms,
                            (at + 60) * ms, 0.058),
                 SpanRecord(f + 1, f, 1, "avhubert.visual", at * ms,
                            (at + 40) * ms, 0.038)]
        if program == "with_k5":
            recs.append(SpanRecord(f + 2, f + 1, 1, "avhubert.stem",
                                   at * ms, (at + 3) * ms, stem_ms / 1e3))
            kernels.append((at * ms, int((at + stem_ms) * ms),
                            "void (anonymous namespace)::av_stem_kernel"
                            "<true>(...)"))
    positions = 256 * 32 * 44 * 44
    counters = ({"avhubert.stem_calls": 3,
                 "avhubert.stem_outputs": 3 * positions}
                if program == "with_k5" else {})
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    tr = Trace(False)
    tr.window = (1000 * ms, 2000 * ms)
    tr.kernels = kernels
    view = View(types.SimpleNamespace(config={}), {}, tr)
    stem_ms = _reader("avhubert.stem_ms.av_bulk").read(view)
    roofline = _reader("k5_av_stem_roofline").read(view)
    if program == "parent":
        assert stem_ms is None and roofline is None
        return
    assert stem_ms == pytest.approx(2.6)  # groups 2 and 3
    least = positions * max(31360 / peaks.peak("bf16"),
                            40 / peaks.H100_SXM["bytes_per_s"])
    assert roofline == pytest.approx(100 * 2 * least / 5.2e-3)
    assert 0 < roofline < 100


def test_swish_stem_names_its_own_spans(monkeypatch):
    """Auto-AVSR's ``ResEncoder("swish", "auto_avsr")`` hands K5 no slope
    (the Swish instantiation) and records ``auto_avsr.stem`` and the
    counters ``auto_avsr.stem_calls`` and ``auto_avsr.stem_outputs``, not
    AV-HuBERT's."""
    enc = encoder(5, act="swish")
    enc.name = "auto_avsr"
    x = torch.randn(2, 1, 3, 17, 23).bfloat16()
    seen = []
    monkeypatch.setattr(k5, "av_stem",
                        lambda *a: seen.append(a[-1]) or k5.av_stem_plain(*a))
    monkeypatch.setattr(avhubert, "stem_takes_kernel", lambda x, m: True)
    with torch.no_grad():
        chain = enc.frontend3D(x)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad(), profiling.span("auto_avsr.video"):
            assert torch.equal(enc.stem(x), chain)
    assert seen == [None]
    by_name = {r.name: r for r in profiling.records()}
    assert by_name["auto_avsr.stem"].parent == by_name["auto_avsr.video"].id
    assert profiling.counters() == {"auto_avsr.stem_calls": 1,
                                    "auto_avsr.stem_outputs": 2 * 3 * 9 * 12}
    profiling.clear()


def test_wrapper_takes_no_slope_for_swish():
    """``prelu_weight=None`` is Swish: the shape and operand checks pass
    without a slope, and the CPU twin applies ``silu``."""
    enc = encoder(6, act="swish")
    ops = k5.operands(enc.frontend3D)
    x = torch.randn(1, 1, 2, 9, 9).bfloat16()
    k5.check_shapes(x, ops[0], None)
    k5.check_operands(x, ops[0], ops[1:5], None)
    with torch.no_grad():
        y = F.conv3d(x, ops[0], None, (1, 2, 2), (2, 3, 3))
        y = F.batch_norm(y, ops[3], ops[4], ops[1], ops[2], False, 0.0,
                         ops[5])
        want = F.max_pool3d(F.silu(y), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        assert torch.equal(k5.av_stem(x, *ops), want)


def test_swish_roofline_reads_its_own_counters(monkeypatch):
    """``k5_swish_stem_roofline`` reads ``auto_avsr.stem_*`` and
    ``k5_av_stem_roofline`` ``avhubert.stem_*``: in a window of the Swish
    stem alone the PReLU reader finds nothing, and the other way round."""
    from benchmark.core import auto_avsr_flops
    from benchmark.core.trace import Trace
    from benchmark.run import View

    ms = 1_000_000
    positions = 256 * 96 * 44 * 44
    tr = Trace(False)
    tr.window = (1000 * ms, 2000 * ms)
    tr.kernels = [(1100 * ms, 1106 * ms,
                   "void (anonymous namespace)::av_stem_kernel<true, true>"
                   "(...)")]
    view = View(types.SimpleNamespace(config={}), {}, tr)
    for prefix, metric, other in (
            ("auto_avsr", "k5_swish_stem_roofline", "k5_av_stem_roofline"),
            ("avhubert", "k5_av_stem_roofline", "k5_swish_stem_roofline")):
        counters = {f"{prefix}.stem_calls": 1,
                    f"{prefix}.stem_outputs": positions}
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
        got = _reader(metric).read(view)
        assert 0 < got < 100
        assert _reader(other).read(view) is None
    least = auto_avsr_flops.stem_least_seconds(positions)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "auto_avsr.stem_calls": 1, "auto_avsr.stem_outputs": positions})
    assert _reader("k5_swish_stem_roofline").read(view) == pytest.approx(
        100 * least / 6e-3)
