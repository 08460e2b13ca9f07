"""K6, the visual encoder's fp32 residual-block convolutions on the TF32
tensor cores in 3xTF32 (``ops/kernels/conv3d_tf32x3.py``,
``csrc/conv3d_tf32x3.cu``), on the CPU: when a residual block takes the
kernel (case by case, each other case running the module chain), the
weights' packing entry by entry and a model of the kernel's GEMM in its K
order, the epilogue's BatchNorm affine against float64, the block's
channels-last route through the twin, the counters and the ``visual.low``
span, what the wrapper refuses, and the benchmark's readers. The kernel
itself runs on the card: ``tests/test_torch_conv3d_tf32x3_card.py``.
"""

import types

import pytest
import torch
import torch.nn.functional as F

from lipsync_tpu_torch.models import layers
from lipsync_tpu_torch.models.layers import (
    ConvBNAct,
    ResidualBlockND,
    tf32x3_takes,
)
from lipsync_tpu_torch.models.visual_encoder import VisualEncoder
from lipsync_tpu_torch.ops.kernels import conv3d_tf32x3 as k6
from lipsync_tpu_torch.utils import profiling

torch.set_num_threads(1)

CUDA = torch.device("cuda")


def fake(dtype=torch.float32, dim=5):
    """What the predicate reads of a CUDA tensor, without a card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, device=CUDA,
                                 dim=lambda: dim)


def calibrated(module, seed):
    """``module`` in eval mode with every BatchNorm's statistics and affine
    drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in layers.batch_norms(module):
            c = bn.num_features
            bn.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
            bn.weight.copy_(torch.randn(c, generator=g) * 0.3 + 1)
            bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
    return module.eval()


def block_convs(block):
    return [block.conv1, block.conv2] + (
        [] if block.downsample is None else [block.downsample])


# ── when a block takes the kernel ────────────────────────────────────────

def visual_blocks():
    enc = VisualEncoder().eval()
    return {"layer1": enc.layer1, "layer2": enc.layer2,
            "layer3": enc.layer3, "layer4": enc.layer4}


@pytest.mark.parametrize("name", ["layer1", "layer2", "layer3", "layer4"])
def test_every_visual_block_takes_the_kernel_on_fp32_cuda(name):
    """Layers 1-2 (and layers 3-4 where they run in fp32) take K6 for an
    fp32 CUDA input in eval mode with no gradient: both 3x3x3 convolutions
    and the 1x1x1 shortcut."""
    block = visual_blocks()[name]
    with torch.no_grad():
        assert all(tf32x3_takes(fake(), c) for c in block_convs(block))


CASES = {
    "cpu": lambda: (torch.zeros(1, 64, 2, 4, 4), {}),
    "bf16": lambda: (fake(torch.bfloat16), {}),
    "2d": lambda: (fake(dim=4), {"block": ResidualBlockND(64, 64, (3, 3),
                                                          (1, 1))}),
    "int8_lowering": lambda: (fake(), {"block": ResidualBlockND(
        64, 64, (3, 3, 3), (1, 1, 1), "int8")}),
    "shift_matmul_lowering": lambda: (fake(), {"block": ResidualBlockND(
        64, 64, (3, 3, 3), (1, 1, 1), "shift_matmul")}),
    "stride_2_in_time": lambda: (fake(), {"block": ResidualBlockND(
        64, 128, (3, 3, 3), (2, 2, 2))}),
    "stride_1_2_1": lambda: (fake(), {"block": ResidualBlockND(
        64, 128, (3, 3, 3), (1, 2, 1))}),
    "c_in_48": lambda: (fake(), {"block": ResidualBlockND(
        48, 64, (3, 3, 3), (1, 1, 1))}),
    "c_out_96": lambda: (fake(), {"block": ResidualBlockND(
        64, 96, (3, 3, 3), (1, 1, 1))}),
    "kernel_5": lambda: (fake(), {"block": ResidualBlockND(
        64, 64, (5, 5, 5), (1, 1, 1))}),
    "training": lambda: (fake(), {"train": True}),
    "grad_enabled": lambda: (fake(), {"grad": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_other_case_runs_the_module_chain(case, monkeypatch):
    """The CPU, bf16, a 2-d block, the int8 and shift-matmul lowerings, a
    stride or width or kernel outside K6's, training and a recorded
    gradient: the predicate refuses, and the block's forward on a CPU
    tensor of that geometry is the module chain, with no K6 launch."""
    x, opts = CASES[case]()
    block = opts.get("block", ResidualBlockND(64, 64, (3, 3, 3), (1, 1, 1)))
    calibrated(block, 1)
    block.train(opts.get("train", False))
    with torch.set_grad_enabled(opts.get("grad", False)):
        assert not all(tf32x3_takes(x, c) for c in block_convs(block))

    monkeypatch.setattr(layers, "tf32x3_conv",
                        lambda *a, **k: pytest.fail("K6 was taken"))
    nd = len(block.conv1[0].kernel_size)
    xc = torch.randn((2, block.conv1[0].in_channels) + (3, 6, 6)[-nd:],
                     generator=torch.Generator().manual_seed(2))
    with torch.set_grad_enabled(opts.get("grad", False)):
        if case == "int8_lowering":
            block.eval()
        identity = xc if block.downsample is None else block.downsample(xc)
        want = F.relu(block.conv2(block.conv1(xc)) + identity)
        got = block(xc)
    assert torch.equal(got, want)


def test_autocast_runs_the_module_chain():
    """Under autocast a convolution of an fp32 tensor runs in the autocast
    dtype, which K6 does not compute: the predicate refuses."""
    block = ResidualBlockND(64, 64, (3, 3, 3), (1, 1, 1)).eval()
    x = fake()
    x.device = torch.device("cpu")
    with torch.no_grad():
        assert tf32x3_takes(x, block.conv1)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert not tf32x3_takes(x, block.conv1)


# ── the packing and a model of the kernel's GEMM ───────────────────────

def test_k_order_is_a_permutation_read_as_two_16_byte_loads():
    """Logical columns t, t + 4 of each k8 slice (a thread's A fragment)
    are physical channels 8 t .. 8 t + 7 of the step: in slice order,
    pairs of neighbours."""
    order = k6.k_order()
    assert sorted(order.tolist()) == list(range(32))
    for t in range(4):
        mine = [order[8 * kk + t + 4 * e].item() for kk in range(4)
                for e in range(2)]
        assert mine == list(range(8 * t, 8 * t + 8))


@pytest.mark.parametrize("shape", [(64, 64, 3, 3, 3), (128, 64, 3, 3, 3),
                                   (128, 128, 3, 3, 3), (128, 64, 1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_weight_matrix_entry_by_entry(shape):
    """Column ``32 q + k`` of row ``n`` holds the weight of tap ``q //
    (C_in / 32)`` (kt, kh, kw; kw fastest) and channel ``32 (q % (C_in /
    32)) + k_order[k]``."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    m = k6.weight_matrix(w)
    cout, cin, kd, kh, kw = shape
    assert m.shape == (cout, kd * kh * kw * cin)
    order = k6.k_order()
    g = torch.Generator().manual_seed(4)
    for n, col in zip(torch.randint(0, cout, (64,), generator=g).tolist(),
                      torch.randint(0, m.shape[1], (64,),
                                    generator=g).tolist()):
        q, k = divmod(col, 32)
        tap, cb = divmod(q, cin // 32)
        td, rest = divmod(tap, kh * kw)
        th, tw = divmod(rest, kw)
        assert m[n, col] == w[n, 32 * cb + order[k], td, th, tw]


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_hi_and_lo_rebuild_the_weight(scale):
    """``hi`` and ``lo`` are TF32 values (13 low bits zero), ``hi`` is
    ``w`` rounded to nearest with ties away, and ``hi + lo`` is within
    2^-22 of ``|w|``."""
    w = torch.randn(64, 64, 3, 3, 3,
                    generator=torch.Generator().manual_seed(5)) * scale
    hi, lo = k6.pack_weights(w)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    m = k6.weight_matrix(w).double()
    assert ((hi.double() - m).abs() <= m.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - m).abs()
            <= m.abs() * 2.0 ** -22).all()


def kernel_model(x, p, stride, padding):
    """The kernel's GEMM in float64: A gathered per K step (one tap, 32
    channels, zero outside the input) with its columns in K order, times
    ``hi + lo`` of the packed weight."""
    cout, cin, *kernel = p.weight.shape
    o = k6.out_shape(x.shape, kernel, cout, stride, padding)
    pads = (0, 0) + tuple(v for pd in reversed(padding) for v in (pd, pd))
    xp = F.pad(x.double(), pads)
    order = k6.k_order()
    cols = []
    for dt in range(kernel[0]):
        for dy in range(kernel[1]):
            for dx in range(kernel[2]):
                v = xp[:, dt:dt + stride[0] * (o[1] - 1) + 1:stride[0],
                       dy:dy + stride[1] * (o[2] - 1) + 1:stride[1],
                       dx:dx + stride[2] * (o[3] - 1) + 1:stride[2]]
                cols.append(v.reshape(-1, cin // 32, 32)[:, :, order]
                            .reshape(-1, cin))
    a = torch.cat(cols, 1)
    return (a @ (p.whi.double() + p.wlo.double()).t()).reshape(o)


@pytest.mark.parametrize("geometry", [
    (64, 64, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (64, 128, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    (128, 128, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (64, 128, (1, 1, 1), (1, 2, 2), (0, 0, 0))],
    ids=["layer1", "layer2.conv1", "layer2.conv2", "layer2.shortcut"])
@pytest.mark.parametrize("shape", [(2, 3, 7, 9), (1, 1, 2, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_is_the_convolution(geometry, shape):
    """At every layers 1-2 geometry and at ragged frames the packed GEMM
    in its K order is the convolution to within the weight's 2^-22."""
    cin, cout, kernel, stride, padding = geometry
    g = torch.Generator().manual_seed(6)
    x = torch.randn(*shape, cin, generator=g)
    block = calibrated(ConvBNAct(cin, cout, kernel, stride, padding), 7)
    p = k6.packed(block)
    got = kernel_model(x, p, stride, padding)
    want = F.conv3d(x.double().permute(0, 4, 1, 2, 3), p.weight.double(),
                    None, stride, padding).permute(0, 2, 3, 4, 1)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("seed", [8, 9])
def test_epilogue_affine_is_batchnorm_in_float64(seed):
    """``y * scale + shift`` in fp32 (one fused multiply-add, as the
    epilogue computes it) lies within 4 fp32 ulps of eval BatchNorm
    computed in float64 over the same fp32 ``y``."""
    block = calibrated(ConvBNAct(64, 64, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
                       seed)
    bn = block[1]
    scale, shift = k6.bn_affine(bn)
    y = torch.randn(4096, 64, generator=torch.Generator().manual_seed(seed))
    got = torch.addcmul(shift.double(), y.double(), scale.double()).float()
    inv = torch.rsqrt(bn.running_var.double() + bn.eps)
    want = ((y.double() - bn.running_mean.double()) * inv * bn.weight.double()
            + bn.bias.double())
    ulp = torch.finfo(torch.float32).eps * (y.double().abs() * scale.double()
                                            .abs() + shift.double().abs())
    assert ((got.double() - want).abs() <= 4 * ulp + 1e-30).all()


def test_packed_is_kept_until_a_parameter_changes():
    block = calibrated(ConvBNAct(64, 64, (3, 3, 3), (1, 1, 1), (1, 1, 1)), 10)
    p = k6.packed(block)
    assert k6.packed(block) is p
    for t in (block[0].weight, block[1].running_var, block[1].bias):
        with torch.no_grad():
            t.mul_(1.5)
        q = k6.packed(block)
        assert q is not p
        p = q
    assert torch.equal(p.scale, k6.bn_affine(block[1])[0])
    assert torch.equal(p.whi, k6.pack_weights(block[0].weight)[0])


# ── the block's route through K6, on the twin ──────────────────────────

@pytest.mark.parametrize("name", ["layer1", "layer2"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (1, 5, 7, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_block_route_is_the_module_chain(name, shape, monkeypatch):
    """With the predicate forced on the CPU, the block runs channels-last
    through the wrapper (the twin): conv1 with ReLU, the shortcut, conv2
    with the shortcut added and ReLU, in fp32; five launches counted for
    layers 1-2, with twice their multiply-adds."""
    block = calibrated(visual_blocks()[name], 11)
    cin = block.conv1[0].in_channels
    x = torch.randn(shape[0], cin, *shape[1:],
                    generator=torch.Generator().manual_seed(12)).relu()
    with torch.no_grad():
        want = block(x)
        monkeypatch.setattr(layers, "tf32x3_takes", lambda x, b: True)
        got = block(x)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            profiling.clear()
            block(x)
            counters = profiling.counters()
        profiling.clear()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    convs = block_convs(block)
    assert counters["visual.k6_calls"] == len(convs)
    s = x.permute(0, 2, 3, 4, 1).shape
    h = k6.out_shape(s, (3, 3, 3), block.conv1[0].out_channels,
                     block.conv1[0].stride, (1, 1, 1))
    want_flops = (k6.flops(s, block.conv1[0].weight.shape,
                           block.conv1[0].stride, (1, 1, 1))
                  + k6.flops(h, block.conv2[0].weight.shape, (1, 1, 1),
                             (1, 1, 1)))
    if block.downsample is not None:
        want_flops += k6.flops(s, block.downsample[0].weight.shape,
                               block.downsample[0].stride, (0, 0, 0))
    assert counters["visual.k6_flops"] == want_flops


def test_visual_low_span_around_the_stem_and_layers_1_2():
    """``visual.low`` is recorded around the stem, its pool and layers 1-2
    while a profiler session runs, and costs nothing otherwise."""
    enc = calibrated(VisualEncoder(), 13)
    x = torch.rand(1, 2, 32, 32, 3)
    profiling.clear()
    with torch.no_grad():
        enc(x)
        assert profiling.records() == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            enc(x)
    names = [r.name for r in profiling.records()]
    profiling.clear()
    assert names == ["visual.low"]


# ── what the wrapper refuses ──────────────────────────────────────────

def test_wrapper_rejects_what_the_kernel_does_not_take():
    block = calibrated(ConvBNAct(64, 128, (3, 3, 3), (1, 2, 2), (1, 1, 1)),
                       14)
    p = k6.packed(block)
    s, pad = (1, 2, 2), (1, 1, 1)
    x = torch.randn(1, 2, 5, 5, 64)
    k6.check_operands(x, p, s, pad, None)
    for bad in (torch.randn(2, 5, 5, 64), torch.zeros(0, 2, 5, 5, 64),
                torch.randn(1, 2, 5, 5, 32)):
        with pytest.raises(ValueError):
            k6.conv3d_tf32x3(bad, p, s, pad)
    with pytest.raises(TypeError, match="x must be float32"):
        k6.conv3d_tf32x3(x.double(), p, s, pad)
    narrow = p._replace(weight=torch.zeros(96, 48, 3, 3, 3))
    with pytest.raises(ValueError, match="multiple"):
        k6.conv3d_tf32x3(torch.randn(1, 2, 5, 5, 48), narrow, s, pad)
    wide = p._replace(weight=torch.zeros(64, 64 * 16, 3, 3, 3))
    with pytest.raises(ValueError, match="512 K steps"):
        k6.check_operands(torch.zeros(1, 2, 5, 5, 64 * 16), wide, s, pad,
                          None)
    for bad_s, bad_p in (((1, 0, 1), pad), (s, (1, -1, 1)), ((1, 2), pad)):
        with pytest.raises(ValueError, match="stride"):
            k6.conv3d_tf32x3(x, p, bad_s, bad_p)
    with pytest.raises(ValueError, match="empty output"):
        k6.conv3d_tf32x3(torch.randn(1, 2, 5, 5, 64), p, s, (0, 0, 0))
    out = k6.out_shape(x.shape, (3, 3, 3), 128, s, pad)
    with pytest.raises(ValueError, match="residual must be"):
        k6.conv3d_tf32x3(x, p, s, pad, torch.zeros(1, 2, 3, 3, 64))
    with pytest.raises(TypeError, match="residual must be float32"):
        k6.conv3d_tf32x3(x, p, s, pad, torch.zeros(out).bfloat16())
    with pytest.raises(ValueError, match="device"):
        k6.conv3d_tf32x3(x, p, s, pad, torch.zeros(out, device="meta"))
    meta = k6.Packed(*(t.to("meta") for t in p))
    with pytest.raises(ValueError, match="unsupported device"):
        k6.conv3d_tf32x3(x.to("meta"), meta, s, pad)


# ── the benchmark's readers ──────────────────────────────────────────

def _reader(name):
    from benchmark.core import cell as cells

    return cells.load_module(cells.metric_path(name), f"m.{name}")


@pytest.mark.parametrize("program", ["with_k6", "parent"])
def test_benchmark_readers(monkeypatch, program):
    """``visual.low_ms.bulk`` is the median over the window's groups of the
    ``visual.low`` spans' device time; ``k6_conv3d_roofline`` the least
    time of the window's K6 launches (their FLOPs from the counters at the
    single-pass TF32 peak) over their kernel time. A program without the
    span, the counters and the kernel (the parent) gives neither."""
    from benchmark.core import peaks
    from benchmark.core.trace import Trace
    from benchmark.run import View
    from lipsync_tpu_torch.utils.profiling import SpanRecord

    ms = 1_000_000
    recs, kernels = [], []
    for g, (at, low_ms) in enumerate(((900, 120.0), (1100, 125.0),
                                      (1500, 131.0))):
        f = 10 * (g + 1)
        recs.append(SpanRecord(f, 1, 1, "engine.forward", at * ms,
                               (at + 200) * ms, 0.2))
        if program == "with_k6":
            recs.append(SpanRecord(f + 1, f, 1, "visual.low", at * ms,
                                   (at + 100) * ms, low_ms / 1e3))
            kernels += [(at * ms, (at + 20) * ms,
                         "void (anonymous namespace)::conv3d_tf32x3_kernel"
                         f"<2, false, false>(...) {i}") for i in range(5)]
    flops = 3.2e12
    counters = ({"visual.k6_calls": 15, "visual.k6_flops": 3 * flops}
                if program == "with_k6" else {})
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    tr = Trace(False)
    tr.window = (1000 * ms, 2000 * ms)
    tr.kernels = kernels
    view = View(types.SimpleNamespace(config={}), {}, tr)
    low_ms = _reader("visual.low_ms.bulk").read(view)
    roofline = _reader("k6_conv3d_roofline").read(view)
    if program == "parent":
        assert low_ms is None and roofline is None
        return
    assert low_ms == pytest.approx(128.0)  # groups 2 and 3
    # 10 launches in the window, each a fifth of a forward's FLOPs
    assert roofline == pytest.approx(
        100 * 10 * (flops / 5 / peaks.peak("tf32")) / 0.2)
    assert 0 < roofline < 100
