"""K4's single launch (``ops/kernels/int8_quant.py::absmax_quantize``) on
the CPU:

- its twin equals JAX's jitted scale and quantization bit for bit (fp32
  and bf16, 2-d and 3-d, channels-first and channels-last memory, exact
  half-way ties), and its scale vector JAX's ``x_scale * w_scale``; the
  scale is NaN for an input that holds a NaN and +inf for one that holds
  +-inf, as JAX's;
- the launch plan (``fused_plan``) is a pure function of the geometry,
  and over odd shapes, both layouts, both element sizes, misaligned data
  and strided rows it has Phase A read every value exactly once (kept in
  shared memory or streamed) and Phase B write every int8 value exactly
  once; a numpy model of the kernel that follows the plan's addressing
  gives the twin's bytes;
- the kernel's quotient (the scale's correctly rounded reciprocal and two
  FMA corrections, modelled exactly with fractions) is float32's ``v /
  s`` bit for bit, on random values and a few ulps around half steps;
- ``layers.int8_conv`` takes the single launch outside a mesh and the
  two-launch ``absmax`` + ``quantize`` under ``Lockstep`` and
  ``owning_frames`` (the CPU launches nothing).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.ops.kernels import int8_quant as k4
from lipsync_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

TIES = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]
SHAPES = {2: (2, 32, 7, 6), 3: (2, 32, 3, 5, 6)}  # (N, C, *spatial)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]).numpy()


def _activation(shape, dtype, layout, seed, ties=True):
    """A channels-first activation with max|x| = 127 (scale 1, so ``TIES``
    sit exactly half-way), in ``dtype`` and ``layout``."""
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(*shape) * 30, -126, 126).astype(np.float32)
    if ties:
        x.reshape(-1)[:len(TIES)] = TIES
    t = torch.from_numpy(x).to(dtype)
    if layout == "channels_last":
        t = t.movedim(1, -1).contiguous().movedim(-1, 1)
    return t


_J_SCALE = jax.jit(lambda a: jnp.maximum(jnp.max(jnp.abs(a)) / 127.0, 1e-12))


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_jax(dtype, nd, layout):
    x = _activation(SHAPES[nd], dtype, layout, seed=nd + 20)
    assert k4.layout_of(x) == layout
    x32 = jnp.asarray(x.float().numpy())
    w_scale = np.random.RandomState(nd).rand(11).astype(np.float32) * 1e-2
    j_scale = _J_SCALE(x32)
    want = np.asarray(jnp.clip(jnp.round(x32 / j_scale), -127, 127).astype(
        jnp.int8))
    j_vec = np.asarray(jax.jit(lambda s, w: s * w)(j_scale,
                                                   jnp.asarray(w_scale)))
    q, x_scale, scale = k4.absmax_quantize(x, torch.from_numpy(w_scale))
    assert x_scale.dim() == 0 and x_scale.dtype == torch.float32
    np.testing.assert_array_equal(_bits(x_scale),
                                  np.asarray(j_scale).view(np.int32))
    assert float(x_scale) == 1.0
    assert q.dtype == torch.int8 and q.is_contiguous()
    np.testing.assert_array_equal(q.numpy(), np.moveaxis(want, 1, -1))
    np.testing.assert_array_equal(_bits(scale), j_vec.view(np.int32))
    first = q.movedim(-1, 1).reshape(-1)[:len(TIES)].tolist()
    assert first == [127, -127, 0, 2, 2, 0, -2, -2, 126, -126, 4]
    # Without w_scale there is no scale vector.
    q2, s2, none = k4.absmax_quantize(x)
    assert none is None and torch.equal(q2, q) and torch.equal(s2, x_scale)


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_of_non_finite_input(dtype, value):
    """NaN stays NaN (``torch.clamp`` keeps it where ``fmaxf`` would not),
    and an infinite value gives an infinite scale, as JAX computes them."""
    x = _activation(SHAPES[3], torch.float32, "channels_last", seed=3,
                    ties=False)
    x[1, 4, 2, 3, 1] = value
    x = x.to(dtype)
    want = np.asarray(_J_SCALE(jnp.asarray(x.float().numpy())))
    q, x_scale, scale = k4.absmax_quantize(x, torch.ones(4))
    if np.isnan(value):
        assert torch.isnan(x_scale) and np.isnan(want)
    else:
        assert float(x_scale) == float(want) == float("inf")
    assert torch.equal(scale.isnan(), x_scale.isnan().expand(4))
    assert q.shape == (2, 3, 5, 6, 32)


def _blocks(mode, smem):
    """A card that fits two blocks an SM up to 112 KB, one above."""
    return 2 if smem <= 112 * 1024 else 1


PLAN_CASES = {  # (N, C, *spatial), layout, element size, aligned, SMs,
    # and the mode the plan must pick
    "cl_fp32_flat": ((3, 32, 5, 13, 11), "channels_last", 4, True, 7, 0),
    "cl_bf16_flat_tail": ((2, 3, 3, 9, 10), "channels_last", 2, True, 5,
                          0),
    "cl_fp32_c1_tail": ((3, 1, 11, 9), "channels_last", 4, True, 4, 0),
    "cl_fp32_misaligned": ((2, 32, 5, 7), "channels_last", 4, False, 3, 1),
    "cl_bf16_rows": ((4, 32, 6, 7), "channels_last", 2, True, 6, 0),
    "cl_fp32_rows_odd": ((4, 3, 5, 3), "channels_last", 4, True, 6, 1),
    "cl_fp32_one_value": ((1, 3, 1, 1), "channels_last", 4, True, 132, 0),
    "cf_fp32_c3": ((2, 3, 3, 9, 10), "channels_first", 4, True, 3, 2),
    "cf_bf16_c40": ((3, 40, 7, 5), "channels_first", 2, True, 5, 2),
    "cf_fp32_c96": ((2, 96, 7, 5), "channels_first", 4, True, 132, 2),
    "cf_bf16_c5_long": ((1, 5, 3, 9, 300), "channels_first", 2, True, 4,
                        2),
}


def _tensor(shape, layout, size, aligned, case):
    """A tensor of this geometry: ``rows`` cases leave a gap between
    samples, ``misaligned`` ones start one value into their storage."""
    n, c, sp = shape[0], shape[1], shape[2:]
    dtype = torch.float32 if size == 4 else torch.bfloat16
    rng = np.random.RandomState(len(case))
    if layout == "channels_first":
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dtype)
    count = int(np.prod(shape))
    if not aligned:
        base = torch.from_numpy(rng.randn(count + 1).astype(np.float32))
        return base.to(dtype)[1:].view(n, *sp, c).movedim(-1, 1)
    if "rows" in case:
        big = torch.from_numpy(rng.randn(n, 2, *sp, c).astype(np.float32))
        return big.to(dtype)[:, 0].movedim(-1, 1)
    return torch.from_numpy(rng.randn(n, *sp, c).astype(np.float32)).to(
        dtype).movedim(-1, 1)


def _plan_of(x, case):
    _, layout, size, aligned, sms, _ = PLAN_CASES[case]
    assert k4.layout_of(x) == layout and x.element_size() == size
    assert (x.data_ptr() % 16 == 0) == aligned
    return k4.fused_plan(tuple(x.shape), x.stride(), layout, size, aligned,
                         sms, _blocks)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_is_a_pure_function(case):
    x = _tensor(*PLAN_CASES[case][:4], case)
    plan = _plan_of(x, case)
    assert plan == _plan_of(x.clone() if "rows" not in case
                            and "misaligned" not in case else x, case)
    assert plan.grid == _blocks(plan.mode, plan.smem) * PLAN_CASES[case][4]
    scratch = plan.unit_bytes if plan.mode == 2 else 0
    assert plan.smem == plan.cap * plan.unit_bytes + scratch
    assert plan.smem <= k4.KEEP_BYTES
    assert plan.mode == PLAN_CASES[case][5]


def _storage_offsets(x):
    """Offsets of ``x``'s values from its first one, in (N, C, *spatial)
    order."""
    idx = np.zeros(x.shape, dtype=np.int64)
    for d, (n, st) in enumerate(zip(x.shape, x.stride())):
        idx += (np.arange(n) * st).reshape([-1 if i == d else 1
                                            for i in range(x.dim())])
    return idx


def _phases(plan):
    """Units in the kernel's order: Phase A per block (the share, the kept
    ones first) and Phase B per block (the streamed ones from the last,
    then the kept ones), with the tail as unit ``plan.units`` of the last
    block in both."""
    a, bph = [], []
    for b in range(plan.grid):
        u0, u1 = plan.share(b)
        k0, k1 = plan.kept(b)
        assert (k0, k1 - k0) == (u0, min(u1 - u0, plan.cap))
        a += list(range(u0, u1))
        bph += list(range(u1 - 1, k1 - 1, -1)) + list(range(k0, k1))
        if b == plan.grid - 1 and plan.tail:
            a.append(plan.units)
            bph.append(plan.units)
    return a, bph


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_reads_and_writes_every_value_once(case):
    x = _tensor(*PLAN_CASES[case][:4], case)
    plan = _plan_of(x, case)
    phase_a, phase_b = _phases(plan)
    read = np.concatenate([k4.unit_values(plan, u)[0] for u in phase_a])
    wrote = np.concatenate([k4.unit_values(plan, u)[1] for u in phase_b])
    owned = _storage_offsets(x).reshape(-1)
    np.testing.assert_array_equal(np.sort(read), np.sort(owned))
    np.testing.assert_array_equal(np.sort(wrote), np.arange(x.numel()))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_model_gives_the_twins_bytes(case):
    """The kernel's data flow in numpy: values read at the plan's input
    offsets (from the tensor's storage), max|x| over them, and each unit
    quantized to the plan's output offsets; equal to the twin."""
    x = _tensor(*PLAN_CASES[case][:4], case)
    plan = _plan_of(x, case)
    storage = torch.as_strided(x, (int(_storage_offsets(x).max()) + 1,),
                               (1,)).float().numpy()
    phase_a, phase_b = _phases(plan)
    m = max(float(np.abs(storage[k4.unit_values(plan, u)[0]]).max())
            for u in phase_a)
    s = max(np.float32(m) * np.float32(k4.INV_127), np.float32(1e-12))
    out = np.full(x.numel(), 99, dtype=np.int8)
    for u in phase_b:
        src, dst = k4.unit_values(plan, u)
        out[dst] = np.clip(np.rint(storage[src] / s), -127, 127)
    q, x_scale, _ = k4.absmax_quantize(x)
    assert np.float32(s) == float(x_scale)
    np.testing.assert_array_equal(out.reshape(q.shape), q.numpy())


def _rn32(q: Fraction) -> np.float32:
    """``q`` rounded once to the nearest float32, ties to even (normal
    range)."""
    if q == 0:
        return np.float32(0.0)
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    e += (q >= Fraction(2) ** (e + 1)) - (q < Fraction(2) ** e)
    scaled = q * Fraction(2) ** (23 - e)
    n = scaled.numerator // scaled.denominator
    rem = scaled - n
    n += rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2 == 1)
    return np.float32(sign * n * 2.0 ** (e - 23))


def _fma(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_reciprocal_quotient_is_the_ieee_quotient():
    """``csrc/int8_quant.cu::quant_by``: r = RN(1 / s), q = RN(v r), then
    twice q = RN(q + r RN(v - s q)); each FMA rounds once."""
    rng = np.random.default_rng(0)
    for _ in range(12):
        m = np.float32(rng.uniform(0.01, 300) * 10.0 ** rng.integers(-6, 6))
        s = np.float32(m * np.float32(k4.INV_127))
        r = _rn32(1 / Fraction(float(s)))
        values = list((rng.uniform(-1, 1, 60) * m).astype(np.float32))
        for k in rng.integers(-127, 127, 20):
            half = np.float32((k + 0.5) * float(s))
            values += [half, np.nextafter(half, np.float32(np.inf)),
                       np.nextafter(half, np.float32(-np.inf)),
                       np.float32(half + 2 * np.spacing(half)),
                       np.float32(half - 2 * np.spacing(half))]
        for v in values:
            q = np.float32(v) * r
            q = _fma(r, _fma(-s, q, v), q)
            q = _fma(r, _fma(-s, q, v), q)
            assert q == np.float32(v) / s, (v, s)


def _counted(monkeypatch):
    calls = {"absmax_quantize": 0, "absmax": 0, "quantize": 0}
    for name in calls:
        real = getattr(layers_mod, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(layers_mod, name, wrapped)
    return calls


def _conv_args(seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, 32, 4, 6, 6).astype(np.float32))
    w = torch.from_numpy((rng.randn(16, 32, 3, 3, 3) * 0.1).astype(
        np.float32))
    return x, w, None, (1, 1, 1), (1, 1, 1)


def test_int8_conv_takes_the_single_launch_outside_a_mesh(monkeypatch):
    monkeypatch.setattr(k4, "launches", 0)
    calls = _counted(monkeypatch)
    out = layers_mod.int8_conv(*_conv_args())
    assert calls == {"absmax_quantize": 1, "absmax": 0, "quantize": 0}
    assert torch.isfinite(out).all() and k4.launches == 0
    assert not mesh_lib.in_lockstep() and mesh_lib.frame_core() is None


def test_int8_conv_takes_the_pair_inside_owning_frames(monkeypatch):
    calls = _counted(monkeypatch)
    x, *rest = _conv_args()
    with mesh_lib.owning_frames(1, 3):
        got = layers_mod.int8_conv(x, *rest)
    assert calls == {"absmax_quantize": 0, "absmax": 1, "quantize": 1}
    # The owned frames' scale: not the whole tensor's when the largest
    # value lies outside them.
    x2 = x.clone()
    x2[:, :, 0] *= 50
    with mesh_lib.owning_frames(1, 3):
        sharded = layers_mod.int8_conv(x2, *rest)
    whole = layers_mod.int8_conv(x2, *rest)
    assert not torch.equal(sharded[:, :, 1:3], whole[:, :, 1:3])
    assert torch.isfinite(got).all()


def test_int8_conv_takes_the_pair_under_lockstep(monkeypatch):
    calls = _counted(monkeypatch)
    x, *rest = _conv_args(1)
    x[1] *= 20  # the second shard holds the larger values
    seen = []

    def shard(i):
        def run():
            seen.append(mesh_lib.in_lockstep())
            return layers_mod.int8_conv(x[i:i + 1], *rest)
        return run

    outs = mesh_lib.Lockstep(2).run([shard(0), shard(1)])
    assert seen == [True, True]
    assert calls == {"absmax_quantize": 0, "absmax": 2, "quantize": 2}
    # Each shard quantized with the scale of both: the same as the whole
    # batch in one tensor, and not as the first shard alone.
    assert torch.equal(torch.cat(outs), layers_mod.int8_conv(x, *rest))
    assert not torch.equal(outs[0], layers_mod.int8_conv(x[:1], *rest))


GUARDS = {
    "int8_input": (lambda: k4.absmax_quantize(
        torch.zeros(1, 8, 4, 4, dtype=torch.int8)), TypeError),
    "rank": (lambda: k4.absmax_quantize(torch.ones(2, 8, 4)), ValueError),
    "w_scale_dtype": (lambda: k4.absmax_quantize(
        torch.ones(1, 8, 4, 4), torch.ones(8, dtype=torch.float64)),
        ValueError),
    "w_scale_device": (lambda: k4.absmax_quantize(
        torch.ones(1, 8, 4, 4), torch.ones(8, device="meta")), ValueError),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_single_launch_raises(name):
    fn, exc = GUARDS[name]
    with pytest.raises(exc):
        fn()
