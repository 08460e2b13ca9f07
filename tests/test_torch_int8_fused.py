"""K4 (the int8 quantize) and K3's dequantizing epilogue, on the CPU, held
against the JAX package and against the unfused torch chain that
``models/layers.py::int8_conv`` ran before them:

- K4's twins (``absmax_plain``, ``quantize_plain``) equal JAX's
  ``max|x|`` and ``clip(round(x / s), -127, 127)`` moved to channels-last,
  bit for bit: fp32 and bf16, 2-d and 3-d, channels-first and
  channels-last memory, exact half-way ties, and a frame range read from a
  non-contiguous slice; the row decomposition that the CUDA absmax reads
  (``_runs``) covers exactly the owned values;
- the dequantizing twin equals the unfused chain ``y.float() * scale (+
  bias)`` cast to the output dtype, bit for bit, and ``int8_conv`` equals
  that whole chain (``chip_smoke.parent_int8_conv``, the yardstick that
  ``chip_smoke.py`` times it against on the card) bit for bit with the same
  strides; it stays
  within 1e-6 relative of JAX's ``Int8Conv`` at ``C_in % 32 == 0``
  geometries (the ones K3 runs on ``wgmma``), with and without bias;
- the geometry picks K3's main loop: 22 of ``ModelConfig()``'s 24 int8
  convolutions take ``wgmma``, the two stems ``halo``
  (``tests/test_torch_int8_stem.py`` holds that loop's host half);
- the wrappers raise on a wrong dtype, ``C_out % 8``, mismatched channels
  or devices, a K past the ``wgmma`` loop's tap table, a halo tile that
  does not fit in shared memory and an unsupported layout; a CPU tensor
  takes the twins and
  launches nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import parent_int8_conv
from lipsync_tpu.models.layers import Int8Conv
from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.models.layers import _INV_127, int8_conv
from lipsync_tpu_torch.ops.kernels import int8_conv as k3
from lipsync_tpu_torch.ops.kernels import int8_quant as k4

torch.set_num_threads(1)

TIES = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]
SHAPES = {2: (2, 32, 7, 6), 3: (2, 32, 3, 5, 6)}  # (N, C, *spatial)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]).numpy()


def _activation(shape, dtype, layout, seed, ties=True):
    """A channels-first activation with max|x| = 127 (so the scale is 1 and
    ``TIES`` sit exactly half-way), in ``dtype`` and ``layout``."""
    rng = np.random.RandomState(seed)
    x = np.clip(rng.randn(*shape) * 30, -126, 126).astype(np.float32)
    if ties:
        x.reshape(-1)[:len(TIES)] = TIES
    t = torch.from_numpy(x).to(dtype)
    if layout == "channels_last":
        t = t.movedim(1, -1).contiguous().movedim(-1, 1)
    return t


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_twin_matches_jax(dtype, nd, layout):
    x = _activation(SHAPES[nd], dtype, layout, seed=nd)
    assert k4.layout_of(x) == layout
    x32 = x.float().numpy()
    # The JAX package's scale, compiled as it runs (a product with the
    # float32 reciprocal of 127), and its quantization.
    j_scale = jax.jit(lambda a: jnp.maximum(jnp.max(jnp.abs(a)) / 127.0,
                                            1e-12))(jnp.asarray(x32))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x32) / j_scale),
                               -127, 127).astype(jnp.int8))
    scale = torch.clamp(k4.absmax(x) * _INV_127, min=1e-12)
    np.testing.assert_array_equal(_bits(scale), np.asarray(j_scale).view(
        np.int32))
    assert float(scale) == 1.0
    got = k4.quantize(x, scale)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, 1, -1))
    # Half-way ties round to even, as jnp.round and torch.round do.
    first = got.movedim(-1, 1).reshape(-1)[:len(TIES)].tolist()
    assert first == [127, -127, 0, 2, 2, 0, -2, -2, 126, -126, 4]


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absmax_over_a_frame_range_matches_jax(dtype, layout):
    """A frame shard's scale counts only the frames it owns: the owned
    slice of a 3-d activation is not contiguous, and is read in place."""
    x = _activation(SHAPES[3], dtype, layout, seed=5, ties=False)
    x[:, :, 0] *= 50  # the largest values lie outside the owned frames
    lo, hi = 1, 3
    owned = x[:, :, lo:hi]
    assert not owned.is_contiguous()
    x32 = x.float().numpy()
    want = np.asarray(jnp.max(jnp.abs(jnp.asarray(x32)[:, :, lo:hi])))
    got = k4.absmax(x, (lo, hi))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))
    assert float(got) < float(k4.absmax(x))


def _enumerate_runs(t: torch.Tensor) -> np.ndarray:
    """The values that the CUDA absmax reads for ``t``: ``_runs(t)``'s
    rows, gathered from ``t``'s storage."""
    ra, sa, rb, sb, length = k4._runs(t)
    base = torch.as_strided(t, (t.untyped_storage().nbytes()
                                // t.element_size() - t.storage_offset(),),
                            (1,), t.storage_offset())
    idx = (np.arange(ra)[:, None, None] * sa + np.arange(rb)[None, :, None]
           * sb + np.arange(length)[None, None, :]).reshape(-1)
    return base[torch.from_numpy(idx)].numpy()


@pytest.mark.parametrize("view", ["full_cf", "full_cl", "frames_cf",
                                  "frames_cl", "shard_of_track", "2d_cl"])
def test_absmax_rows_cover_exactly_the_owned_values(view):
    rng = np.random.RandomState(9)
    cl = torch.from_numpy(rng.randn(2, 4, 5, 3, 6).astype(np.float32))
    cf = cl.movedim(-1, 1).contiguous()  # (2, 6, 4, 5, 3)
    owned = {
        "full_cf": cf,
        "full_cl": cl.movedim(-1, 1),
        "frames_cf": cf[:, :, 1:3],
        "frames_cl": cl.movedim(-1, 1)[:, :, 1:3],
        # the engine's frame shard of a track: (B, T, H, W, 3) frames
        # [lo, hi) permuted to channels-first
        "shard_of_track": cl[:, 1:4].movedim(-1, 1),
        "2d_cl": cl[:, 0].movedim(-1, 1),
    }[view]
    assert k4._runs(owned) is not None
    np.testing.assert_array_equal(np.sort(_enumerate_runs(owned)),
                                  np.sort(owned.reshape(-1).numpy()))


CONVS = {  # channels-last x, (C_out, *k, C_in), stride, padding
    "3d_c32": ((2, 3, 7, 6, 32), (32, 3, 3, 3, 32), (1, 2, 2), (1, 1, 1)),
    "2d_c64": ((2, 9, 5, 64), (64, 3, 3, 64), (2, 1), (1, 1)),
    "3d_stem": ((2, 4, 12, 12, 3), (8, 3, 7, 7, 3), (1, 2, 2), (1, 3, 3)),
    "down_1x1x1": ((2, 2, 6, 6, 32), (64, 1, 1, 1, 32), (1, 2, 2),
                   (0, 0, 0)),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_twin_equals_unfused_chain(dtype, bias):
    x_shape, w_shape, stride, pad = CONVS["3d_c32"]
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randint(-127, 128, x_shape).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, w_shape).astype(np.int8))
    scale = torch.from_numpy((rng.rand(w_shape[0]) * 1e-4).astype(
        np.float32))
    b = (torch.from_numpy(rng.randn(w_shape[0]).astype(np.float32))
         if bias else None)
    got = k3.int8_conv_dequant(x, w, scale, b, dtype, stride, pad)
    want = k3.int8_conv_int32(x, w, stride, pad).float() * scale
    if bias:
        want = want + b
    want = want.to(dtype)
    assert got.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", ["3d_c32", "2d_c64", "3d_stem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_equals_the_unfused_chain(dtype, name, bias):
    x_shape, w_shape, stride, pad = CONVS[name]
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(*x_shape).astype(np.float32)).to(
        dtype).movedim(-1, 1)
    w = torch.from_numpy((rng.randn(*w_shape) * 0.1).astype(
        np.float32)).movedim(-1, 1)
    b = (torch.from_numpy(rng.randn(w_shape[0]).astype(np.float32))
         if bias else None)
    got = int8_conv(x, w, b, stride, pad)
    want = parent_int8_conv(x, w, b, stride, pad)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape and got.stride() == want.stride()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", ["3d_c32", "2d_c64", "down_1x1x1"])
def test_int8_conv_matches_jax_int8conv(name, bias):
    """At the geometries that K3 runs on wgmma, within the tolerance of
    ``test_torch_serving_options.py::test_int8_conv_matches_jax_int8conv``
    (1e-6 relative)."""
    x_shape, w_shape, stride, pad = CONVS[name]
    rng = np.random.RandomState(17)
    x = rng.randn(*x_shape).astype(np.float32)
    w = (rng.randn(*w_shape) * 0.1).astype(np.float32)  # (O, k..., I)
    b = rng.randn(w_shape[0]).astype(np.float32) if bias else None
    params = {"kernel": np.moveaxis(w, 0, -1)}
    if bias:
        params["bias"] = b
    want = np.asarray(Int8Conv(
        w_shape[0], w_shape[1:-1], stride, [(p, p) for p in pad],
        use_bias=bias).apply({"params": params}, jnp.asarray(x)))
    got = int8_conv(torch.from_numpy(x).movedim(-1, 1),
                    torch.from_numpy(w).movedim(-1, 1),
                    None if b is None else torch.from_numpy(b), stride,
                    pad).movedim(1, -1).numpy()
    assert k3.main_loop(x_shape, w_shape) == "wgmma"
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-6, rel


def test_main_loop_follows_the_geometry():
    cfg = dataclasses.replace(ModelConfig(), conv_lowering="int8")
    convs = [m[0] for m in LipSyncModel(cfg).modules()
             if isinstance(m, layers_mod.ConvBNAct) and m.lowering == "int8"]
    loops = []
    for conv in convs:
        w = conv.weight.movedim(1, -1)  # (C_out, *k, C_in)
        loops.append(k3.main_loop((1, *[8] * (w.dim() - 2), w.shape[-1]),
                                  w.shape))
    assert len(loops) == 24
    assert loops.count("wgmma") == 22
    assert sorted(c.in_channels for c, lp in zip(convs, loops)
                  if lp == "halo") == [1, 3]


def _i8(*shape):
    return torch.zeros(shape, dtype=torch.int8)


GUARDS = {
    "k3_float_input": (lambda: k3.int8_conv_int32(
        torch.zeros(1, 4, 4, 32), _i8(8, 3, 3, 32), (1, 1), (1, 1)),
        TypeError),
    "k3_cout_not_multiple_of_8": (lambda: k3.int8_conv_int32(
        _i8(1, 4, 4, 32), _i8(12, 3, 3, 32), (1, 1), (1, 1)), ValueError),
    "k3_channels_differ": (lambda: k3.int8_conv_int32(
        _i8(1, 4, 4, 32), _i8(8, 3, 3, 16), (1, 1), (1, 1)), ValueError),
    "k3_devices_differ": (lambda: k3.int8_conv_int32(
        _i8(1, 4, 4, 32), _i8(8, 3, 3, 32).to("meta"), (1, 1), (1, 1)),
        ValueError),
    "k3_k_past_the_wgmma_tap_table": (lambda: k3.int8_conv_int32(
        _i8(1, 4, 4, 4, 512), _i8(8, 3, 3, 3, 512), (1, 1, 1), (1, 1, 1)),
        ValueError),
    "k3_halo_past_shared_memory": (lambda: k3.int8_conv_int32(
        _i8(1, 4, 12, 12, 12), _i8(8, 7, 7, 7, 12), (1, 1, 1), (3, 3, 3)),
        ValueError),
    "k3_int_out_dtype": (lambda: k3.int8_conv_dequant(
        _i8(1, 4, 4, 32), _i8(8, 3, 3, 32), torch.ones(8), None,
        torch.int32, (1, 1), (1, 1)), TypeError),
    "k3_scale_shape": (lambda: k3.int8_conv_dequant(
        _i8(1, 4, 4, 32), _i8(8, 3, 3, 32), torch.ones(16), None,
        torch.float32, (1, 1), (1, 1)), ValueError),
    "k3_bias_dtype": (lambda: k3.int8_conv_dequant(
        _i8(1, 4, 4, 32), _i8(8, 3, 3, 32), torch.ones(8),
        torch.ones(8, dtype=torch.float64), torch.float32, (1, 1), (1, 1)),
        ValueError),
    "k4_int8_input": (lambda: k4.absmax(_i8(1, 8, 4, 4)), TypeError),
    "k4_rank": (lambda: k4.absmax(torch.ones(2, 8, 4)), ValueError),
    "k4_scale_dtype": (lambda: k4.quantize(
        torch.ones(1, 8, 4, 4), torch.ones((), dtype=torch.float64)),
        ValueError),
    "k4_scale_device": (lambda: k4.quantize(
        torch.ones(1, 8, 4, 4), torch.ones((), device="meta")), ValueError),
    "k4_layout": (lambda: k4.layout_of(
        torch.ones(2, 8, 4, 6).transpose(2, 3)), ValueError),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_wrappers_raise(name):
    fn, exc = GUARDS[name]
    with pytest.raises(exc):
        fn()


def test_cpu_tensors_take_the_twins_and_launch_nothing(monkeypatch):
    monkeypatch.setattr(k3, "launches", 0)
    monkeypatch.setattr(k4, "launches", 0)
    x_shape, w_shape, stride, pad = CONVS["3d_c32"]
    x = torch.randn(*x_shape).movedim(-1, 1)
    w = torch.randn(*w_shape).movedim(-1, 1)
    out = int8_conv(x, w, torch.randn(w_shape[0]), stride, pad)
    assert torch.isfinite(out).all()
    assert k3.launches == 0 and k4.launches == 0
    assert k3.launches_by_device.get("cpu", 0) == 0
    assert k4.launches_by_device.get("cpu", 0) == 0
