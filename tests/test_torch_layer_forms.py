"""The layer forms that the JAX package's building blocks accept, held
against it on numpy-seeded weights bridged into the port
(``models/bridge.py``'s emitter):

- ``lowering="shift_matmul"`` (the JAX ``ShiftMatmulConv``: stride 1 only,
  the plain convolution's function and parameters) in ``ConvBNAct`` and
  ``ResidualBlockND`` within 1e-5, and the temporal-inconsistency detector,
  which the JAX package builds with it; at stride 2 both packages raise;
- padding as ``(lo, hi)`` pairs per dim, unequal ones included, in
  ``max_pool_same`` and ``ConvBNAct`` within 1e-6 (ints, torch's form,
  still compute the same), and ``int8_conv`` at unequal pairs bit for bit
  as the zero-padded input through the unguarded int8 chain.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from lipsync_tpu.models import layers as jl
from lipsync_tpu.models.artifact import (
    TemporalInconsistencyDetector as JTemporalDetector,
)
from lipsync_tpu_torch.models import layers as pl
from lipsync_tpu_torch.models.artifact import TemporalInconsistencyDetector
from lipsync_tpu_torch.models.bridge import _Emitter
from tests.test_torch_int8_widths import _unguarded
from tests.torch_parity import jax_apply, port_apply

torch.set_num_threads(1)

UNEQUAL_3D = ((0, 1), (2, 1), (1, 0))


def _seeded_variables(module, seed, *inputs):
    """``module``'s variables with every leaf drawn from numpy: fan-in
    scaled kernels, small biases, BatchNorm scales and variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape) / np.sqrt(fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.randn(*leaf.shape) * 0.1  # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.asarray(draw(p, leaf), np.float32), shapes)


def _bridged(variables, emit):
    """The port ``state_dict`` that ``emit(emitter)`` writes from JAX
    ``variables``."""
    e = _Emitter(variables)
    emit(e)
    return e.sd


def _to_cf(x):  # channels-last -> channels-first (numpy)
    return np.moveaxis(x, -1, 1)


def _conv_pair(ks, cin, cout, strides, padding, lowering, seed, x):
    """(JAX ``ConvBNAct``, its variables, the port's on the same
    weights)."""
    jmod = jl.ConvBNAct(cout, ks, strides, padding, use_bias=True,
                        lowering=lowering)
    variables = _seeded_variables(jmod, seed, x)
    port = pl.ConvBNAct(cin, cout, ks, strides, padding, bias=True,
                        lowering=lowering).eval()
    port.load_state_dict(_bridged(variables,
                                  lambda e: e.conv_bn("0", "1", ())))
    return jmod, variables, port


@pytest.mark.parametrize("ks,shape", [((3, 3, 3), (2, 5, 6, 6, 8)),
                                      ((3, 3), (2, 9, 7, 8)),
                                      ((1, 1, 1), (2, 3, 4, 4, 8))])
def test_shift_matmul_conv_bn_act_matches_jax(ks, shape):
    rng = np.random.RandomState(len(ks))
    x = rng.randn(*shape).astype(np.float32)
    padding = [((k - 1) // 2,) * 2 for k in ks]
    jmod, variables, port = _conv_pair(ks, shape[-1], 12, (1,) * len(ks),
                                       padding, "shift_matmul", 1, x)
    want = jax_apply(jmod, variables, x)
    got = port_apply(port, _to_cf(x))
    assert got.shape == _to_cf(want).shape
    np.testing.assert_allclose(got, _to_cf(want), atol=1e-5, rtol=0)
    # The same parameters as the plain convolution, so the same function.
    plain = pl.ConvBNAct(shape[-1], 12, ks, (1,) * len(ks), padding,
                         bias=True).eval()
    plain.load_state_dict(port.state_dict())
    assert list(plain.state_dict()) == list(port.state_dict())
    assert np.array_equal(port_apply(plain, _to_cf(x)), got)


@pytest.mark.parametrize("cin,ks", [(8, (3, 3, 3)), (12, (3, 3, 3)),
                                    (8, (3, 3))])
def test_shift_matmul_residual_block_matches_jax(cin, ks):
    """Without and with the 1x1 shortcut (a change of width)."""
    rng = np.random.RandomState(cin)
    x = rng.randn(2, *(4, 5, 5)[:len(ks)], cin).astype(np.float32)
    jmod = jl.ResidualBlockND(12, ks, (1,) * len(ks), lowering="shift_matmul")
    variables = _seeded_variables(jmod, 2, x)
    port = pl.ResidualBlockND(cin, 12, ks, (1,) * len(ks),
                              lowering="shift_matmul").eval()
    sd = _bridged(variables, lambda e: e.residual_block("b", ()))
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert (port.downsample is None) == (cin == 12)
    want = jax_apply(jmod, variables, x)
    got = port_apply(port, _to_cf(x))
    np.testing.assert_allclose(got, _to_cf(want), atol=1e-5, rtol=0)


def test_temporal_detector_matches_jax():
    """The JAX detector builds both convolutions with the shift_matmul
    lowering; the port's runs the plain ``Conv3d`` on the same weights."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 3, 3, 64).astype(np.float32)
    jmod = JTemporalDetector(64)
    variables = _seeded_variables(jmod, 3, x)
    port = TemporalInconsistencyDetector(64).eval()
    port.load_state_dict(_bridged(variables, lambda e: (
        e.conv_bn("temporal_conv.0", "temporal_conv.1", ("conv1",)),
        e.conv_bn("temporal_conv.3", "temporal_conv.4", ("conv2",)))))
    np.testing.assert_allclose(port_apply(port, x),
                               jax_apply(jmod, variables, x),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("block", ["conv_bn_act", "residual_block"])
def test_shift_matmul_at_stride_2_raises_in_both(block):
    x = np.zeros((1, 4, 6, 6, 8), np.float32)
    if block == "conv_bn_act":
        jmod = jl.ConvBNAct(8, (3, 3, 3), (1, 2, 2), [(1, 1)] * 3,
                            lowering="shift_matmul")
        make = lambda: pl.ConvBNAct(8, 8, (3, 3, 3), (1, 2, 2),  # noqa
                                    (1, 1, 1), lowering="shift_matmul")
    else:
        jmod = jl.ResidualBlockND(8, (3, 3, 3), (1, 2, 2),
                                  lowering="shift_matmul")
        make = lambda: pl.ResidualBlockND(8, 8, (3, 3, 3),  # noqa
                                          (1, 2, 2), lowering="shift_matmul")
    with pytest.raises(AssertionError, match="stride 1"):
        jmod.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="stride 1"):
        make()


def test_an_unknown_lowering_still_raises():
    with pytest.raises(ValueError, match="unknown conv lowering"):
        pl.ConvBNAct(3, 8, (3, 3), (1, 1), (1, 1), lowering="winograd")


POOLS = {  # channels-last input, window, strides, padding
    "unequal_3d": ((2, 5, 9, 8, 3), (2, 3, 3), (1, 2, 2), UNEQUAL_3D),
    "unequal_2d": ((2, 9, 10, 4), (3, 3), (2, 2), ((0, 2), (1, 0))),
    "past_half_window": ((2, 7, 7, 3), (3, 3), (2, 2), ((2, 2), (1, 1))),
    "equal_pairs": ((2, 4, 9, 9, 5), (1, 3, 3), (1, 2, 2),
                    ((0, 0), (1, 1), (1, 1))),
    "ints": ((2, 4, 9, 9, 5), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_max_pool_same_at_padding_forms_matches_jax(name):
    shape, window, strides, padding = POOLS[name]
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    jpad = pl.padding_pairs(padding)
    want = np.asarray(jl.max_pool_same(x, window, strides, jpad))
    got = port_apply(lambda t: pl.max_pool_same(t, window, strides, padding),
                     _to_cf(x))
    assert got.shape == _to_cf(want).shape
    np.testing.assert_allclose(got, _to_cf(want), atol=1e-6, rtol=0)


# The plain convolution within 1e-6; the shift_matmul lowering within its
# own 1e-5 (the JAX side sums its 27 taps as separate matrix products).
@pytest.mark.parametrize("lowering,strides,atol", [
    ("conv", (1, 2, 2), 1e-6), ("shift_matmul", (1, 1, 1), 1e-5)])
def test_conv_bn_act_at_unequal_pairs_matches_jax(lowering, strides, atol):
    x = np.random.RandomState(5).randn(2, 5, 9, 8, 4).astype(np.float32)
    jmod, variables, port = _conv_pair((3, 3, 3), 4, 8, strides, UNEQUAL_3D,
                                       lowering, 5, x)
    assert port[0].padding == (0, 0, 0)
    want = jax_apply(jmod, variables, x)
    got = port_apply(port, _to_cf(x))
    assert got.shape == _to_cf(want).shape
    np.testing.assert_allclose(got, _to_cf(want), atol=atol, rtol=0)


def test_ints_and_equal_pairs_are_the_same_convolution():
    """Equal pairs map to torch's own symmetric padding: the module and its
    output are those of the int form, bit for bit."""
    x = torch.from_numpy(
        np.random.RandomState(6).randn(2, 4, 5, 9, 9).astype(np.float32))
    a = pl.ConvBNAct(4, 8, (3, 7, 7), (1, 2, 2), (1, 3, 3)).eval()
    b = pl.ConvBNAct(4, 8, (3, 7, 7), (1, 2, 2),
                     ((1, 1), (3, 3), (3, 3))).eval()
    b.load_state_dict(a.state_dict())
    assert a[0].padding == b[0].padding == (1, 3, 3)
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,w_shape,stride,padding", [
    ((2, 4, 5, 9, 8), (8, 4, 3, 3, 3), (1, 2, 2), UNEQUAL_3D),
    ((2, 3, 11, 9), (16, 3, 3, 3), (1, 2), ((2, 0), (0, 1))),
])
def test_int8_conv_at_unequal_pairs_is_the_padded_chain(shape, w_shape,
                                                        stride, padding,
                                                        dtype):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(*w_shape) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(w_shape[0]).astype(np.float32))
    got = pl.int8_conv(x, w, b, stride, padding)
    flat = tuple(v for pair in reversed(padding) for v in pair)
    want = _unguarded(F.pad(x, flat), w, b, stride, (0,) * len(padding))
    assert got.dtype == dtype and got.shape == want.shape
    bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
    assert torch.equal(got.contiguous().view(bits),
                       want.contiguous().view(bits))
    # ConvBNAct's int8 lowering takes the same padding.
    module = pl.ConvBNAct(shape[1], w_shape[0], w_shape[2:], stride, padding,
                          bias=True, lowering="int8").eval()
    module.load_state_dict({**module.state_dict(), "0.weight": w,
                            "0.bias": b})
    with torch.no_grad():
        via = module(x.float())
        want32 = _unguarded(F.pad(x.float(), flat), w, b, stride,
                            (0,) * len(padding))
        assert torch.equal(via, module[2](module[1](want32)))
