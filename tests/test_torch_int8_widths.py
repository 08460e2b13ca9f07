"""The int8 lowering at encoder widths that K3 refuses as they are, on the
CPU at the ``small_model_config`` geometry (8 frames of 48 x 48, so layer4
runs on 3 x 3 and 2 x 2 maps):

- ``C_out = 100`` (K3 writes C_out in multiples of 8), ``C_in = 320`` at
  3 x 3 x 3 (a ``wgmma`` K past the loop's tap table) and ``C_in = 200``
  at 3 x 3 x 3 (a halo tile past shared memory): K3's entries still refuse
  each shape, and ``layers.int8_conv`` computes each within 1e-6 relative
  of JAX's ``Int8Conv`` and bit for bit as the same chain without the
  guards (the int8 operands convolved in float64, then ``acc.float() *
  (x_scale * w_scale) (+ bias)`` cast to the input's dtype);
- the port's int8 ``LipSyncModel`` at ``visual_feature_dim`` 100, 200 and
  320 runs at the ``small_model_config`` geometry, bit for bit as the same
  model with every int8 convolution computed by that unguarded chain; and
  on the narrow parity configuration (``tests/torch_parity.py``, 32 x 32
  crops, where layer4 takes each of the three reshapes) its logits stay
  within 1e-4 of the JAX int8 model's on the same bridged weights.
  Those inputs are drawn with seed 2: with seed 0 one activation at width
  200 (1.05e-2 in a logit), and with seed 1 one at widths 200 and 256,
  the default (7.7e-4), land within an ulp of a quantization half step,
  where XLA's and torch's fp32 rounding of the BatchNorm before it put it
  on opposite sides; the bit-equality above is what holds the reshapes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from lipsync_tpu.models import LipSyncModel as JModel
from lipsync_tpu.models.layers import Int8Conv
from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models import layers as layers_mod
from lipsync_tpu_torch.models.layers import _INV_127, int8_conv
from lipsync_tpu_torch.ops.kernels import int8_conv as k3
from lipsync_tpu_torch.ops.kernels.int8_quant import quantize_int8
from tests.torch_parity import jax_apply, port_apply, seeded_pair

torch.set_num_threads(1)

CONVS = {  # channels-last x, (C_out, *k, C_in), stride, padding; and how
    # layers.int8_conv reshapes it for K3: (groups, channels a group)
    "cout_100": ((2, 8, 3, 3, 256), (100, 3, 3, 3, 256), (1, 2, 2),
                 (1, 1, 1), (1, 256)),
    "cin_320": ((2, 8, 2, 2, 320), (320, 3, 3, 3, 320), (1, 1, 1),
                (1, 1, 1), (2, 160)),
    "cin_200": ((2, 8, 2, 2, 200), (200, 3, 3, 3, 200), (1, 1, 1),
                (1, 1, 1), (1, 224)),
}


def _operands(name, seed, dtype=torch.float32, bias=False):
    x_shape, w_shape, stride, pad, _ = CONVS[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(*x_shape).astype(np.float32)
    w = (rng.randn(*w_shape) * 0.05).astype(np.float32)  # (O, k..., I)
    b = rng.randn(w_shape[0]).astype(np.float32) if bias else None
    return x, w, b, stride, pad


def _port(x, w, b, stride, pad, dtype=torch.float32):
    return int8_conv(torch.from_numpy(x).to(dtype).movedim(-1, 1),
                     torch.from_numpy(w).movedim(-1, 1),
                     None if b is None else torch.from_numpy(b), stride,
                     pad)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_k3_refuses_the_shape_as_it_is(name):
    x_shape, w_shape, stride, pad, how = CONVS[name]
    x = torch.zeros(x_shape, dtype=torch.int8)
    w = torch.zeros(w_shape, dtype=torch.int8)
    with pytest.raises(ValueError):
        k3.int8_conv_int32(x, w, stride, pad)
    assert layers_mod._k3_geometry(x_shape, (-(-w_shape[0] // 8) * 8,
                                             *w_shape[1:]),
                                   stride, pad) == how


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_matches_jax_int8conv(name, bias):
    x, w, b, stride, pad = _operands(name, seed=31, bias=bias)
    params = {"kernel": np.moveaxis(w, 0, -1)}
    if bias:
        params["bias"] = b
    want = np.asarray(Int8Conv(
        w.shape[0], w.shape[1:-1], stride, [(p, p) for p in pad],
        use_bias=bias).apply({"params": params}, jnp.asarray(x)))
    got = _port(x, w, b, stride, pad).movedim(1, -1).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_equals_the_chain_without_guards(name, dtype, bias):
    x, w, b, stride, pad = _operands(name, seed=37, bias=bias)
    xt = torch.from_numpy(x).to(dtype).movedim(-1, 1)
    wt = torch.from_numpy(w).movedim(-1, 1)
    x32, w32 = xt.float(), wt.float()
    w_scale = torch.clamp(w32.abs().amax(dim=(1, 2, 3, 4)) * _INV_127,
                          min=1e-12)
    x_scale = torch.clamp(x32.abs().max() * _INV_127, min=1e-12)
    x_q = quantize_int8(x32, x_scale)
    w_q = quantize_int8(w32, w_scale.view(-1, 1, 1, 1, 1))
    acc = F.conv3d(x_q.double(), w_q.double(), stride=stride,
                   padding=pad).to(torch.int32)
    want = acc.float() * (x_scale * w_scale).view(1, -1, 1, 1, 1)
    if bias:
        want = want + torch.from_numpy(b).view(1, -1, 1, 1, 1)
    want = want.to(dtype)
    got = _port(x, w, b, stride, pad, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
    assert torch.equal(got.contiguous().view(bits),
                       want.contiguous().view(bits))


def _unguarded(x, weight, bias, stride, padding):
    """The int8 convolution as one float64 convolution of the int8 values,
    dequantized by the torch chain, written channels-last like
    ``int8_conv``."""
    x32, w32 = x.float(), weight.float()
    dims = tuple(range(1, w32.dim()))
    w_scale = torch.clamp(w32.abs().amax(dim=dims) * _INV_127, min=1e-12)
    x_scale = torch.clamp(x32.abs().max() * _INV_127, min=1e-12)
    shape = (-1,) + (1,) * (w32.dim() - 1)
    conv = F.conv3d if x.dim() == 5 else F.conv2d
    acc = conv(quantize_int8(x32, x_scale).double(),
               quantize_int8(w32, w_scale.view(shape)).double(),
               stride=tuple(stride), padding=tuple(padding)).to(torch.int32)
    per_channel = (1, -1) + (1,) * (x.dim() - 2)
    out = acc.float() * (x_scale * w_scale).view(per_channel)
    if bias is not None:
        out = out + bias.float().view(per_channel)
    return out.to(x.dtype).movedim(1, -1).contiguous().movedim(-1, 1)


@pytest.mark.parametrize("width", [100, 200, 320])
def test_int8_model_at_width_equals_the_unguarded_chain(width, monkeypatch):
    cfg = ModelConfig(video_frames=8, crop_size=48, audio_frames=32,
                      visual_feature_dim=width, conv_lowering="int8")
    torch.manual_seed(width)
    model = LipSyncModel(cfg).eval()
    rng = np.random.RandomState(0)
    video = torch.from_numpy(rng.rand(2, 8, 48, 48, 3).astype(np.float32))
    audio = torch.from_numpy((rng.rand(2, 80, 32, 1) * 80 - 80).astype(
        np.float32))
    with torch.no_grad():
        got = model(video, audio)
        monkeypatch.setattr(layers_mod, "int8_conv", _unguarded)
        want = model(video, audio)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(2)
    return (rng.rand(2, 8, 32, 32, 3).astype(np.float32),
            (rng.rand(2, 80, 32, 1) * 80 - 80).astype(np.float32))


@pytest.mark.parametrize("width", [100, 200, 320])
def test_int8_model_at_width_matches_jax(width, inputs):
    model, cfg, variables, jcfg = seeded_pair(3, visual_feature_dim=width)
    over = dict(conv_lowering="int8")
    port = LipSyncModel(dataclasses.replace(cfg, **over)).eval()
    port.load_state_dict(model.state_dict(), strict=True)
    got = port_apply(port, *inputs)
    want = jax_apply(JModel(dataclasses.replace(jcfg, **over)), variables,
                     *inputs)
    assert got.shape == want.shape == (2,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
