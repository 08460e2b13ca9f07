"""The port's single-card serving options against the JAX package's, on the
CPU in fp32 at small geometry, on the same numpy-seeded weights:

- ``shared_visual_encoding``: the engine's track scores within 1e-5 of the
  JAX engine's on multi-window tracks (the interior windows' padding
  deviation included), and a one-window track equal to the per-window path;
- ``fold_hf_stem``: the folded ``HighFrequencyDetector`` and the folded
  model within 1e-5 of the JAX package's (highest matmul precision), the
  state dict unchanged, and the fold-vs-unfolded bounds of
  ``tests/test_ops.py`` held by the port;
- ``quantized_int8``: quantized tensors equal to JAX's (half-way ties
  included), K3's twin equal to JAX's int32 convolution bit for bit, one
  quantized convolution within 1e-6 relative of JAX's ``Int8Conv``, and a
  window's result moving with its batch-mates exactly as JAX's does; the
  scales equal to the compiled JAX package's bit for bit (XLA turns its
  ``/ 127.0`` into a product with the float32 reciprocal, and one scale
  rounded the other way flips a weight that sits near a half step); the
  int8 audio encoder within 1e-5 of JAX's and the int8 model's logits
  within 1e-4, each far nearer JAX's int8 result than the fp32 one;
- ``load_engine(None)`` with ``MODEL_PATH`` in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.engine import load_engine as j_load_engine
from lipsync_tpu.models import LipSyncModel as JModel
from lipsync_tpu.models.audio_encoder import AudioEncoder as JAudio
from lipsync_tpu.models.artifact import HighFrequencyDetector as JHF
from lipsync_tpu.models.layers import Int8Conv
from lipsync_tpu.models.visual_encoder import VisualEncoder as JVisual
from lipsync_tpu_torch.inference.engine import ScoringEngine, load_engine
from lipsync_tpu_torch.models import LipSyncModel
from lipsync_tpu_torch.models.artifact import HighFrequencyDetector
from lipsync_tpu_torch.models.layers import (
    _INV_127,
    int8_conv,
    quantize_int8,
)
from lipsync_tpu_torch.ops.kernels.int8_conv import (
    gemm_dims,
    int8_conv_int32,
    int8_conv_plain,
)
from tests.torch_parity import jax_apply, port_apply, seeded_pair, subtree

torch.set_num_threads(1)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@pytest.fixture(scope="module")
def pair():
    return seeded_pair(3)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return (rng.rand(2, 8, 32, 32, 3).astype(np.float32),
            (rng.rand(2, 80, 32, 1) * 80 - 80).astype(np.float32))


def _lowered(pair, **over):
    model, cfg, variables, jcfg = pair
    port = LipSyncModel(dataclasses.replace(cfg, **over)).eval()
    port.load_state_dict(model.state_dict(), strict=True)
    return port, JModel(dataclasses.replace(jcfg, **over)), variables


# ── shared-track encoding ───────────────────────────────────────────────


@pytest.fixture(scope="module")
def shared_engines():
    _, cfg, variables, jcfg = seeded_pair(5)
    kw = dict(use_bfloat16=False)
    return (ScoringEngine(variables, cfg, device="cpu",
                          shared_visual_encoding=True, **kw),
            JEngine(variables, jcfg, shared_visual_encoding=True, **kw),
            ScoringEngine(variables, cfg, device="cpu", **kw))


@pytest.mark.parametrize("n,starts", [(27, [0, 4, 8, 12, 19]),
                                      (14, [0, 3, 6])])
def test_shared_encoding_matches_jax(shared_engines, n, starts):
    port, ref, per_window = shared_engines
    rng = np.random.RandomState(n)
    crops = rng.rand(n, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(len(starts), 80, 32) * 80 - 80).astype(np.float32)
    got = port.score_track_logits(crops, starts, aud)
    with jax.default_matmul_precision("highest"):
        want = ref.score_track_logits(crops, starts, aud)
    print(f"max |delta| shared n={n}: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # Interior windows see real neighbour frames: the deviation is there.
    assert np.abs(got - per_window.score_track_logits(crops, starts,
                                                      aud)).max() > 1e-4


def test_shared_one_window_track_equals_per_window(shared_engines):
    port, _, per_window = shared_engines
    rng = np.random.RandomState(1)
    crops = (rng.rand(8, 32, 32, 3) * 255).astype(np.uint8)
    aud = (rng.rand(1, 80, 32) * 80 - 80).astype(np.float32)
    np.testing.assert_array_equal(
        port.score_track_logits(crops, [0], aud),
        per_window.score_track_logits(crops, [0], aud))


# ── the HF-stem fold ────────────────────────────────────────────────────


def test_folded_hf_detector_matches_jax(pair):
    model, _, variables, _ = pair
    hf = model.artifact_detector.high_freq_detector
    folded = HighFrequencyDetector(hf.conv3d[3].out_channels,
                                   fold_stem=True).eval()
    folded.load_state_dict(hf.state_dict(), strict=True)
    assert list(folded.state_dict()) == list(hf.state_dict())
    x = np.random.RandomState(2).rand(2, 8, 32, 32, 3).astype(np.float32)
    got = port_apply(folded, x)
    want = jax_apply(JHF(hf.conv3d[3].out_channels, fold_stem=True),
                     subtree(variables, "artifact_detector",
                             "high_freq_detector"), x)
    print(f"max |delta| folded HF: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_folded_model_matches_jax(pair, inputs):
    port, ref, variables = _lowered(pair, hf_stem_fold=True)
    got = port_apply(port, *inputs)
    want = jax_apply(ref, variables, *inputs)
    print(f"max |delta| folded model: {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fold_against_unfolded_holds_the_jax_bounds(pair, inputs):
    """tests/test_ops.py's fold bounds, in the port: exact to fp32 rounding
    when the input has a 2-pixel zero border, < 0.05 pooled otherwise, and
    |dprob| < 1e-3 end to end."""
    model = pair[0]
    hf = model.artifact_detector.high_freq_detector
    folded = HighFrequencyDetector(hf.conv3d[3].out_channels, fold_stem=True)
    folded.load_state_dict(hf.state_dict())
    folded.eval()
    x = np.random.RandomState(3).rand(2, 8, 32, 32, 3).astype(np.float32)
    xz = x.copy()
    xz[:, :, :2] = xz[:, :, -2:] = 0
    xz[:, :, :, :2] = xz[:, :, :, -2:] = 0
    np.testing.assert_allclose(port_apply(folded, xz), port_apply(hf, xz),
                               atol=1e-5, rtol=0)
    assert np.abs(port_apply(folded, x) - port_apply(hf, x)).max() < 0.05
    port, _, _ = _lowered(pair, hf_stem_fold=True)
    dprob = np.abs(_sigmoid(port_apply(port, *inputs))
                   - _sigmoid(port_apply(model, *inputs)))
    assert dprob.max() < 1e-3, dprob.max()


# ── int8 ────────────────────────────────────────────────────────────────


def _jax_quantize(x, scale):
    """The JAX package's quantization (layers.py Int8Conv)."""
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / scale), -127, 127)
                      .astype(jnp.int8))


def test_quantization_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    x = rng.randn(4096).astype(np.float32) * 3
    # max |x| = 127 makes the scale exactly 1: k + 0.5 are exact ties.
    ties = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                     -126.5, 3.5, 4.5], np.float32)
    for values in (x, ties, np.concatenate([ties, x])):
        scale = np.float32(max(np.abs(values).max() / np.float32(127.0),
                               1e-12))
        got = quantize_int8(torch.from_numpy(values), torch.tensor(scale))
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_quantize(values, scale))
    got = quantize_int8(torch.from_numpy(ties), torch.tensor(1.0)).numpy()
    assert got.tolist() == [127, -127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 4]


CONVS = {
    "visual_stem": ((2, 4, 12, 12, 3), (8, 3, 7, 7, 3), (1, 2, 2), (1, 3, 3)),
    "k3_3d": ((2, 3, 6, 6, 16), (16, 3, 3, 3, 16), (1, 1, 1), (1, 1, 1)),
    "k3_3d_strided": ((1, 3, 7, 5, 16), (24, 3, 3, 3, 16), (1, 2, 2),
                      (1, 1, 1)),
    "down_1x1x1": ((2, 2, 6, 6, 16), (32, 1, 1, 1, 16), (1, 2, 2),
                   (0, 0, 0)),
    "audio_stem": ((2, 20, 16, 1), (8, 7, 7, 1), (2, 2), (3, 3)),
    "k3_2d_21": ((2, 9, 7, 16), (16, 3, 3, 16), (2, 1), (1, 1)),
    "down_2d_22": ((1, 9, 7, 16), (24, 1, 1, 16), (2, 2), (0, 0)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_twin_equals_jax_int32_conv(name):
    x_shape, w_shape, stride, pad = CONVS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randint(-127, 128, x_shape).astype(np.int8)
    w = rng.randint(-127, 128, w_shape).astype(np.int8)
    got = int8_conv_plain(torch.from_numpy(x), torch.from_numpy(w), stride,
                          pad).numpy()
    nd = len(stride)
    sp = "DHW"[3 - nd:]
    k = np.moveaxis(w, 0, -1)  # (k..., I, O)
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                        (f"N{sp}C", f"{sp}IO", f"N{sp}C"))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), stride, [(p, p) for p in pad],
        dimension_numbers=dn, preferred_element_type=jnp.int32))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # The wrapper takes the twin for a CPU tensor, and the GEMM view.
    np.testing.assert_array_equal(int8_conv_int32(
        torch.from_numpy(x), torch.from_numpy(w), stride, pad).numpy(), got)
    m, n, kk = gemm_dims(x_shape, w_shape, stride, pad)
    assert (m, n, kk) == (got.size // got.shape[-1], w_shape[0],
                          int(np.prod(w_shape[1:])))


@pytest.mark.parametrize("name,bias", [("k3_3d_strided", True),
                                       ("audio_stem", False),
                                       ("down_2d_22", True)])
def test_int8_conv_matches_jax_int8conv(name, bias):
    x_shape, w_shape, stride, pad = CONVS[name]
    rng = np.random.RandomState(7)
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
    rel = np.abs(got - want).max() / np.abs(want).max()
    print(f"int8 conv {name}: rel {rel:.3g}")
    assert rel <= 1e-6


def test_int8_batch_composition_moves_as_jax(pair):
    """A window's quantization grid follows its batch-mates (per-tensor
    scale): the same window in two batches moves, and by what JAX's
    moves."""
    x_shape, w_shape, stride, pad = CONVS["k3_3d_strided"]
    rng = np.random.RandomState(8)
    win = rng.randn(1, *x_shape[1:]).astype(np.float32)
    batches = [np.concatenate([win, rng.randn(*win.shape).astype(np.float32)
                               * s]) for s in (0.5, 3.0)]
    w = (rng.randn(*w_shape) * 0.1).astype(np.float32)
    layer = Int8Conv(w_shape[0], w_shape[1:-1], stride,
                     [(p, p) for p in pad])
    outs = []
    for batch in batches:
        want = np.asarray(layer.apply({"params": {
            "kernel": np.moveaxis(w, 0, -1)}}, jnp.asarray(batch)))[0]
        got = int8_conv(torch.from_numpy(batch).movedim(-1, 1),
                        torch.from_numpy(w).movedim(-1, 1), None, stride,
                        pad).movedim(1, -1).numpy()[0]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_scales_match_compiled_jax(pair, seed):
    """Every audio-encoder kernel's per-channel scales and a per-tensor
    activation scale, against the JAX package's formulas jitted."""
    enc = pair[0].audio_encoder
    convs = [m for m in enc.modules() if isinstance(m, torch.nn.Conv2d)]
    x = np.random.RandomState(seed).randn(2, 64, 9, 7).astype(np.float32)
    x *= np.float32(10.0 ** (seed * 3 - 2))
    w_scale = jax.jit(lambda k: jnp.maximum(
        jnp.max(jnp.abs(k), axis=tuple(range(k.ndim - 1))) / 127.0, 1e-12))
    x_scale = jax.jit(lambda a: jnp.maximum(jnp.max(jnp.abs(a)) / 127.0,
                                            1e-12))
    for conv in convs:
        w = conv.weight.detach()
        got = torch.clamp(w.abs().amax(dim=(1, 2, 3)) * _INV_127, min=1e-12)
        want = np.asarray(w_scale(jnp.asarray(w.permute(2, 3, 1, 0).numpy())))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        (torch.from_numpy(x).abs().max() * _INV_127).numpy(),
        np.asarray(x_scale(jnp.asarray(x))))


def test_int8_audio_encoder_matches_jax(pair, inputs):
    """All twelve int8 convolutions of the audio encoder in a chain: within
    1e-5 of JAX's int8 encoder, and far from the fp32 encoder."""
    port, _, variables = _lowered(pair, conv_lowering="int8")
    cfg = pair[1]
    got = port_apply(port.audio_encoder, inputs[1])
    want = jax_apply(JAudio(cfg.audio_feature_dim,
                            preserve_audio_temporal=cfg.preserve_audio_temporal,
                            conv_lowering="int8"),
                     subtree(variables, "audio_encoder"), inputs[1])
    fp = port_apply(pair[0].audio_encoder, inputs[1])
    scale = np.abs(want).max()
    d_jax, d_fp = (np.abs(got - want).max() / scale,
                   np.abs(got - fp).max() / scale)
    print(f"int8 audio encoder rel |delta| vs JAX {d_jax:.3g}, "
          f"vs fp32 {d_fp:.3g}")
    assert d_jax <= 1e-5
    assert d_fp > 1e-3  # it did quantize


def test_int8_model_tracks_jax_and_fp(pair, inputs):
    port, ref, variables = _lowered(pair, conv_lowering="int8")
    got = port_apply(port, *inputs)
    want = jax_apply(ref, variables, *inputs)
    fp = port_apply(pair[0], *inputs)
    d_jax = np.abs(_sigmoid(got) - _sigmoid(want)).max()
    d_fp = np.abs(_sigmoid(got) - _sigmoid(fp)).max()
    print(f"int8 |dprob| port vs JAX {d_jax:.3g}, vs fp32 {d_fp:.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert d_fp <= 5e-3  # the JAX package's int8 bound (tests/test_ops.py)
    assert d_jax * 100 <= d_fp  # nearer JAX's int8 result than fp32's
    # The visual encoder alone.
    v_got = port_apply(port.visual_encoder, inputs[0])
    v_want = jax_apply(JVisual(pair[1].visual_feature_dim,
                               conv_lowering="int8"),
                       subtree(variables, "visual_encoder"), inputs[0])
    np.testing.assert_allclose(v_got, v_want, atol=1e-5, rtol=0)


def test_int8_lowering_is_inference_only(pair, inputs):
    port, _, _ = _lowered(pair, conv_lowering="int8")
    port.train()
    with pytest.raises(RuntimeError, match="inference only"):
        port(*(torch.from_numpy(a) for a in inputs))


def test_engine_options_set_the_lowerings(pair):
    _, cfg, variables, _ = pair
    eng = ScoringEngine(variables, cfg, device="cpu", quantized_int8=True,
                        fold_hf_stem=True, shared_visual_encoding=True)
    assert eng.config.conv_lowering == "int8" and eng.config.hf_stem_fold
    assert eng.model.visual_encoder.stem.lowering == "int8"
    assert eng.model.artifact_detector.high_freq_detector.fold_stem
    with pytest.raises(ValueError):
        LipSyncModel(dataclasses.replace(cfg, conv_lowering="shift"))


# ── load_engine(None) ───────────────────────────────────────────────────


def test_load_engine_none_reads_model_path(pair, tmp_path, monkeypatch):
    from lipsync_tpu.utils import weights as jw
    from lipsync_tpu_torch.utils import weights as pw

    model, cfg, _, jcfg = pair
    for mod in (jw, pw):
        monkeypatch.setattr(mod, "FLAGSHIP_DIR", tmp_path / "no_flagship")
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(FileNotFoundError):
        load_engine(None, cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        j_load_engine(None, jcfg)
    path = tmp_path / "w.pth"
    torch.save(model.state_dict(), path)
    monkeypatch.setenv("MODEL_PATH", str(path))
    port = load_engine(None, cfg, device="cpu", use_bfloat16=False)
    ref = j_load_engine(None, jcfg, use_bfloat16=False)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(port.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    assert jax.tree_util.tree_structure(ref.variables) is not None
