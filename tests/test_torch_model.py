"""The port's model modules against their JAX counterparts (fp32, CPU).

Each module runs on the same numpy inputs and the same seeded weights as
its JAX counterpart; the tolerance is atol 1e-4 for every module and for
the end-to-end logits (the measured deltas are listed in PERF.md).
"""

import numpy as np
import pytest
import torch

from lipsync_tpu.models import layers as jl
from lipsync_tpu.models import torch_state_dict_to_variables
from lipsync_tpu.models.artifact import (
    ArtifactDetector as JArtifact,
    TemporalInconsistencyDetector as JTemporalDetector,
)
from lipsync_tpu.models.audio_encoder import AudioEncoder as JAudio
from lipsync_tpu.models.classifier import ClassificationHead as JHead
from lipsync_tpu.models.fusion import (
    CrossModalAttention as JCross,
    FeatureProjection as JProj,
)
from lipsync_tpu.models.lip_sync_model import LipSyncModel as JModel
from lipsync_tpu.models.temporal import TemporalTransformer as JTemporal
from lipsync_tpu.models.visual_encoder import VisualEncoder as JVisual
from lipsync_tpu_torch.models import (
    LipSyncModel,
    bn_calibrated_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.models import layers as pl
from tests.torch_parity import jax_apply, port_apply, seeded_pair, subtree

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return seeded_pair(0)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _to_cf(x):  # channels-last -> channels-first (numpy)
    return np.moveaxis(x, -1, 1)


def _case(name, pair, rng):
    """(port output(s), JAX output(s)) of one module on one input."""
    model, cfg, variables, _ = pair
    v = lambda *p: subtree(variables, *p)  # noqa: E731
    if name == "conv_bn_act":
        x = rng.rand(2, 8, 32, 32, 3).astype(np.float32)
        got = port_apply(model.visual_encoder.stem, _to_cf(x))
        want = jax_apply(
            jl.ConvBNAct(64, (3, 7, 7), (1, 2, 2), ((1, 1), (3, 3), (3, 3))),
            v("visual_encoder", "stem"), x)
        return got, _to_cf(want)
    if name == "residual_block":
        x = _rand(rng, 2, 8, 8, 8, 64)
        got = port_apply(model.visual_encoder.layer2, _to_cf(x))
        want = jax_apply(jl.ResidualBlockND(128, (3, 3, 3), (1, 2, 2)),
                         v("visual_encoder", "layer2"), x)
        return got, _to_cf(want)
    if name == "max_pool_same":
        x = _rand(rng, 2, 8, 9, 9, 5)
        win, st, pad = (1, 3, 3), (1, 2, 2), ((0, 0), (1, 1), (1, 1))
        got = port_apply(lambda t: pl.max_pool_same(t, win, st, pad),
                         _to_cf(x))
        want = np.asarray(jl.max_pool_same(x, win, st, pad))
        return got, _to_cf(want)
    if name == "multi_head_attention":
        q, kv = _rand(rng, 2, 8, 64), _rand(rng, 2, 5, 64)
        got = port_apply(model.cross_modal.v2a_attn, q, kv, kv)
        want = jax_apply(jl.MultiHeadAttention(64, 4),
                         v("cross_modal", "v2a_attn"), q, kv, kv)
        return got, want
    if name == "transformer_layer":
        x = _rand(rng, 2, 9, 64)
        got = port_apply(model.temporal.transformer.layers[0], x)
        want = jax_apply(jl.TransformerEncoderLayer(64, 4, 256),
                         v("temporal", "layer_0"), x)
        return got, want
    if name == "interp_linear_time":
        x = _rand(rng, 2, 4, 16)
        got = (port_apply(lambda t: pl.interp_linear_time(t, 8), x),
               port_apply(lambda t: pl.interp_linear_time(t, 3), x))
        want = (np.asarray(jl.interp_linear_time(x, 8)),
                np.asarray(jl.interp_linear_time(x, 3)))
        return got, want
    if name == "visual_encoder":
        x = rng.rand(2, 8, 32, 32, 3).astype(np.float32)
        got = port_apply(lambda t: model.visual_encoder(t, return_map=True), x)
        want = jax_apply(JVisual(64), v("visual_encoder"), x, return_map=True)
        return got, tuple(want)
    if name == "audio_encoder":
        x = _rand(rng, 2, 80, 32, 1, scale=20.0) - 40.0
        got = port_apply(model.audio_encoder, x)
        want = jax_apply(JAudio(64), v("audio_encoder"), x)
        return got, want
    if name == "feature_projection":
        a, b = _rand(rng, 2, 8, 64), _rand(rng, 2, 4, 64)
        got = port_apply(model.projection, a, b)
        want = jax_apply(JProj(64), v("projection"), a, b)
        return got, tuple(want)
    if name == "cross_modal_attention":
        a, b = _rand(rng, 2, 8, 64), _rand(rng, 2, 4, 64)
        got = port_apply(model.cross_modal, a, b)
        want = jax_apply(JCross(64, 4), v("cross_modal"), a, b)
        return got, want
    if name == "temporal_transformer":
        x = _rand(rng, 2, 8, 64)
        got = port_apply(model.temporal, x)
        want = jax_apply(JTemporal(64, 4, 2), v("temporal"), x)
        return got, want
    if name == "classification_head":
        x = _rand(rng, 2, 96)
        got = port_apply(model.classifier, x)
        want = jax_apply(JHead(128), v("classifier"), x)
        return got, want
    if name == "temporal_detector":
        x = _rand(rng, 2, 8, 3, 3, 64)
        got = port_apply(model.artifact_detector.temporal_detector, x)
        want = jax_apply(JTemporalDetector(64),
                         v("artifact_detector", "temporal_detector"), x)
        return got, want
    if name == "artifact_detector":
        vmap, cls = _rand(rng, 2, 8, 1, 1, 64), _rand(rng, 2, 64)
        raw = rng.rand(2, 8, 32, 32, 3).astype(np.float32)
        got = port_apply(model.artifact_detector, vmap, cls, raw)
        want = jax_apply(JArtifact(64, 64), v("artifact_detector"),
                         vmap, cls, raw)
        return got, want
    raise KeyError(name)


MODULES = [
    "conv_bn_act", "residual_block", "max_pool_same", "multi_head_attention",
    "transformer_layer", "interp_linear_time", "visual_encoder",
    "audio_encoder", "feature_projection", "cross_modal_attention",
    "temporal_transformer", "classification_head", "temporal_detector",
    "artifact_detector",
]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name, pair):
    rng = np.random.RandomState(MODULES.index(name))
    got, want = _case(name, pair, rng)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        print(f"max |delta| {name}: {np.abs(g - w).max():.3g}")
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("detect_artifacts", [True, False])
def test_end_to_end_logits_match_jax(detect_artifacts):
    model, cfg, variables, jcfg = seeded_pair(
        1, detect_artifacts=detect_artifacts)
    rng = np.random.RandomState(7)
    vis = rng.rand(3, 8, 32, 32, 3).astype(np.float32)
    aud = (rng.rand(3, 80, 32, 1) * 80 - 80).astype(np.float32)
    got = port_apply(model, vis, aud)
    want = jax_apply(JModel(jcfg), variables, vis, aud)
    assert got.shape == want.shape == (3,)
    delta = float(np.abs(got - want).max())
    print(f"max |delta| logits detect_artifacts={detect_artifacts}: "
          f"{delta:.3g}")
    assert delta < ATOL, delta


def test_encode_split_equals_forward(pair):
    model, *_ = pair
    rng = np.random.RandomState(3)
    vis = torch.from_numpy(rng.rand(2, 8, 32, 32, 3).astype(np.float32))
    aud = torch.from_numpy((rng.rand(2, 80, 32, 1) * 80 - 80)
                           .astype(np.float32))
    with torch.no_grad():
        whole = model(vis, aud)
        v_feat, v_map = model.encode_visual(vis)
        split = model.score_encoded(v_feat, v_map, vis, aud)
    torch.testing.assert_close(whole, split, atol=0, rtol=0)


def test_bridge_round_trip(pair):
    """variables -> port state_dict -> the JAX converter gives back the
    variables it started from, leaf for leaf."""
    model, cfg, variables, _ = pair
    back = torch_state_dict_to_variables(
        model.state_dict(), num_temporal_layers=cfg.temporal_layers)
    flat = lambda t, p="": (  # noqa: E731
        {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{p}/{k}").items()}
        if isinstance(t, dict) else {p: np.asarray(t)}
    )
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_strict_load_raises_on_missing_key(pair):
    model, cfg, variables, _ = pair
    sd = variables_to_state_dict(variables)
    sd.pop("classifier.net.4.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        LipSyncModel(cfg).load_state_dict(sd, strict=True)


def test_bn_calibration_sets_batch_statistics(pair):
    """Each BatchNorm's running statistics become those of the calibration
    batch (checked exactly on the visual stem, whose input is the batch
    itself); every other entry of the state dict is left as it was."""
    model, cfg, _, _ = pair
    rng = np.random.RandomState(11)
    vis = torch.from_numpy(rng.rand(4, 8, 32, 32, 3).astype(np.float32))
    aud = torch.from_numpy((rng.rand(4, 80, 32, 1) * 80 - 80)
                           .astype(np.float32))
    before = model.state_dict()
    after = bn_calibrated_state_dict(cfg, before, vis, aud)
    assert after.keys() == before.keys()
    for k, v in before.items():
        if "running_" not in k and "num_batches" not in k:
            torch.testing.assert_close(after[k], v, atol=0, rtol=0)
    conv = model.visual_encoder.stem[0]
    with torch.no_grad():
        y = conv(vis.permute(0, 4, 1, 2, 3))
    torch.testing.assert_close(after["visual_encoder.stem.1.running_mean"],
                               y.mean(dim=(0, 2, 3, 4)), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(after["visual_encoder.stem.1.running_var"],
                               y.var(dim=(0, 2, 3, 4)), atol=1e-5, rtol=1e-4)
    calibrated = LipSyncModel(cfg).eval()
    calibrated.load_state_dict(after, strict=True)
    with torch.no_grad():
        assert torch.isfinite(calibrated(vis, aud)).all()


def test_bf16_mode_keeps_the_visual_stem_and_layers_1_2_fp32(pair):
    """bf16 runs from visual layer 3 on and in the artifact convolutions;
    the stem, layers 1-2, the audio encoder and the head stay fp32."""
    _, cfg, variables, _ = pair
    model = LipSyncModel(cfg, dtype=torch.bfloat16).eval()
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    seen = {}
    names = ["visual_encoder.stem", "visual_encoder.layer2",
             "visual_encoder.layer3", "artifact_detector.temporal_detector"
             ".temporal_conv.0", "audio_encoder.stem", "classifier"]
    for name in names:
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    rng = np.random.RandomState(4)
    vis = torch.from_numpy(rng.rand(2, 8, 32, 32, 3).astype(np.float32))
    aud = torch.from_numpy((rng.rand(2, 80, 32, 1) * 80 - 80)
                           .astype(np.float32))
    with torch.no_grad():
        logits = model(vis, aud)
    assert logits.dtype == torch.float32
    assert seen == {
        "visual_encoder.stem": torch.float32,
        "visual_encoder.layer2": torch.float32,
        "visual_encoder.layer3": torch.bfloat16,
        "artifact_detector.temporal_detector.temporal_conv.0": torch.bfloat16,
        "audio_encoder.stem": torch.float32,
        "classifier": torch.float32,
    }
