"""The port's unwired legacy modules and ``example_inputs`` against the JAX
package's.

``LegacyFusionModule`` is held to the JAX module on the same weights
(flax variables through ``models/bridge.py::legacy_fusion_state_dict``)
within 1e-5, the JAX side under ``jax.default_matmul_precision("highest")``
(XLA:CPU's default matmul precision is relaxed to ~1e-3);
``temporal_aggregation`` within 1e-6 (float32 sums of a few terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipsync_tpu.models.fusion import LegacyFusionModule as JLegacyFusion
from lipsync_tpu.models.lip_sync_model import (
    ModelConfig as JModelConfig,
    example_inputs as j_example_inputs,
)
from lipsync_tpu.models.temporal import (
    temporal_aggregation as j_temporal_aggregation,
)
from lipsync_tpu_torch.models import ModelConfig, legacy_fusion_state_dict
from lipsync_tpu_torch.models.fusion import LegacyFusionModule
from lipsync_tpu_torch.models.lip_sync_model import example_inputs
from lipsync_tpu_torch.models.temporal import temporal_aggregation

torch.set_num_threads(1)


@pytest.mark.parametrize("t_v,t_a", [(8, 11), (8, 8)],
                         ids=["interpolated", "equal_lengths"])
def test_legacy_fusion_matches_jax(t_v, t_a):
    rng = np.random.default_rng(t_a)
    b, d, h = 3, 16, 24
    v = rng.normal(size=(b, t_v, d)).astype(np.float32)
    a = rng.normal(size=(b, t_a, d)).astype(np.float32)
    jmod = JLegacyFusion(embed_dim=d, hidden_dim=h)
    variables = jmod.init(jax.random.PRNGKey(t_a), jnp.asarray(v),
                          jnp.asarray(a))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmod.apply(variables, jnp.asarray(v),
                                     jnp.asarray(a)))
    mod = LegacyFusionModule(embed_dim=d, hidden_dim=h)
    mod.load_state_dict(legacy_fusion_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    assert mod.fc1.weight.shape == (h, 2 * d)
    with torch.no_grad():
        got = mod(torch.from_numpy(v), torch.from_numpy(a)).numpy()
    assert got.shape == (b, t_v, d)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got >= 0).all()


@pytest.mark.parametrize("a_shape", [(2, 5), (3, 5, 8), (2, 5, 4)],
                         ids=["rank2", "batch", "feature"])
def test_legacy_fusion_rejects_what_jax_rejects(a_shape):
    v = np.zeros((2, 5, 8), np.float32)
    a = np.zeros(a_shape, np.float32)
    with pytest.raises(ValueError) as want:
        JLegacyFusion(embed_dim=8).init(jax.random.PRNGKey(0),
                                        jnp.asarray(v), jnp.asarray(a))
    with pytest.raises(ValueError) as got:
        LegacyFusionModule(embed_dim=8)(torch.from_numpy(v),
                                        torch.from_numpy(a))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("lengths", [None, [9, 4, 1, 0], [9, 9, 9, 9]],
                         ids=["unmasked", "masked_zero_length", "full"])
def test_temporal_aggregation_matches_jax(lengths):
    x = np.random.default_rng(3).normal(size=(4, 9, 6)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    want = np.asarray(j_temporal_aggregation(jnp.asarray(x), jl))
    got = temporal_aggregation(torch.from_numpy(x), tl).numpy()
    assert got.shape == (4, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if lengths is not None and 0 in lengths:
        assert (got[lengths.index(0)] == 0).all()  # no NaN, exactly zero


@pytest.mark.parametrize("x_shape,lengths", [((2, 3), None),
                                             ((2, 3, 4), [1, 2, 3]),
                                             ((2, 3, 4), [[1, 2]])],
                         ids=["rank2", "batch", "lengths_rank"])
def test_temporal_aggregation_rejects_what_jax_rejects(x_shape, lengths):
    x = np.zeros(x_shape, np.float32)
    with pytest.raises(ValueError):
        j_temporal_aggregation(
            jnp.asarray(x),
            None if lengths is None else jnp.asarray(lengths, jnp.int32))
    with pytest.raises(ValueError):
        temporal_aggregation(
            torch.from_numpy(x),
            None if lengths is None else torch.tensor(lengths))


def test_example_inputs_match_jax_shapes():
    for batch in (1, 3):
        want = j_example_inputs(JModelConfig(), batch)
        got = example_inputs(ModelConfig(), batch, device="cpu")
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert not g.any()
    v, a = example_inputs(ModelConfig(video_frames=4, crop_size=8), 2,
                          dtype=torch.bfloat16, device="cpu")
    assert v.shape == (2, 4, 8, 8, 3) and a.dtype == torch.bfloat16


def test_example_inputs_ask_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example_inputs()
