"""Shared set-up of the PyTorch-port parity tests.

One narrow configuration, seeded weights made with numpy and handed to both
packages, and JAX applies at highest precision (XLA:CPU's default conv and
matmul precision is relaxed to ~1e-3). The port model loads its weights
back through ``variables_to_state_dict``, so every parity test also runs
the bridge.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu.models import ModelConfig as JaxModelConfig
from lipsync_tpu.models import torch_state_dict_to_variables
from lipsync_tpu_torch.models import (
    LipSyncModel,
    ModelConfig,
    seeded_state_dict,
    variables_to_state_dict,
)

NARROW = dict(
    visual_feature_dim=64, audio_feature_dim=64, embed_dim=64,
    cross_modal_heads=4, temporal_heads=4, temporal_layers=2,
    video_frames=8, crop_size=32, audio_frames=32,
)


def configs(**over):
    kw = {**NARROW, **over}
    return ModelConfig(**kw), JaxModelConfig(**kw)


def seeded_pair(seed: int = 0, **over):
    """(port model in eval mode, port config, JAX variables, JAX config),
    both sides holding the same numpy-made weights."""
    cfg, jcfg = configs(**over)
    torch.manual_seed(seed)
    made = LipSyncModel(cfg)
    variables = torch_state_dict_to_variables(
        seeded_state_dict(made, seed),
        num_temporal_layers=cfg.temporal_layers,
        detect_artifacts=cfg.detect_artifacts,
    )
    model = LipSyncModel(cfg).eval()
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model, cfg, variables, jcfg


def subtree(variables, *path):
    """The ``{"params", "batch_stats"}`` of one submodule."""
    out = {}
    for col in ("params", "batch_stats"):
        node = variables.get(col, {})
        for p in path:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        if node:
            out[col] = node
    return out


def jax_apply(module, variables, *args, **kwargs):
    """``module.apply`` jitted at highest precision, as numpy."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))
    with jax.default_matmul_precision("highest"):
        out = fn(variables, *(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def port_apply(fn, *args):
    with torch.no_grad():
        out = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


PROBABILITIES = {"confidence", "raw_confidence", "manipulation_probability",
                 "window_confidences", "window_weighted_confidence"}


def assert_same(got, want, path="response", tol=1e-4):
    """Two predictor responses (or JSON bodies) field by field: keys,
    strings, bools, ints equal; probabilities within 1e-5, every other
    float within ``tol``."""
    if isinstance(got, dict):
        assert isinstance(want, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in got:
            assert_same(got[k], want[k], f"{path}.{k}",
                        1e-5 if k in PROBABILITIES else tol)
    elif isinstance(got, (list, tuple)):
        assert isinstance(want, (list, tuple)), path
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", tol)
    elif isinstance(got, float):
        assert isinstance(want, float), (path, got, want)
        assert abs(got - want) <= tol, (path, got, want, tol)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)
