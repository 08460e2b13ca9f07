"""The port's data-parallel ragged train step at 2 and 4 gloo ranks
against the JAX package's step in float64 on a mesh of the same size (the
8-virtual-device CPU mesh of ``tests/conftest.py``), on the same
numpy-seeded weights and batch: three real rows, padded to four under a
sample mask, so that every rank's rows are contrastive negatives of every
other rank's. An SGD step of rate 1 that keeps its input exposes the JAX
gradients; the ranks run ``test_torch_parallel_training.py``'s case
``sgd_ragged`` (dropout 0, no augmentation, the shift the JAX step draws).

Tolerances: metrics 1e-5 relative, BatchNorm statistics 1e-5 of max(1,
their largest), gradients 1e-3 of the tensor's largest (conv biases in
front of a training-mode BatchNorm, zero in exact arithmetic, excepted).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from conftest import small_model_config
from lipsync_tpu.models import LipSyncModel as JaxModel
from lipsync_tpu.models import torch_state_dict_to_variables
from lipsync_tpu.parallel import mesh as jmesh
from lipsync_tpu.training.steps import LossConfig as JaxLossConfig
from lipsync_tpu.training.steps import TrainState as JaxState
from lipsync_tpu.training.steps import make_train_step as jax_make_step
from lipsync_tpu_torch.models import LipSyncModel
from lipsync_tpu_torch.models.bridge import (
    seeded_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.training import steps
from test_torch_parallel_training import (
    CFG,
    SEED,
    SHIFT,
    ZERO,
    _jax_batch,
    _rel,
    run_world,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"dp_jax{request.param}")
    return (request.param,) + run_world(tmp, request.param, ["sgd_ragged"])


def test_step_matches_jax_mesh(world):
    n, _, ranks = world
    jcfg = dataclasses.replace(small_model_config(), dropout=0.0)
    variables = torch_state_dict_to_variables(
        seeded_state_dict(LipSyncModel(CFG), SEED),
        num_temporal_layers=CFG.temporal_layers, detect_artifacts=True)
    key = jax.random.PRNGKey(3)
    capture = optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.negative, g),
                              {"g": g}))
    mesh = jmesh.make_mesh(n)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     variables)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                         batch_stats=v64["batch_stats"],
                         opt_state=capture.init(v64["params"]), rng=key)
        batch = {k: jnp.asarray(x, jnp.float64)
                 for k, x in _jax_batch().items()}
        step = jax.jit(
            jax_make_step(JaxModel(jcfg, dtype=jnp.float64), capture,
                          JaxLossConfig()),
            out_shardings=(jmesh.replicated(mesh), jmesh.replicated(mesh)))
        with jax.default_matmul_precision("highest"):
            new, jmetrics = step(jmesh.replicate(state, mesh),
                                 jmesh.shard_batch(batch, mesh))
        grads = variables_to_state_dict(
            {"params": new.opt_state["g"], "batch_stats": new.batch_stats})
        stats = variables_to_state_dict(
            {"params": new.params, "batch_stats": new.batch_stats})
        shifts = steps.sync_shifts(steps.LossConfig())
        drawn = jax.random.randint(jax.random.split(key, 4)[2], (), 0,
                                   len(shifts))
        assert shifts[int(drawn)] == SHIFT
    for r, res in enumerate(ranks):
        metrics = res["sgd_ragged"][0]
        for k, v in metrics.items():
            want = float(jmetrics[k])
            assert abs(v - want) <= 1e-5 * max(abs(want), 1e-6), (r, k)
    _, got_g, sd, _, _, _ = ranks[0]["sgd_ragged"]
    worst = 0.0
    for k, g in got_g.items():
        ref = grads[k].double()
        if k in ZERO:
            continue
        rel = float((g.double() - ref).abs().max() / ref.abs().max())
        worst = max(worst, rel)
        assert rel <= 1e-3, (k, rel)
    for k in sd:
        if "running" in k:
            assert _rel(sd[k], stats[k]) <= 1e-5, k
    print(f"world {n}: worst gradient {worst:.3g} of its tensor's largest "
          f"against JAX in float64")
