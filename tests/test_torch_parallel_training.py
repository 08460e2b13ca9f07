"""One data-parallel train step of the port (``parallel/collectives.py``,
the group BatchNorm of ``models/layers.py``, ``training/steps.py``) at 2
and 4 gloo ranks, against the port in one process
(``test_torch_parallel_jax_step.py`` holds the ragged step against the JAX
package's step on a mesh of the same size).

Each world runs in processes spawned by ``parallel.mesh.run_group`` (a
``file://`` store under ``tmp_path``, a timeout on the group's start and on
the join). This module imports nothing of JAX, and neither do the ranks
(each checks its own ``sys.modules``). Geometry is
``conftest.small_model_config`` (full widths, 8 frames of 48x48).

A gradient is discontinuous where a ReLU input or two pooled values lie
within rounding of each other, and the group's BatchNorm (sums over ranks)
rounds differently from torch's: each rank replays the one-process step's
ReLU masks and max-pool choices on its rows (``activation_pattern``), so
both compute the gradient of the same smooth function; the number of
choices the ranks would have made otherwise is printed.

Tolerances, against the port in one process: metrics 1e-5 relative,
BatchNorm statistics 1e-5 of max(1, their largest), gradients 1e-3 of the
tensor's largest (the high-frequency branch's BatchNorm gradients sum ~1e4
terms to a small result and move 3.8e-4 of their largest between two
summation orders of the one-process step itself), parameters after
Adam/AdamW within 2 lr where the gradient is within that bound of zero and
1e-6 elsewhere, frozen ones bit-unchanged; every rank holds the same
weights after the step.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
from lipsync_tpu_torch.models.bridge import seeded_state_dict
from lipsync_tpu_torch.ops.augment import AugmentConfig
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import steps
from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
from torch_card import SGD1, activation_pattern, conv_biases_before_batchnorm

torch.set_num_threads(1)

SEED = 0
SHIFT = 10  # the JAX step's draw from PRNGKey(3) (checked in the JAX test)
CFG = ModelConfig(video_frames=8, crop_size=48, mel_bins=80,
                  audio_frames=32, dropout=0.0)
JOIN_TIMEOUT_S = 240.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


# name: (optimizer factory, dropout, device augmentation, batch maker)
def _jax_batch():
    """Three real rows, a real contrastive negative on every rank, padded
    to four under a sample mask (the ragged step)."""
    rng = np.random.RandomState(3)
    v = rng.randint(0, 256, (3, 8, 48, 48, 3)).astype(np.uint8)
    batch = {
        "visual": v.astype(np.float32) / np.float32(255),
        "audio": (rng.rand(3, 80, 32, 1) * 80 - 80).astype(np.float32),
        "label": np.asarray([1, 0, 1], np.float32),
    }
    return mesh_lib.pad_batch_to_multiple(batch, 4)


def _phase_batch():
    """Three real uint8 rows padded to four (ragged)."""
    rng = np.random.RandomState(7)
    batch = {
        "visual": rng.randint(0, 256, (3, 8, 48, 48, 3)).astype(np.uint8),
        "audio": (rng.rand(3, 80, 32, 1) * 80 - 80).astype(np.float32),
        "label": np.asarray([0, 1, 0], np.float32),
    }
    return mesh_lib.pad_batch_to_multiple(batch, 4)


CASES = {
    "sgd_ragged": (SGD1, 0.0, False, _jax_batch),
    "phase1_adamw_clip": (
        lambda m: PhaseOptimizer(m.named_parameters(), 1, 1e-4, 5e-5,
                                 kind="adamw", weight_decay=1e-4,
                                 grad_clip=1.0), 0.1, True, _phase_batch),
    "phase2_adam": (
        lambda m: PhaseOptimizer(m.named_parameters(), 2, 1e-4, 1e-5),
        0.1, True, _phase_batch),
    "phase3_adam": (
        lambda m: PhaseOptimizer(m.named_parameters(), 3, 1e-4, 1e-5),
        0.1, True, _phase_batch),
}


def run_case(name, shard=None, tape=None, replay=False, threads=1):
    """One step of case ``name``: (metrics, grads, state dict, lrs, flips)."""
    make_opt, dropout, augment, make_batch = CASES[name]
    torch.set_num_threads(threads)
    try:
        cfg = dataclasses.replace(CFG, dropout=dropout)
        model = LipSyncModel(cfg)
        model.load_state_dict(seeded_state_dict(LipSyncModel(cfg), SEED))
        opt = make_opt(model)
        state = steps.create_train_state(model, opt, SEED, shard)
        batch = make_batch()
        if shard is not None:
            batch = mesh_lib.shard_rows(batch, shard.rank, shard.world)
        step = steps.make_train_step(
            steps.LossConfig(),
            augment_cfg=AugmentConfig() if augment else None)
        torch.manual_seed(SEED + 5)  # dropout: the same on every rank
        seen: dict = {}
        with activation_pattern(tape if tape is not None else [], replay,
                                seen, shard):
            metrics = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, shift=SHIFT)
    finally:
        torch.set_num_threads(1)
    lrs = {n: g["lr"] for g in opt.param_groups
           for n, p in model.named_parameters()
           if any(p is q for q in g["params"])}
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()},
            lrs, seen.get("flips", 0))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_cases(rank, device, tmp, names):
    """A rank of the group: the cases ``names``, replaying the one-process
    tapes. Rank 0 keeps its gradients and weights; every rank keeps its
    metrics, its count of replayed choices and a digest of its weights."""
    torch.set_num_threads(1)
    shard = mesh_lib.process_shard()
    tapes = torch.load(Path(tmp) / "tapes.pt")
    out = {}
    for name in names:
        metrics, grads, sd, lrs, flips = run_case(name, shard, tapes.pop(name),
                                                  replay=True)
        keep = rank == 0
        out[name] = (metrics, grads if keep else None, sd if keep else None,
                     lrs, flips, _digest(sd))
    out["modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in FORBIDDEN or m == "lipsync_tpu"
        or m.startswith("lipsync_tpu."))
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def run_world(tmp, n, names):
    """The one-process step of each case (recording its tapes), then the
    same cases on ``n`` gloo ranks: (one-process results, rank results)."""
    tapes = {name: [] for name in names}
    single = {name: run_case(name, tape=tapes[name]) for name in names}
    torch.save(tapes, tmp / "tapes.pt")
    mesh_lib.run_group(_rank_cases, n, "cpu", f"file://{tmp}/store",
                       args=(str(tmp), list(names)),
                       join_timeout_s=JOIN_TIMEOUT_S)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(n)]
    for f in tmp.iterdir():  # the tapes and weights are large
        f.unlink()
    return single, ranks


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"dp_world{request.param}")
    return (request.param,) + run_world(tmp, request.param, list(CASES))


ZERO = conv_biases_before_batchnorm(LipSyncModel(CFG))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / max(1.0, float(b.float().abs().max())))


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_one_process(world, name):
    n, single, ranks = world
    ref_m, ref_g, ref_sd, lrs, _ = single[name]
    flips = sum(r[name][4] for r in ranks)
    print(f"{name} world {n}: {flips} replayed choices")
    for r, res in enumerate(ranks):
        assert not res["modules"], res["modules"]
        metrics = res[name][0]
        for k, want in ref_m.items():
            assert abs(metrics[k] - want) <= 1e-5 * max(abs(want), 1.0), (
                r, k, metrics[k], want)
        # Every rank holds the same weights after the step.
        assert res[name][5] == ranks[0][name][5], r
    _, grads, sd, _, _, _ = ranks[0][name]
    for k in sd:
        if "running" in k:
            assert _rel(sd[k], ref_sd[k]) <= 1e-5, k
    for k, g in grads.items():
        ref = ref_g[k]
        if k in ZERO:
            assert float(g.abs().max()) < 1e-6, k
            continue
        bound = 1e-3 * float(ref.abs().max())
        assert float((g - ref).abs().max()) <= bound, k
        lr = lrs.get(k, 0.0)
        if name == "sgd_ragged":
            continue
        d = (sd[k] - ref_sd[k]).abs()
        if lr == 0.0:
            assert float(d.max()) == 0.0, k  # frozen
            continue
        # Adam's first update is about lr * sign(g): where |g| is within the
        # gradient bound of zero, fp32 does not decide it.
        tiny = ref.abs() < max(bound, 1e-6)
        assert float(d[tiny].max()) <= 2 * lr if tiny.any() else True, k
        assert float(d[~tiny].max()) <= 1e-6 if (~tiny).any() else True, k
