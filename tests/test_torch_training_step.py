"""The port's train step, losses and train-mode BatchNorm against the JAX
package's, on the same numpy-seeded weights and batches.

Geometry is ``conftest.small_model_config`` (full widths, 8 frames of
48x48, 32 mel frames), batch 3, dropout 0, augmentation off, and the shift
that the JAX step draws from its state's key. The JAX side is evaluated in
float64 (``jax.enable_x64``): flax's BatchNorm computes an fp32 variance as
E[x^2] - E[x]^2, which cancels where activations have a large mean (the
audio stem sees dB in [-80, 0]), so the fp32 JAX step is itself far from
the exact value of its function in the early layers.
``test_train_mode_batchnorm_matches_jax`` shows that rounding on the
statistics of one forward. Three JAX train steps are compiled in all.

Two limits of fp32 that the gradient bound has to respect:

* some sums are ill-conditioned (the high-frequency branch's BatchNorm
  gradients sum ~1e4 terms to a small result), so the port's own fp32
  gradient moves between two summation orders. Each case measures that
  move (the port's step on 1 and on 8 threads) and the gradient bound
  allows twice it on top of 1e-4 of the tensor's largest gradient;
* a ReLU whose input lies within fp32 rounding of zero takes either side,
  which moves one output position's share of a layer's gradient. The batch
  seed is fixed (``BATCH_SEED``) on inputs with no such tie.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import small_model_config
from lipsync_tpu.models import LipSyncModel as JaxModel
from lipsync_tpu.models import torch_state_dict_to_variables
from lipsync_tpu.training import losses as jl
from lipsync_tpu.training.optimizers import make_phase_optimizer as jax_opt
from lipsync_tpu.training.steps import LossConfig as JaxLossConfig
from lipsync_tpu.training.steps import TrainState as JaxState
from lipsync_tpu.training.steps import make_train_step as jax_make_step
from lipsync_tpu_torch.models import (
    LipSyncModel,
    ModelConfig,
    seeded_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.models.layers import batch_norms
from lipsync_tpu_torch.training import losses as tl
from lipsync_tpu_torch.training import steps
from lipsync_tpu_torch.training.optimizers import PhaseOptimizer

torch.set_num_threads(1)

B = 3
SEED = 0
BATCH_SEED = 3


JCFG = dataclasses.replace(small_model_config(), dropout=0.0)
CFG = ModelConfig(**{f.name: getattr(JCFG, f.name)
                     for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def variables():
    sd = seeded_state_dict(LipSyncModel(CFG), SEED)
    return torch_state_dict_to_variables(
        sd, num_temporal_layers=CFG.temporal_layers, detect_artifacts=True)


def _batch(uint8=False, mask=False):
    """Pixels are uint8 / 255 in every case, so that a uint8 batch is the
    float batch that the step makes of it."""
    rng = np.random.RandomState(BATCH_SEED)
    v = rng.randint(0, 256, (B, CFG.video_frames, CFG.crop_size,
                             CFG.crop_size, 3)).astype(np.uint8)
    batch = {
        "visual": v if uint8 else v.astype(np.float32) / np.float32(255),
        "audio": (rng.rand(B, 80, CFG.audio_frames, 1) * 80 - 80
                  ).astype(np.float32),
        "label": np.asarray([1, 0, 1], np.float32),
    }
    if mask:
        batch["sample_mask"] = np.asarray([1, 1, 0], np.float32)
    return batch


def _port_model(variables, dropout=0.0):
    cfg = dataclasses.replace(CFG, dropout=dropout)
    model = LipSyncModel(cfg)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


def _rel_err(got, ref):
    """max |got - ref| over max(1, max |ref|)."""
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


# ── losses ───────────────────────────────────────────────────────────────


def _loss_inputs(seed=0, b=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 4, 16).astype(np.float32),
            rng.randn(b, 4, 16).astype(np.float32),
            rng.randn(b, 4, 16).astype(np.float32),
            rng.randn(b).astype(np.float32))


@pytest.mark.parametrize("labels,mask", [
    ([1, 0, 1, 0, 1], None),
    ([1, 0, 1, 0, 1], [1, 1, 1, 0, 0]),
    ([1, 1, 1, 1, 1], None),
    ([0, 0, 0, 0, 0], [1, 0, 1, 1, 0]),
    ([1, 0, 0, 0, 0], [0, 1, 0, 0, 0]),
    ([1, 0, 1, 0, 1], [0, 0, 0, 0, 0]),
])
def test_losses_match_jax(labels, mask):
    v, a, neg, logits = _loss_inputs()
    lab = np.asarray(labels, np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    t = torch.from_numpy
    tm = None if m is None else t(m)
    jm = None if m is None else jnp.asarray(m)
    real = lab >= 0.5 if m is None else (lab >= 0.5) & (m > 0)
    pairs = [
        (tl.bce_with_logits(t(logits), t(lab), sample_mask=tm),
         jl.bce_with_logits(jnp.asarray(logits), jnp.asarray(lab),
                            sample_mask=jm)),
        (tl.cross_modal_contrastive_loss(t(v), t(a), t(lab),
                                         sample_mask=tm),
         jl.cross_modal_contrastive_loss(jnp.asarray(v), jnp.asarray(a),
                                         jnp.asarray(lab), sample_mask=jm)),
        (tl.sync_contrastive_loss(t(v), t(a), [t(neg)],
                                  real_mask=t(real)),
         jl.sync_contrastive_loss(jnp.asarray(v), jnp.asarray(a),
                                  [jnp.asarray(neg)],
                                  real_mask=jnp.asarray(real))),
    ]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * max(1, abs(float(want)))


def test_masked_losses_match_unpadded():
    v, a, neg, logits = _loss_inputs(1)
    lab = np.asarray([1, 0, 1, 0, 1], np.float32)

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], 3, axis=0)])

    mask = torch.tensor([1.0] * 5 + [0.0] * 3)
    t = torch.from_numpy
    assert abs(float(tl.bce_with_logits(t(logits), t(lab)))
               - float(tl.bce_with_logits(t(pad(logits)), t(pad(lab)),
                                          sample_mask=mask))) < 1e-6
    assert abs(float(tl.cross_modal_contrastive_loss(t(v), t(a), t(lab)))
               - float(tl.cross_modal_contrastive_loss(
                   t(pad(v)), t(pad(a)), t(pad(lab)),
                   sample_mask=mask))) < 1e-5
    real = t(lab >= 0.5)
    real_p = t((pad(lab) >= 0.5) & (mask.numpy() > 0))
    assert abs(float(tl.sync_contrastive_loss(t(v), t(a), [t(neg)],
                                              real_mask=real))
               - float(tl.sync_contrastive_loss(
                   t(pad(v)), t(pad(a)), [t(pad(neg))],
                   real_mask=real_p))) < 1e-5


@pytest.mark.parametrize("loss", ["cross_modal", "sync"])
def test_contrastive_grads_finite_at_zero_tokens(loss):
    v = torch.zeros(4, 5, 16, requires_grad=True)
    a = torch.zeros(4, 5, 16)
    lab = torch.tensor([1.0, 0.0, 1.0, 0.0])
    if loss == "cross_modal":
        out = tl.cross_modal_contrastive_loss(v, a, lab)
    else:
        out = tl.sync_contrastive_loss(v, a, [a], real_mask=lab >= 0.5)
    out.backward()
    assert torch.isfinite(v.grad).all()


# ── train-mode BatchNorm ─────────────────────────────────────────────────


def _port_bn_stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_train_mode_batchnorm_matches_jax(variables):
    """One training-mode forward updates every BatchNorm's running mean
    and variance as flax does (biased batch variance, momentum 0.9 in flax
    terms), and gives the same logits."""
    batch = _batch()
    model = _port_model(variables).train()
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["visual"]),
                       torch.from_numpy(batch["audio"])).numpy()
    got = _port_bn_stats(model)

    def jax_forward(dtype):
        jm = JaxModel(JCFG, dtype=dtype)
        fn = jax.jit(lambda var, v, a: jm.apply(
            var, v, a, train=True, mutable=["batch_stats"]))
        with jax.default_matmul_precision("highest"):
            out, mutated = fn(_cast(variables, dtype),
                              jnp.asarray(batch["visual"], dtype),
                              jnp.asarray(batch["audio"], dtype))
        sd = variables_to_state_dict(
            {"params": variables["params"],
             "batch_stats": mutated["batch_stats"]})
        return np.asarray(out), {k: sd[k].numpy() for k in got}

    with jax.enable_x64(True):
        ref_logits, ref = jax_forward(jnp.float64)
    _, jax32 = jax_forward(jnp.float32)
    port_err = {k: _rel_err(got[k], ref[k]) for k in got}
    jax32_err = {k: _rel_err(jax32[k], ref[k]) for k in got}
    worst = max(port_err, key=port_err.get)
    assert port_err[worst] <= 1e-5, (worst, port_err[worst])
    assert np.abs(logits - ref_logits).max() <= 1e-4
    # The port rounds no worse than the JAX package's own fp32 forward.
    assert max(port_err.values()) <= max(jax32_err.values())


def test_batchnorm_momentum_none_is_a_cumulative_average():
    """``bn_calibrated_state_dict``'s mode: with ``momentum=None`` two
    batches leave the mean of their (biased) statistics."""
    from lipsync_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(3, momentum=None).train()
    bn.reset_running_stats()
    x1, x2 = torch.randn(4, 3, 5), torch.randn(6, 3, 2) * 2 + 1
    bn(x1)
    bn(x2)
    want = (x1.var(dim=(0, 2), unbiased=False)
            + x2.var(dim=(0, 2), unbiased=False)) / 2
    torch.testing.assert_close(bn.running_var, want, rtol=1e-6, atol=1e-7)


# ── one train step against the JAX step ──────────────────────────────────


def _capture_sgd():
    """optax SGD(1.0) whose state keeps the gradient it was given."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.negative, g),
                              {"g": g}),
    )


class _SGD1:
    """``torch.optim.SGD(lr=1)`` with the port optimizer's interface."""

    def __init__(self, model):
        self.opt = torch.optim.SGD(model.parameters(), lr=1.0)
        self.param_groups = self.opt.param_groups

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        self.opt.step()


CASES = {
    # name: (JAX optimizer, port optimizer factory, uint8, sample_mask)
    "sgd": (lambda: _capture_sgd(), lambda m: _SGD1(m), False, False),
    "adam_phase3_uint8_mask": (
        lambda: jax_opt(3, 1e-4, 1e-5),
        lambda m: PhaseOptimizer(m.named_parameters(), 3, 1e-4, 1e-5),
        True, True),
    "adamw_clip_phase1": (
        lambda: jax_opt(1, 1e-4, 5e-5, kind="adamw", weight_decay=1e-4,
                        grad_clip=1.0),
        lambda m: PhaseOptimizer(m.named_parameters(), 1, 1e-4, 5e-5,
                                       kind="adamw", weight_decay=1e-4,
                                       grad_clip=1.0),
        False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax_step(variables, case):
    make_jax_opt, make_port_opt, uint8, mask = CASES[case]
    batch = _batch(uint8=uint8, mask=mask)
    key = jax.random.PRNGKey(3)

    with jax.enable_x64(True):
        tx = make_jax_opt()
        v64 = _cast(variables, jnp.float64)
        state = JaxState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                         batch_stats=v64["batch_stats"],
                         opt_state=tx.init(v64["params"]), rng=key)
        jb = {k: (jnp.asarray(x) if x.dtype == np.uint8
                  else jnp.asarray(x, jnp.float64)) for k, x in batch.items()}
        step = jax.jit(jax_make_step(JaxModel(JCFG, dtype=jnp.float64), tx,
                                     JaxLossConfig()))
        with jax.default_matmul_precision("highest"):
            new, jmetrics = step(state, jb)
        new_sd = variables_to_state_dict(
            {"params": new.params, "batch_stats": new.batch_stats})
        grads = (variables_to_state_dict(
            {"params": new.opt_state["g"],
             "batch_stats": new.batch_stats}) if case == "sgd" else None)
        # The shift the JAX step drew from its key.
        shift_rng = jax.random.split(key, 4)[2]
        shifts = steps.sync_shifts(steps.LossConfig())
        shift = shifts[int(jax.random.randint(shift_rng, (), 0, len(shifts)))]

    def port_step(threads):
        torch.set_num_threads(threads)
        try:
            model = _port_model(variables)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            state = steps.create_train_state(model, make_port_opt(model), SEED)
            metrics = steps.make_train_step(steps.LossConfig())(
                state, {k: torch.from_numpy(x) for k, x in batch.items()},
                shift=shift)
        finally:
            torch.set_num_threads(1)
        assert state.step == 1
        return model, before, state, metrics

    model, before, state, metrics = port_step(1)
    other = dict(port_step(8)[0].named_parameters())

    for name, value in metrics.items():
        want = float(jmetrics[name])
        assert abs(float(value) - want) <= 1e-5 * max(abs(want), 1e-6), name

    after = model.state_dict()
    for name in after:
        if name.endswith(("running_mean", "running_var")):
            assert _rel_err(after[name].numpy(),
                            new_sd[name].numpy()) <= 1e-5, name

    lrs = {id(q): grp["lr"] for grp in state.optimizer.param_groups
           for q in grp["params"]}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        # The gradient bound: 1e-4 of the tensor's largest gradient, plus
        # twice what the port's own fp32 moves between summation orders.
        noise = np.abs(g - other[name].grad.numpy()).max()
        bound = 1e-4 * np.abs(g).max() + 2 * noise
        if case == "sgd":
            ref = grads[name].numpy()
            if np.abs(ref).max() < 1e-7:
                # A conv bias in front of a training-mode BatchNorm: zero in
                # exact arithmetic, rounding noise on both sides.
                assert np.abs(g).max() < 1e-6, name
            else:
                assert np.abs(g - ref).max() <= bound, name
            continue
        lr = lrs.get(id(p), 0.0)
        got, want = after[name].numpy(), new_sd[name].numpy()
        if lr == 0.0:  # frozen: bit-unchanged
            assert np.array_equal(got, before[name].numpy()), name
            continue
        # Adam's first update is about lr * sign(g): where |g| is within the
        # gradient bound of zero (or under 1e-6, near Adam's eps), fp32 does
        # not decide it.
        d = np.abs(got - want)
        tiny = np.abs(g) < max(bound, 1e-6)
        assert d[tiny].max(initial=0.0) <= 2 * lr, name
        assert d[~tiny].max(initial=0.0) <= 1e-6, (name, d[~tiny].max())


# ── the sync-negative forward ────────────────────────────────────────────


def test_sync_forward_keeps_stats_and_dropout_masks(variables):
    """The second forward leaves every BatchNorm buffer as the first set
    it, and draws the same dropout masks (bit-equal visual tokens)."""
    model = _port_model(variables, dropout=0.3)
    batch = {k: torch.from_numpy(x) for k, x in _batch().items()}
    seen = []
    forward = model.forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append({
            "tokens": out[1]["visual_tokens"].detach().clone(),
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k or "num_batches" in k},
        })
        return out

    model.forward = recording
    torch.manual_seed(5)
    state = steps.create_train_state(model, _SGD1(model), SEED)
    steps.make_train_step(steps.LossConfig())(state, batch, shift=5)
    assert len(seen) == 2
    assert torch.equal(seen[0]["tokens"], seen[1]["tokens"])
    for k, v in seen[0]["stats"].items():
        assert torch.equal(v, seen[1]["stats"][k]), k
    assert all(bn.update_stats for bn in batch_norms(model))
    # Dropout is on: the same step on another seed draws other masks.
    torch.manual_seed(6)
    model2 = _port_model(variables, dropout=0.3)
    _, aux = model2.train()(batch["visual"], batch["audio"], return_aux=True)
    assert not torch.equal(aux["visual_tokens"], seen[0]["tokens"])


def test_eval_step_runs_eval_mode(variables):
    model = _port_model(variables)
    batch = _batch()
    logits = steps.make_eval_step(model)(torch.from_numpy(batch["visual"]),
                                         torch.from_numpy(batch["audio"]))
    assert not model.training and logits.shape == (B,)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(batch["visual"]),
                            torch.from_numpy(batch["audio"]))
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


def test_train_step_runs_and_descends():
    """Three Adam steps on one fixed batch lower the loss (the JAX
    package's own smoke test of its step)."""
    torch.manual_seed(0)
    model = LipSyncModel(ModelConfig(video_frames=4, crop_size=32,
                                     audio_frames=16))
    state = steps.create_train_state(
        model, PhaseOptimizer(model.named_parameters(), 3, 1e-3, 1e-3), 0)
    rng = np.random.RandomState(0)
    batch = {
        "visual": torch.from_numpy(rng.rand(4, 4, 32, 32, 3)
                                   .astype(np.float32)),
        "audio": torch.from_numpy((rng.rand(4, 80, 16, 1) * 80 - 80)
                                  .astype(np.float32)),
        "label": torch.from_numpy(rng.randint(0, 2, 4).astype(np.float32)),
    }
    step = steps.make_train_step(steps.LossConfig())
    losses = [float(step(state, batch)["loss"]) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and state.step == 3
    assert losses[-1] < losses[0]


def _two_steps(augment, profiled):
    """Two Adam steps on a uint8 batch with dropout on, from the same seed;
    the losses, the parameters after, and the spans kept."""
    from torch.profiler import ProfilerActivity, profile

    from lipsync_tpu_torch.ops.augment import AugmentConfig
    from lipsync_tpu_torch.utils import profiling

    torch.manual_seed(0)
    model = LipSyncModel(ModelConfig(video_frames=4, crop_size=32,
                                     audio_frames=16, dropout=0.2))
    state = steps.create_train_state(
        model, PhaseOptimizer(model.named_parameters(), 3, 1e-3, 1e-3), 0)
    rng = np.random.RandomState(1)
    batch = {
        "visual": torch.from_numpy(rng.randint(0, 256, (4, 4, 32, 32, 3))
                                   .astype(np.uint8)),
        "audio": torch.from_numpy((rng.rand(4, 80, 16, 1) * 80 - 80)
                                  .astype(np.float32)),
        "label": torch.from_numpy(np.asarray([1, 0, 1, 0], np.float32)),
    }
    step = steps.make_train_step(
        steps.LossConfig(), augment_cfg=AugmentConfig() if augment else None)
    profiling.clear()
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()):
        losses = [step(state, batch)["loss"] for _ in range(2)]
    recs = profiling.records()
    profiling.clear()
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}, recs


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_train_step_spans_leave_the_step_bit_equal(augment):
    """Under a profiler two steps record two ``train.step`` trees of four
    children each (augment, forward, backward, update), the forward holding
    the visual encoder's ``visual.low`` once for each of its two visual
    encodes, and the losses and parameters are bit-equal with tracing off,
    where nothing is kept."""
    losses, params, recs = _two_steps(augment, profiled=True)
    want_losses, want_params, none = _two_steps(augment, profiled=False)
    assert none == []
    assert [float(x) for x in losses] == [float(x) for x in want_losses]
    for k, v in want_params.items():
        assert torch.equal(params[k], v), k
    roots = [r for r in recs if r.name == "train.step"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    for root in roots:
        kids = sorted((r for r in recs if r.parent == root.id),
                      key=lambda r: r.t0_ns)
        assert [r.name for r in kids] == ["train.augment", "train.forward",
                                          "train.backward", "train.update"]
        assert all(r.root == root.id for r in kids)
        assert root.t0_ns <= kids[0].t0_ns and kids[-1].t1_ns <= root.t1_ns
        lows = [r for r in recs if r.parent == kids[1].id]
        assert [r.name for r in lows] == ["visual.low"] * 2
    assert len(recs) == 14
