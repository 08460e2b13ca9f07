"""The port's device augmentation (``ops/augment.py``) and host
``Augmentations`` against the JAX package's, on numpy-seeded clips.

The random streams differ (``jax.random`` against ``torch.Generator``), so
the parity tests draw each sample's parameters exactly as the JAX
``_augment_one`` does from its key and hand them to the port's
``apply_augment``. The host ``Augmentations`` draws from a numpy
``RandomState`` on both sides and rotates with cv2 where it imports (both
packages), or with scipy where it does not: each branch is compared with
cv2 visible, or hidden, on both sides.
"""

from __future__ import annotations

import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lipsync_tpu.ops import augment as jaug
from lipsync_tpu.training import data as jdata
from lipsync_tpu_torch.ops import augment as taug
from lipsync_tpu_torch.training import data as tdata

torch.set_num_threads(1)


@pytest.fixture()
def rng():
    return np.random.RandomState(0)


def test_reflect_index_matches_jax():
    n = 7
    idx = np.arange(-2 * n, 3 * n)
    got = taug._reflect_index(torch.from_numpy(idx), n).numpy()
    want = np.asarray(jaug._reflect_index(jnp.asarray(idx), n))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,speed", [(32, 0.9), (32, 1.1), (128, 1.07),
                                     (5, 0.93)])
def test_speed_indices_match_jax(t, speed):
    got = taug._speed_indices(t, torch.tensor([speed], dtype=torch.float32))
    want = np.asarray(jaug._speed_indices(t, jnp.float32(speed)))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("angles", [(11.5, -7.25), (0.0, 14.9), (-15.0, 3.3)])
def test_rotation_matches_jax(rng, angles):
    frames = rng.rand(len(angles), 2, 24, 20, 3).astype(np.float32)
    got = taug._rotate_frames(torch.from_numpy(frames),
                              torch.tensor(angles, dtype=torch.float32))
    for i, a in enumerate(angles):
        want = np.asarray(jaug._rotate_frames(jnp.asarray(frames[i]),
                                              jnp.float32(a)))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-6)


def _jax_draws(key, visual_shape, audio_shape, cfg=jaug.AugmentConfig()):
    """Each sample's draws as ``jax.ops.augment._augment_one`` takes them
    from its key (unit-normal noise, as the port's draws hold it)."""
    out = {k: [] for k in ("speed", "flip", "angle", "brightness",
                           "do_brightness", "contrast", "do_contrast",
                           "do_visual_noise", "visual_noise",
                           "do_audio_noise", "audio_noise")}
    u = jax.random.uniform
    for sk in jax.random.split(key, visual_shape[0]):
        k = jax.random.split(sk, 10)
        out["speed"].append(u(k[0], (), minval=cfg.speed_range[0],
                              maxval=cfg.speed_range[1]))
        out["flip"].append(u(k[1], ()) > 0.5)
        out["angle"].append(u(k[2], (), minval=-cfg.rotation_deg,
                              maxval=cfg.rotation_deg))
        out["brightness"].append(u(k[3], (), minval=cfg.brightness_range[0],
                                   maxval=cfg.brightness_range[1]))
        out["do_brightness"].append(u(k[4], ()) > 0.5)
        out["contrast"].append(u(k[5], (), minval=cfg.contrast_range[0],
                                 maxval=cfg.contrast_range[1]))
        out["do_contrast"].append(u(k[6], ()) > 0.5)
        out["do_visual_noise"].append(u(k[7], ()) > 0.5)
        out["visual_noise"].append(
            jax.random.normal(k[8], tuple(visual_shape[1:])))
        out["do_audio_noise"].append(u(k[9], ()) > 0.5)
        out["audio_noise"].append(jax.random.normal(
            jax.random.fold_in(k[9], 1), tuple(audio_shape[1:3])))
    return {name: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))
            for name, xs in out.items()}


@pytest.mark.parametrize("seed,squeeze", [(7, False), (11, True), (3, False)])
def test_augment_batch_matches_jax_on_jax_draws(rng, seed, squeeze):
    visual = rng.rand(4, 8, 16, 12, 3).astype(np.float32)
    audio = (rng.rand(4, 80, 32, 1).astype(np.float32) * 80.0) - 80.0
    if squeeze:
        audio = audio[..., 0]
    key = jax.random.PRNGKey(seed)
    want_v, want_a = jaug.augment_batch(key, jnp.asarray(visual),
                                        jnp.asarray(audio))
    draws = _jax_draws(key, visual.shape, audio.shape)
    got_v, got_a = taug.apply_augment(torch.from_numpy(visual),
                                      torch.from_numpy(audio), draws)
    assert got_v.shape == visual.shape and got_a.shape == audio.shape
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               rtol=0, atol=1e-6)


def test_augment_batch_shapes_ranges_and_determinism(rng):
    visual = torch.from_numpy(rng.rand(4, 8, 16, 16, 3).astype(np.float32))
    audio = torch.from_numpy(
        (rng.rand(4, 80, 32, 1).astype(np.float32) * 80.0) - 80.0)

    def run(seed):
        return taug.augment_batch(torch.Generator().manual_seed(seed),
                                  visual, audio)

    v1, a1 = run(7)
    v2, a2 = run(7)
    assert v1.shape == visual.shape and a1.shape == audio.shape
    assert torch.equal(v1, v2) and torch.equal(a1, a2)
    assert v1.min() >= 0.0 and v1.max() <= 1.0
    assert a1.min() >= -80.0 and a1.max() <= 0.0
    v3, _ = run(8)
    assert (v3 - v1).abs().max() > 1e-4


def test_augment_batch_per_sample_independent(rng):
    one = torch.from_numpy(rng.rand(1, 8, 16, 16, 3).astype(np.float32))
    visual = torch.cat([one, one])
    audio = torch.full((2, 80, 32, 1), -40.0)
    v, _ = taug.augment_batch(torch.Generator().manual_seed(3), visual,
                              audio)
    assert (v[0] - v[1]).abs().max() > 1e-4


def test_augment_batch_uint8_and_disabled(rng):
    visual_u8 = rng.randint(0, 255, (2, 4, 8, 8, 3)).astype(np.uint8)
    audio = np.zeros((2, 80, 16, 1), np.float32) - 30.0
    cfg = taug.AugmentConfig(enabled=False)
    v, a = taug.augment_batch(torch.Generator(), torch.from_numpy(visual_u8),
                              torch.from_numpy(audio), cfg)
    want, _ = jaug.augment_batch(jax.random.PRNGKey(0),
                                 jnp.asarray(visual_u8), jnp.asarray(audio),
                                 jaug.AugmentConfig(enabled=False))
    np.testing.assert_allclose(v.numpy(), np.asarray(want), rtol=0, atol=0)
    np.testing.assert_array_equal(a.numpy(), audio)


def _host_augmentations(seed):
    src = np.random.RandomState(100 + seed)
    visual = src.rand(8, 16, 16, 3).astype(np.float32)
    audio = (src.rand(80, 32).astype(np.float32) * 80) - 80
    got_v, got_a = tdata.Augmentations()(
        visual, audio, rng=np.random.RandomState(seed))
    want_v, want_a = jdata.Augmentations()(
        visual, audio, rng=np.random.RandomState(seed))
    assert got_v.dtype == want_v.dtype == np.float32
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_a, want_a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_augmentations_match_jax(seed):
    """Same RandomState on both sides, cv2 visible on both (the rotation
    is ``cv2.warpAffine`` in both packages)."""
    pytest.importorskip("cv2")
    _host_augmentations(seed)


def test_host_augmentations_match_jax_without_cv2():
    """cv2 hidden on both sides: both rotate with scipy."""
    with mock.patch.dict(sys.modules, {"cv2": None}):
        _host_augmentations(0)


def test_host_augmentations_preserve_shapes_and_ranges(rng):
    aug = tdata.Augmentations()
    visual = rng.rand(8, 16, 16, 3).astype(np.float32)
    audio = (rng.rand(80, 32).astype(np.float32) * 80) - 80
    for _ in range(5):
        v, a = aug(visual, audio, rng=rng)
        assert v.shape == visual.shape and a.shape == audio.shape
        assert 0.0 <= v.min() and v.max() <= 1.0
        assert -80.0 <= a.min() and a.max() <= 0.0


def test_train_step_with_device_augment(rng):
    """The step takes uint8 batches and augments on the device: finite
    loss, and the parameters move."""
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
    from lipsync_tpu_torch.training import steps
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer

    torch.manual_seed(0)
    model = LipSyncModel(ModelConfig(video_frames=4, crop_size=16,
                                     audio_frames=16))
    opt = PhaseOptimizer(model.named_parameters(), 3, 1e-3, 1e-3)
    state = steps.create_train_state(model, opt, 0)
    step = steps.make_train_step(
        steps.LossConfig(sync_shift_frames=(2,)),
        augment_cfg=taug.AugmentConfig())
    batch = {
        "visual": torch.from_numpy(
            rng.randint(0, 255, (2, 4, 16, 16, 3)).astype(np.uint8)),
        "audio": torch.from_numpy(
            (rng.rand(2, 80, 16, 1).astype(np.float32) * 80.0) - 80.0),
        "label": torch.tensor([1.0, 0.0]),
    }
    before = [p.detach().clone() for p in model.parameters()]
    metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    assert any((p - b).abs().max() > 0
               for p, b in zip(model.parameters(), before))
