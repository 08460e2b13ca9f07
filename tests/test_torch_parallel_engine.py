"""The port's data-parallel inference (``parallel/mesh.py``, the engine's
``mesh``, ``PredictorConfig.data_parallel_devices``) against the JAX
package on its 8-virtual-device CPU mesh and against the port on one
device, in fp32 on the same numpy-seeded weights.

The port's mesh here is ``[cpu] * n``: n shards in one process. Tolerances
(logits unless stated):

- port mesh vs port on one device: 1e-5 (default and shared lowerings;
  JAX's own mesh-vs-single bounds are 2e-5 in probability and 1e-4,
  ``tests/test_predictor.py``; 1e-4 on a six-shard shared track, whose
  padding differs), int8 included, whose scales are the whole bucket's
  abs-max;
- port mesh vs JAX mesh: 1e-4 (the port-vs-JAX engine bound of
  ``test_torch_engine.py``), 1e-5 for shared encoding (that of
  ``test_torch_serving_options.py``), and for int8 |dprob| <= 5e-3, the
  JAX package's int8 bound (see ``test_int8_scales_are_global``);
- predictor responses: ``torch_parity.assert_same`` (probabilities 1e-5).
"""

import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from lipsync_tpu.inference.engine import ScoringEngine as JEngine
from lipsync_tpu.inference.predictor import Predictor as JPredictor
from lipsync_tpu.inference.predictor import PredictorConfig as JConfig
from lipsync_tpu.parallel import mesh as jmesh
from lipsync_tpu.preprocessing.face_detection import FakeDetector as JFake
from lipsync_tpu_torch.inference.engine import ScoringEngine
from lipsync_tpu_torch.inference.predictor import Predictor, PredictorConfig
from lipsync_tpu_torch.ops.kernels import int8_conv as k3
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.preprocessing.face_detection import FakeDetector
from lipsync_tpu_torch.serving.config import Settings
from tests.fixtures import synthetic_frames, write_av_video
from tests.torch_parity import assert_same, seeded_pair

torch.set_num_threads(1)

CPU = torch.device("cpu")
BOX = (60, 70, 110, 105)


@pytest.fixture(scope="module")
def pair():
    return seeded_pair(5)


def _engines(pair, n, **kw):
    _, cfg, variables, jcfg = pair
    kw = dict(use_bfloat16=False, **kw)
    return (ScoringEngine(variables, cfg, mesh=[CPU] * n, **kw),
            JEngine(variables, jcfg, mesh=jmesh.make_mesh(n), **kw),
            ScoringEngine(variables, cfg, device="cpu", **kw))


def _inputs(seed, n=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 8, 32, 32, 3).astype(np.float32),
            (rng.rand(n, 80, 32) * 80 - 80).astype(np.float32))


def _track(seed, n_frames=27, starts=(0, 4, 8, 12, 19)):
    rng = np.random.RandomState(seed)
    return (rng.rand(n_frames, 32, 32, 3).astype(np.float32), list(starts),
            (rng.rand(len(starts), 80, 32) * 80 - 80).astype(np.float32))


def _jax(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args))


# ── parallel/mesh.py ────────────────────────────────────────────────────


def test_mesh_helpers_match_jax():
    assert mesh_lib.make_mesh(3, device_type="cpu") == [CPU] * 3
    assert mesh_lib.make_mesh(2, devices=["cpu"] * 5) == [CPU] * 2
    assert mesh_lib.pad_to_multiple(10, 8) == jmesh.pad_to_multiple(10, 8)
    rng = np.random.RandomState(0)
    batch = {"visual": rng.rand(10, 2, 3).astype(np.float32),
             "label": rng.randint(0, 2, 10).astype(np.float32)}
    for n_dev in (1, 3, 8):
        got = mesh_lib.pad_batch_to_multiple(batch, n_dev)
        want = jmesh.pad_batch_to_multiple(batch, n_dev)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert mesh_lib.shard_bounds(12, 3) == [(0, 4), (4, 8), (8, 12)]
    with pytest.raises(ValueError):
        mesh_lib.shard_bounds(10, 3)
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_lib.make_mesh(2)


def test_lockstep_reduces_over_shards_and_fails_fast():
    values = [3.0, -7.0, 5.0]
    out = mesh_lib.Lockstep(3).run([
        (lambda v=v: mesh_lib.all_max(torch.tensor(v).abs()))
        for v in values])
    assert [float(o) for o in out] == [7.0] * 3
    # Outside a Lockstep the reduction is the value itself.
    assert float(mesh_lib.all_max(torch.tensor(2.0))) == 2.0

    def boom():
        raise KeyError("shard 1")

    started = threading.Event()

    def waits():
        started.set()
        return mesh_lib.all_max(torch.tensor(1.0))

    with pytest.raises(KeyError, match="shard 1"):
        mesh_lib.Lockstep(2).run([waits, boom])
    assert started.is_set()


# ── the engine over a mesh ───────────────────────────────────────────────


@pytest.mark.parametrize("path", ["score_logits", "score_track_logits"])
def test_mesh_engine_matches_jax_and_one_device(pair, path):
    """Eight shards: a ragged bucket (5 windows -> 8) and a track."""
    port, ref, single = _engines(pair, 8)
    args = _inputs(21) if path == "score_logits" else _track(22)
    got = getattr(port, path)(*args)
    want = _jax(getattr(ref, path), *args)
    alone = getattr(single, path)(*args)
    print(f"{path} n=8: vs JAX {np.abs(got - want).max():.3g}, "
          f"vs one device {np.abs(got - alone).max():.3g}")
    assert got.shape == want.shape == alone.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, alone, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [8, 6])
def test_shared_encoding_frame_shards(pair, n):
    """Shared encoding shards the track's frames (27 -> 32 frames; 36 on
    six shards, the non-power-of-two round-up) with a halo each side:
    the whole-track encode's logits. Against JAX's mesh (the same padding)
    within 1e-5, the bound of the one-device shared path against JAX;
    against one device within JAX's own mesh bound, 1e-4: on six shards
    the last window's receptive field reaches padded frames that one
    device's 32-frame track does not have."""
    port, ref, single = _engines(pair, n, shared_visual_encoding=True)
    crops, starts, aud = _track(23)
    got = port.score_track_logits(crops, starts, aud)
    want = _jax(ref.score_track_logits, crops, starts, aud)
    alone = single.score_track_logits(crops, starts, aud)
    print(f"shared n={n}: vs JAX {np.abs(got - want).max():.3g}, "
          f"vs one device {np.abs(got - alone).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, alone, atol=1e-5 if n == 8 else 1e-4,
                               rtol=0)
    assert port.model.visual_encoder.temporal_halo == 9


def test_int8_scales_are_global(pair, monkeypatch):
    """Under int8 the eight shards run in lockstep: each convolution's
    activation scale is the abs-max of the whole bucket, so the sharded
    engine gives the one-device engine's logits (within the 1e-5 that the
    batch split moves fp32 rounding), and the visual stem's scale is the
    bucket's pixel abs-max on every shard, as on the JAX mesh; scoring
    each shard on its own (local scales) would move the logits ~2e-2.

    Against the jitted JAX mesh engine the logits agree only to the
    quantization step: an fp32 activation one ulp apart from JAX's rounds
    to the other int8 value at a half step, and the step propagates (up to
    8.6e-3 in logits on random batches, the same between the two
    one-device engines). That comparison is held to the JAX package's int8
    bound, |dprob| <= 5e-3 (``tests/test_ops.py``)."""
    port, ref, single = _engines(pair, 8, quantized_int8=True)
    vis, aud = _inputs(24, n=8)
    vis[3] *= 0.25  # shards with different ranges
    seen = []
    real = mesh_lib.all_max

    def spy(value):
        out = real(value)
        seen.append(float(out))
        return out

    monkeypatch.setattr(mesh_lib, "all_max", spy)
    got = port.score_logits(vis, aud)
    stem = np.float32(np.abs(np.clip(vis * 255 + 0.5, 0, 255)
                             .astype(np.uint8) / np.float32(255)).max())
    assert seen[:8] == [float(stem)] * 8
    monkeypatch.setattr(mesh_lib, "all_max", real)
    want = _jax(ref.score_logits, vis, aud)
    alone = single.score_logits(vis, aud)
    local = np.concatenate([single.score_logits(vis[i:i + 1], aud[i:i + 1])
                            for i in range(8)])

    def prob(x):
        return 1 / (1 + np.exp(-x))

    d_jax = np.abs(prob(got) - prob(want)).max()
    print(f"int8 n=8: |dprob| vs JAX {d_jax:.3g}, logits vs one device "
          f"{np.abs(got - alone).max():.3g}, vs local scales "
          f"{np.abs(got - local).max():.3g}")
    np.testing.assert_allclose(got, alone, atol=1e-5, rtol=0)
    assert np.abs(got - local).max() > 1e-3
    assert d_jax <= 5e-3
    crops, starts, taud = _track(25)
    np.testing.assert_allclose(port.score_track_logits(crops, starts, taud),
                               single.score_track_logits(crops, starts, taud),
                               atol=1e-5, rtol=0)


def test_int8_shared_frame_shards_count_only_their_frames(pair):
    """int8 with shared encoding: a frame shard's halo holds values that
    are not the whole track's, so its scale counts only its own frames."""
    _, cfg, variables, _ = pair
    kw = dict(use_bfloat16=False, quantized_int8=True,
              shared_visual_encoding=True)
    port = ScoringEngine(variables, cfg, mesh=[CPU] * 4, **kw)
    single = ScoringEngine(variables, cfg, device="cpu", **kw)
    crops, starts, aud = _track(26)
    np.testing.assert_allclose(port.score_track_logits(crops, starts, aud),
                               single.score_track_logits(crops, starts, aud),
                               atol=1e-5, rtol=0)


def test_mesh_shards_launch_on_every_shard(pair, monkeypatch):
    """Every shard runs its own forward: eight int8 forwards of the
    encoders per bucket (the K3 wrapper is called on each)."""
    port, _, single = _engines(pair, 8, quantized_int8=True)
    calls = []
    real = k3.int8_conv_plain

    def spy(x, *args, **kwargs):
        calls.append(x.shape[0])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(k3, "int8_conv_plain", spy)
    vis, aud = _inputs(27, n=8)
    single.score_logits(vis, aud)
    per_forward = len(calls)
    calls.clear()
    port.score_logits(vis, aud)
    assert len(calls) == 8 * per_forward
    assert set(calls) == {1}


# ── predictor and settings ───────────────────────────────────────────────


@pytest.fixture(scope="module")
def weights(pair, tmp_path_factory):
    path = tmp_path_factory.mktemp("dp") / "w.pth"
    torch.save(pair[0].state_dict(), path)
    return path


def test_predictor_data_parallel_devices_matches_jax(pair, weights,
                                                      tmp_path):
    """``data_parallel_devices=8``: the port's engine shards over the host
    eight times, JAX's over its eight devices; the pipelined long path's
    responses agree, and equal the one-device port's."""
    _, cfg, _, jcfg = pair
    clip = write_av_video(tmp_path / "long.avi", synthetic_frames(n=40))
    knobs = dict(chunk_size=8, chunk_stride=4, data_parallel_devices=8)
    port = Predictor(model_path=weights, config=PredictorConfig(**knobs),
                     model_config=cfg,
                     detector_backend=FakeDetector(lambda i: [BOX]),
                     device="cpu")
    assert port.engine.mesh == [CPU] * 8
    with jax.default_matmul_precision("highest"):
        ref = JPredictor(model_path=weights, config=JConfig(**knobs),
                         model_config=jcfg,
                         detector_backend=JFake(lambda i: [BOX]))
        assert ref.engine.mesh.devices.size == 8
        want = ref.predict(clip)
    got = port.predict(clip)
    alone = Predictor(
        model_path=weights,
        config=PredictorConfig(**{**knobs, "data_parallel_devices": 0}),
        model_config=cfg, detector_backend=FakeDetector(lambda i: [BOX]),
        device="cpu").predict(clip)
    assert_same(got, want)
    assert_same(got, alone)


def test_settings_data_parallel_devices_reaches_the_engine(pair, weights):
    _, cfg, _, _ = pair
    settings = Settings(data_parallel_devices=2, model_path=weights)
    assert settings.to_predictor_config().data_parallel_devices == 2
    p = Predictor(model_path=weights, config=settings.to_predictor_config(),
                  model_config=cfg, device="cpu")
    assert p.engine.mesh == [CPU] * 2


def test_engine_turns_tf32_off(pair):
    """The engine runs its fp32 stages in fp32: it turns PyTorch's default
    TF32 convolutions off for the process (they are global switches)."""
    _, cfg, variables, _ = pair
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        ScoringEngine(variables, cfg, device="cpu")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
