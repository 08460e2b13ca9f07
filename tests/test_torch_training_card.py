"""The port's training on a CUDA card at the published widths of
``ModelConfig()``: the entry points turn TF32 off for the process; one
train step on the card equals the same step on the CPU (on the card's
activation pattern); ``run_training`` launches K2 in validation and never
in a train step; and the trainer as a world of one on NCCL equals the step
without the group.

Every test takes the ``card`` fixture and skips without a card. This file
imports no JAX, so that it runs where JAX is absent:

    python -m pytest tests/test_torch_*_card.py --noconftest -m card
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from lipsync_tpu_torch.inference.engine import load_engine
from lipsync_tpu_torch.models import (
    LipSyncModel,
    ModelConfig,
    seeded_state_dict,
)
from lipsync_tpu_torch.ops.kernels import hf_stem as k2
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import finetune as finetune_mod
from lipsync_tpu_torch.training import steps
from lipsync_tpu_torch.training import train as train_mod
from lipsync_tpu_torch.training.data import BatchLoader, LipSyncDataset
from lipsync_tpu_torch.training.device_cache import DeviceDatasetCache
from lipsync_tpu_torch.utils import synthetic
from lipsync_tpu_torch.utils.device import disable_tf32
from torch_card import card, tf32_off  # noqa: F401
from torch_card import (
    SEED,
    SGD1,
    activation_pattern,
    conv_biases_before_batchnorm,
    step_gaps,
)

pytestmark = pytest.mark.card
# Card against CPU, or group against none, on one activation pattern: each
# gradient within this share of its tensor's largest.
PARITY_GRAD_TOL = 1e-3
CORPUS_FRAMES = 48  # clips of 3.2 s


def tf32_on(m) -> None:
    """PyTorch's default (cuDNN TF32 on) and matmul TF32 on: what an entry
    point must turn off."""
    m.setattr(torch.backends.cudnn, "allow_tf32", True)
    m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def tf32_flags() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def geometry(cfg) -> list:
    return ["--video-frames", str(cfg.video_frames),
            "--crop-size", str(cfg.crop_size),
            "--audio-frames", str(cfg.audio_frames)]


def test_load_engine_turns_tf32_off(card, tmp_path, monkeypatch):
    small = ModelConfig(visual_feature_dim=64, audio_feature_dim=64,
                        embed_dim=64, video_frames=8, crop_size=32,
                        audio_frames=32)
    torch.save(LipSyncModel(small).state_dict(), tmp_path / "w.pth")
    tf32_on(monkeypatch)
    load_engine(tmp_path / "w.pth", small, device=card)
    assert tf32_flags() == (False, False)


def one_step(device, cfg, weights, batch, tape, replay, group=None):
    """One train step (SGD with lr 1, a fixed shift) of ``weights`` on
    ``batch``, recording or replaying ``tape``: (metrics, gradients,
    BatchNorm statistics), on the CPU."""
    model = LipSyncModel(cfg)
    model.load_state_dict(weights)
    model.to(device)
    state = steps.create_train_state(model, SGD1(model), SEED, group)
    seen = {}
    with activation_pattern(tape, replay, seen):
        metrics = steps.make_train_step(steps.LossConfig())(
            state, train_mod.to_device(batch, device), shift=5)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if "running" in n})


def assert_parity(gaps) -> None:
    """Metrics within 1e-5 relative, BatchNorm statistics within 1e-5 of
    max(1, their largest), each gradient within ``PARITY_GRAD_TOL`` of its
    tensor's largest."""
    assert max(gaps["metric_rel"].values()) <= 1e-5, gaps["metric_rel"]
    assert gaps["stat_rel"] <= 1e-5
    worst = sorted(((v, n) for n, v in gaps["grad_rel"].items()),
                   reverse=True)[:5]
    assert worst[0][0] <= PARITY_GRAD_TOL, worst


def test_train_step_on_the_card_equals_the_cpu(card, tf32_off):
    """One train step at full width, batch 2, dropout 0, augmentation off,
    seeded weights: on the card, then on the CPU replaying the card's ReLU
    masks and max-pool choices."""
    cfg = dataclasses.replace(ModelConfig(), dropout=0.0)
    weights = seeded_state_dict(LipSyncModel(cfg), SEED)
    rng = np.random.default_rng(SEED)
    batch = {
        "visual": rng.integers(0, 256, (2, cfg.video_frames, cfg.crop_size,
                                        cfg.crop_size, 3), dtype=np.uint8),
        "audio": rng.uniform(-80, 0, (2, cfg.mel_bins, cfg.audio_frames, 1)
                             ).astype(np.float32),
        "label": np.asarray([1.0, 0.0], np.float32),
    }
    tape = []
    on_card = one_step(card, cfg, weights, batch, tape, False)
    on_cpu = one_step(torch.device("cpu"), cfg, weights, batch, tape, True)
    zero = conv_biases_before_batchnorm(LipSyncModel(cfg))
    gaps = step_gaps(on_cpu, on_card, zero)
    assert_parity(gaps)
    # A gradient that is zero in exact arithmetic (a conv bias in front of
    # a training-mode BatchNorm) stays rounding noise on both sides.
    assert len(zero) == 4 and gaps["zero_max"] < 1e-6


@pytest.fixture(scope="module")
def corpus(card, tmp_path_factory):
    """16 synthetic clips of 48 frames, written on the card."""
    return synthetic.write_corpus(
        tmp_path_factory.mktemp("corpus") / "corpus", n_clips=16,
        n_frames=CORPUS_FRAMES, crop_size=ModelConfig().crop_size, seed=SEED,
        device=card)


def test_k2_in_validation_and_never_in_a_train_step(card, corpus, tmp_path,
                                                    monkeypatch):
    """``run_training`` for one epoch of two steps: every eval-mode forward
    of validation launches K2, no train step does, and the run leaves TF32
    off."""
    step_k2, val_k2 = [], []
    real_validate = train_mod.validate
    real_make_step = train_mod.make_train_step

    def validate_spy(*args, **kwargs):
        before = k2.launches
        result = real_validate(*args, **kwargs)
        val_k2.append(k2.launches - before)
        return result

    def make_step_spy(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def counted(state, batch, shift=None):
            before = k2.launches
            metrics = step(state, batch, shift)
            torch.cuda.synchronize()
            step_k2.append(k2.launches - before)
            return metrics
        return counted

    monkeypatch.setattr(train_mod, "validate", validate_spy)
    monkeypatch.setattr(train_mod, "make_train_step", make_step_spy)
    tf32_on(monkeypatch)
    history = train_mod.run_training(train_mod.build_argparser().parse_args(
        ["--preprocessed-dir", str(corpus), "--output-dir", str(tmp_path),
         "--batch-size", "4", "--max-steps-per-epoch", "2", "--epochs", "1",
         *geometry(ModelConfig())]), device=card)
    assert np.isfinite(history["val_loss"])
    assert step_k2 and set(step_k2) == {0}
    assert val_k2 and min(val_k2) >= 1
    assert tf32_flags() == (False, False)


def _world_of_one(rank, device, corpus, out):
    """A rank of a world of one on NCCL: a host-fed and a device-cache
    train step through the group against the same step without it (on one
    activation pattern), then ``run_training`` (device cache) and
    ``run_finetune`` through the group, each started with TF32 on."""
    cfg = ModelConfig()
    shard = mesh_lib.process_shard()
    dataset = LipSyncDataset(preprocessed_dir=corpus,
                             video_frames=cfg.video_frames,
                             audio_frames=cfg.audio_frames,
                             uint8_visual=True, device=device)
    host = next(iter(BatchLoader(dataset, batch_size=4, shuffle=False,
                                 train_mode_override=True)))
    cache = DeviceDatasetCache(dataset, mesh=shard, device=device)
    cached = next(iter(cache.batches(range(16), 4,
                                     rng=np.random.RandomState(SEED))))
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    weights = seeded_state_dict(LipSyncModel(cfg0), SEED)
    zero = conv_biases_before_batchnorm(LipSyncModel(cfg0))
    disable_tf32()  # the steps run as run_training runs them
    gaps = {}
    for feed, batch in (("host_fed", host), ("device_cache", cached)):
        tape = []
        alone = one_step(device, cfg0, weights, batch, tape, False)
        grouped = one_step(device, cfg0, weights, batch, tape, True, shard)
        gaps[feed] = step_gaps(alone, grouped, zero)
    base = ["--preprocessed-dir", corpus, "--batch-size", "8",
            "--max-steps-per-epoch", "2", "--epochs", "1", *geometry(cfg)]
    histories, flags = {}, {}
    for name, entry, args in (
            ("run_training", train_mod.run_training,
             train_mod.build_argparser().parse_args(
                 base + ["--output-dir", f"{out}/w", "--device-cache"])),
            ("run_finetune", finetune_mod.run_finetune,
             finetune_mod.build_argparser().parse_args(
                 base + ["--output-dir", f"{out}/ft",
                         "--checkpoint", f"{out}/w/latest"]))):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        histories[name] = entry(args, device=device)
        flags[name] = tf32_flags()
    torch.save({"backend": torch.distributed.get_backend(),
                "world": shard.world, "gaps": gaps, "histories": histories,
                "tf32_after": flags}, Path(out) / "world_of_one.pt")


def test_world_of_one_on_nccl(card, corpus, tmp_path):
    """The trainer as a world of one on NCCL, in a spawned process: its
    group steps equal the steps without the group as the card equals the
    CPU, and its ``run_training`` and ``run_finetune`` finish with finite
    histories and TF32 off."""
    mesh_lib.run_group(_world_of_one, 1, "cuda", f"file://{tmp_path}/store",
                       args=(str(corpus), str(tmp_path)),
                       join_timeout_s=600)
    world = torch.load(tmp_path / "world_of_one.pt")
    assert (world["backend"], world["world"]) == ("nccl", 1)
    for feed, gaps in world["gaps"].items():
        assert_parity(gaps)
    assert all(np.isfinite(v) for h in world["histories"].values()
               for v in h.values()), world["histories"]
    assert set(world["tf32_after"].values()) == {(False, False)}
