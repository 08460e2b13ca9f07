"""Entry points of the port: the flagship forward at its canonical shapes,
and a multi-device dry run of training and serving.

    python -m lipsync_tpu_torch.tools.graft_entry [n]

The port's counterpart of the repo's root ``__graft_entry__.py`` (which
drives the JAX package). :func:`entry` returns the forward of
``ModelConfig()`` at full width (fp32, eval mode, seeded weights) and its
batch-8 example inputs. :func:`dryrun_multichip` runs one full train step
(both forwards, the three losses, AdamW, the BatchNorm statistics) over
``n`` ranks on the JAX file's tiny geometry, checks it, then runs the three
serving paths through an engine over ``n`` devices and holds each against
one device.

JAX runs the dry run in one process over an ``n``-device mesh, and
re-executes itself on ``n`` virtual CPU devices when the process sees
fewer. Torch trains one process per rank: the step runs on NCCL over
``cuda:0 .. n-1`` when this process sees ``n`` cards, otherwise on ``n``
gloo ranks on the CPU (``parallel/mesh.py::run_group``). The report says
which, and so does a line on stderr. The serving paths run in this process
over ``[cuda:0] * n`` (``[cpu] * n`` with ``device_type="cpu"``).
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# The JAX file's dry-run geometry: full widths, tiny clips.
DRYRUN_GEOMETRY = dict(video_frames=4, crop_size=32, mel_bins=80,
                       audio_frames=16)


def entry(device=None):
    """The flagship forward at its canonical shapes: ``(forward, (visual,
    audio))``, ``forward(visual, audio) -> (B,)`` fp32 logits of
    ``ModelConfig()`` in eval mode on seeded weights, and batch-8 zero
    inputs, all on ``device`` (cuda:0 unless the caller asks for the
    CPU)."""
    from lipsync_tpu_torch.models import (
        LipSyncModel,
        ModelConfig,
        seeded_state_dict,
    )
    from lipsync_tpu_torch.models.lip_sync_model import example_inputs
    from lipsync_tpu_torch.utils.device import disable_tf32, get_device

    dev = get_device(device)
    disable_tf32()
    cfg = ModelConfig()
    model = LipSyncModel(cfg)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    model.to(dev).eval()
    visual, audio = example_inputs(cfg, batch=8, device=dev)

    def forward(visual, audio):
        with torch.inference_mode():
            return model(visual, audio)

    return forward, (visual, audio)


def _initialized_device_count() -> int:
    """The cards this process sees (0 without CUDA), counted without
    creating a CUDA context."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _train_rank(rank: int, device: torch.device, work: str) -> None:
    """One rank of the dry run's train step: its block of the global batch,
    the BatchNorms over every rank's rows; rank 0 writes the step's
    results."""
    from lipsync_tpu_torch.models import LipSyncModel, ModelConfig
    from lipsync_tpu_torch.parallel import mesh as mesh_lib
    from lipsync_tpu_torch.training.optimizers import PhaseOptimizer
    from lipsync_tpu_torch.training.steps import (
        LossConfig,
        create_train_state,
        make_train_step,
    )

    inputs = torch.load(Path(work) / "inputs.pt")
    shard = mesh_lib.process_shard()
    model = LipSyncModel(ModelConfig(**DRYRUN_GEOMETRY))
    model.load_state_dict(inputs["weights"], strict=True)
    model.to(device)
    # optax.adamw(1e-4, weight_decay=1e-4): AdamW over every parameter.
    optimizer = PhaseOptimizer(model.named_parameters(), 3, lr_head=1e-4,
                               lr_encoder=1e-4, kind="adamw",
                               weight_decay=1e-4)
    state = create_train_state(model, optimizer, seed=0, shard=shard)
    batch = mesh_lib.shard_rows(inputs["batch"], shard.rank, shard.world)
    torch.manual_seed(0)  # dropout: the same masks on every rank
    metrics = make_train_step(LossConfig())(
        state, {k: v.to(device) for k, v in batch.items()})
    if rank == 0:
        torch.save({"step": state.step, "loss": float(metrics["loss"]),
                    "state_dict": {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()}},
                   Path(work) / "rank0.pt")


def dryrun_multichip(n_devices: int, device_type: Optional[str] = None
                     ) -> dict:
    """One full train step over ``n_devices`` ranks (data parallel: the
    weights replicated, the batch of ``2 * n_devices`` split by rank, the
    gradients summed), checked for ``step == 1``, a finite loss and finite
    parameters; then, through an engine over ``n_devices`` devices on the
    stepped weights (fp32): one ragged ``score_logits`` of ``n + 1``
    windows (fewer than the rows of a bucket split over the devices), one
    ``dispatch_track_logits`` and one shared-encoding
    ``score_track_logits``, each checked for finite logits of its shape
    and read against the same call on one device. ``device_type`` is
    "cuda" (the default; raises without CUDA) or "cpu". Returns the
    report: where the step ran, its loss, and each serving path's shape
    and largest difference from one device."""
    from lipsync_tpu_torch.inference.engine import ScoringEngine
    from lipsync_tpu_torch.models import (
        LipSyncModel,
        ModelConfig,
        seeded_state_dict,
    )
    from lipsync_tpu_torch.parallel import mesh as mesh_lib
    from lipsync_tpu_torch.utils.device import get_device

    serve_on = get_device(device_type)
    on_cards = (serve_on.type == "cuda"
                and _initialized_device_count() >= n_devices)
    train_type = "cuda" if on_cards else "cpu"
    train_devices = ([f"cuda:{i}" for i in range(n_devices)] if on_cards
                     else ["cpu"] * n_devices)
    backend = "nccl" if on_cards else "gloo"
    print(f"dryrun_multichip: the train step on {n_devices} {backend} "
          f"ranks ({', '.join(train_devices)}); serving over "
          f"[{serve_on}] * {n_devices}", file=sys.stderr, flush=True)

    cfg = ModelConfig(**DRYRUN_GEOMETRY)
    batch_size = 2 * n_devices
    rng = np.random.RandomState(0)
    batch = {
        "visual": torch.from_numpy(rng.rand(batch_size, 4, 32, 32, 3)
                                   .astype(np.float32)),
        "audio": torch.from_numpy((rng.rand(batch_size, 80, 16, 1) * 80.0
                                   - 80.0).astype(np.float32)),
        "label": torch.from_numpy((np.arange(batch_size) % 2)
                                  .astype(np.float32)),
    }
    with tempfile.TemporaryDirectory() as work:
        torch.save({"weights": seeded_state_dict(LipSyncModel(cfg), 0),
                    "batch": batch}, Path(work) / "inputs.pt")
        mesh_lib.run_group(_train_rank, n_devices, train_type,
                           f"file://{work}/store", args=(work,))
        stepped = torch.load(Path(work) / "rank0.pt")
    if stepped["step"] != 1:
        raise RuntimeError(f"the train step counted {stepped['step']}")
    if not np.isfinite(stepped["loss"]):
        raise RuntimeError(f"non-finite loss {stepped['loss']}")
    bad = [k for k, v in stepped["state_dict"].items()
           if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        raise RuntimeError(f"non-finite parameters after the step: {bad}")

    weights = stepped["state_dict"]
    mesh = [serve_on] * n_devices

    def engines(**kw):
        return (ScoringEngine(weights, cfg, mesh=mesh, use_bfloat16=False,
                              max_batch=batch_size, **kw),
                ScoringEngine(weights, cfg, use_bfloat16=False,
                              max_batch=batch_size, device=serve_on, **kw))

    def held(name, calls, n):
        sharded, one = (np.asarray(c(), np.float32)[:n] for c in calls)
        if sharded.shape != (n,) or not np.isfinite(sharded).all():
            raise RuntimeError(f"{name}: logits {sharded.shape}, finite "
                               f"{bool(np.isfinite(sharded).all())}")
        return {"shape": list(sharded.shape),
                "max_abs_vs_one_device": float(np.abs(sharded - one).max())}

    engine, one = engines()
    # 1. batched window scoring, ragged: n + 1 windows in a bucket split
    # over the devices.
    n_windows = n_devices + 1
    vis = np.zeros((n_windows, cfg.video_frames, cfg.crop_size,
                    cfg.crop_size, 3), np.float32)
    aud = np.zeros((n_windows, cfg.mel_bins, cfg.audio_frames), np.float32)
    serving = {"score_logits": held(
        "score_logits", [lambda e=e: e.score_logits(vis, aud)
                         for e in (engine, one)], n_windows)}
    # 2. the track dispatch (long-video path): crops uploaded once, the
    # windows gathered on the device.
    n_frames = cfg.video_frames + 4
    crops = np.zeros((n_frames, cfg.crop_size, cfg.crop_size, 3), np.uint8)
    starts = list(range(min(4, n_frames - cfg.video_frames + 1)))
    aw = np.zeros((len(starts), cfg.mel_bins, cfg.audio_frames, 1),
                  np.float32)
    serving["dispatch_track_logits"] = held(
        "dispatch_track_logits",
        [lambda e=e: e.dispatch_track_logits(crops, starts, aw).cpu()
         for e in (engine, one)], len(starts))
    # 3. shared-track encoding: the frames split over the devices.
    shared, shared_one = engines(shared_visual_encoding=True)
    serving["shared_score_track_logits"] = held(
        "shared_score_track_logits",
        [lambda e=e: e.score_track_logits(crops, starts, aw)
         for e in (shared, shared_one)], len(starts))
    return {"n_devices": n_devices,
            "train_step": {"backend": backend, "devices": train_devices,
                           "batch": batch_size, "step": stepped["step"],
                           "loss": stepped["loss"]},
            "serving": {"devices": [str(d) for d in mesh], **serving}}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
