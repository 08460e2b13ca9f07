"""Device-resident dataset cache: the whole corpus in device memory,
windows gathered on the device.

Counterpart of ``training/device_cache.py`` in the JAX package. The
preprocessed full_sequence clips (uint8 crops + mel dB) upload once; each
batch is then a gather on the device, and the host ships only ``(batch,)``
index and start arrays per step.

Sampling matches the host sampler (``sample_aligned_contiguous_clip``)
for full-length clips and reproduces its tail padding for short ones:

* visual window = ``clip[start : start + video_frames]``, ``start`` drawn
  uniformly on the host (train) or centred (eval); clips shorter than the
  window are tail-padded with their last frame at build time, which equals
  the host sampler's padding because such clips force ``start == 0``;
* mel window = ``audio[:, mel_start : mel_start + mel_len]`` with
  ``mel_start = round(start / fps * mel_hz)`` clamped to the clip's real
  mel length, then resampled to ``audio_frames`` through the same
  ``linspace`` index table; audio is tail-padded with its last column at
  build time, which equals the host sampler's pad for windows that overrun
  the clip.

In a data-parallel group (``mesh``, this process's ``ProcessShard``) the
corpus is replicated: every rank uploads all of it, as the JAX package
replicates the cache over its mesh, and draws the same global batches. A
train batch is then gathered sharded: each rank gathers only its
contiguous block of rows. Eval batches stay whole.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class DeviceDatasetCache:
    """Uploads a preprocessed full_sequence dataset to ``device`` (None:
    cuda:0, which raises without CUDA) and serves training and eval batches
    as gathers there.

    ``dataset`` is a ``LipSyncDataset`` in preprocessed mode whose records
    are all ``full_sequence``. ``mesh`` is this rank's
    ``parallel.mesh.ProcessShard`` in a data-parallel group: train batches
    then come out as this rank's rows, and ``batch_size`` must divide by
    the group's size. A cache larger than ``max_bytes`` (default 10 GB:
    room for the model, optimizer and activations) is refused.
    """

    def __init__(self, dataset, mesh: Optional[mesh_lib.ProcessShard] = None,
                 max_bytes: float = 10e9, device: DeviceLike = None):
        if mesh is not None and not isinstance(mesh, mesh_lib.ProcessShard):
            raise TypeError(f"mesh must be a ProcessShard, got {mesh!r}")
        self.mesh = mesh
        dev = get_device(device)
        if not getattr(dataset, "use_preprocessed", False):
            raise ValueError("DeviceDatasetCache needs a preprocessed "
                             "dataset (manifest-backed)")
        records = dataset._manifest
        modes = {r.get("precompute_mode", "fixed_clip") for r in records}
        if modes != {"full_sequence"}:
            raise ValueError(
                f"DeviceDatasetCache supports full_sequence records only "
                f"(got modes {sorted(modes)})"
            )
        self.video_frames = int(dataset.video_frames)
        self.audio_frames = int(dataset.audio_frames)
        self.fps = float(records[0].get("target_fps", 15.0))
        self.mel_hz = float(records[0].get("mel_hz", 100.0))
        self.mel_len = max(
            1, int(round(self.video_frames / max(self.fps, 1e-6)
                         * self.mel_hz))
        )

        visuals: List[np.ndarray] = []
        audios: List[np.ndarray] = []
        labels: List[float] = []
        for rec in records:
            v, a = dataset._load_tensors(rec)
            if a.ndim == 3:
                a = a[0]
            visuals.append(np.ascontiguousarray(v))
            audios.append(np.asarray(a, np.float32))
            labels.append(float(rec["label"]))

        n = len(visuals)
        t_len = np.asarray([v.shape[0] for v in visuals], np.int64)
        a_len = np.asarray([a.shape[1] for a in audios], np.int64)
        t_max = max(int(t_len.max()), self.video_frames)
        # A window starting at the last valid mel column may run mel_len
        # past it; the repeated last column reproduces the host pad.
        a_pad = int(a_len.max()) + self.mel_len
        h, w, c = visuals[0].shape[1:]

        vis_bytes = n * t_max * h * w * c
        aud_bytes = n * 80 * a_pad * 4
        if vis_bytes + aud_bytes > max_bytes:
            raise ValueError(
                f"Dataset too large for the device cache: "
                f"{(vis_bytes + aud_bytes) / 1e9:.1f} GB > "
                f"{max_bytes / 1e9:.1f} GB"
            )

        vis = np.empty((n, t_max, h, w, c), np.uint8)
        aud = np.empty((n, 80, a_pad), np.float32)
        for i, (v, a) in enumerate(zip(visuals, audios)):
            t = v.shape[0]
            vis[i, :t] = v
            vis[i, t:] = v[-1:]
            ta = a.shape[1]
            aud[i, :, :ta] = a
            aud[i, :, ta:] = a[:, -1:]

        self.device = dev
        self._t_len_host = t_len
        logger.info(
            "Device dataset cache: %d clips, visual %s uint8 (%.2f GB) + "
            "audio %s f32 (%.2f GB) uploaded once",
            n, vis.shape, vis_bytes / 1e9, aud.shape, aud_bytes / 1e9,
        )
        self._visual = torch.from_numpy(vis).to(dev)
        self._audio = torch.from_numpy(aud).to(dev)
        self._labels = torch.as_tensor(labels, dtype=torch.float32,
                                       device=dev)
        self._a_len = torch.from_numpy(a_len).to(dev)
        # The host sampler's resampling table: linspace(0, mel_len - 1,
        # audio_frames) truncated to integers.
        self._res_idx = torch.from_numpy(
            np.linspace(0, self.mel_len - 1, self.audio_frames)
            .astype(np.int64)).to(dev)

    def gather(self, idx: np.ndarray, starts: np.ndarray,
               mask: Optional[np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch of clips ``idx`` with windows at ``starts``, on the
        device."""
        dev = self.device
        idx_d = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
        starts_d = torch.from_numpy(np.asarray(starts, np.int64)).to(dev)
        frames = starts_d[:, None] + torch.arange(self.video_frames,
                                                  device=dev)
        visual = self._visual[idx_d[:, None], frames]
        ms = torch.round(starts_d.float() / self.fps * self.mel_hz).long()
        ms = torch.minimum(ms.clamp(min=0),
                           (self._a_len[idx_d] - 1).clamp(min=0))
        cols = ms[:, None] + self._res_idx[None, :]  # (B, audio_frames)
        audio = self._audio[idx_d[:, None, None],
                            torch.arange(80, device=dev)[None, :, None],
                            cols[:, None, :]]
        batch = {"visual": visual, "audio": audio[..., None],
                 "label": self._labels[idx_d]}
        if mask is not None:
            batch["sample_mask"] = torch.from_numpy(mask).to(dev)
        return batch

    def batches(
        self,
        indices: Sequence[int],
        batch_size: int,
        rng: Optional[np.random.RandomState] = None,
        train_mode: bool = True,
        shuffle: Optional[bool] = None,
        pad_to_full: Optional[bool] = None,
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield on-device batch dicts for one epoch over ``indices``.

        Train mode pads the ragged final batch to ``batch_size`` with a
        ``sample_mask`` (one shape per epoch; the train step's masked
        losses and accuracy ignore pad rows), and on a mesh yields this
        rank's rows of it. Eval mode yields the ragged tail as it is, as
        ``BatchLoader`` does.
        """
        shard = self.mesh if train_mode else None
        if shard is not None and batch_size % shard.world:
            raise ValueError(f"batch size {batch_size} does not split over "
                             f"{shard.world} ranks")
        rng = rng or np.random.RandomState(0)
        shuffle = train_mode if shuffle is None else shuffle
        pad_to_full = train_mode if pad_to_full is None else pad_to_full
        idx = np.asarray(indices, np.int32)
        if shuffle:
            idx = idx[rng.permutation(len(idx))]
        vf = self.video_frames
        for lo in range(0, len(idx), batch_size):
            ib = idx[lo: lo + batch_size]
            b = len(ib)
            t = self._t_len_host[ib]
            if train_mode:
                hi = np.maximum(t - vf, 0) + 1
                starts = (rng.rand(b) * hi).astype(np.int32)
            else:
                starts = (np.maximum(t - vf, 0) // 2).astype(np.int32)
            mask = None
            if pad_to_full and b < batch_size:
                pad_n = batch_size - b
                ib = np.concatenate([ib, np.repeat(ib[-1:], pad_n)])
                starts = np.concatenate(
                    [starts, np.repeat(starts[-1:], pad_n)]
                )
                mask = np.zeros((batch_size,), np.float32)
                mask[:b] = 1.0
            elif pad_to_full:
                mask = np.ones((batch_size,), np.float32)
            if shard is not None:
                lo, hi = mesh_lib.shard_bounds(len(ib), shard.world)[
                    shard.rank]
                ib, starts = ib[lo:hi], starts[lo:hi]
                mask = None if mask is None else mask[lo:hi]
            yield self.gather(ib, starts, mask)
