"""Batched window scoring engine.

Counterpart of ``inference/engine.py`` in the JAX package: every window of
a request goes through one batched forward, padded to a power-of-two
bucket by repeating the last row. Pixels travel as uint8 (``x*255+0.5``
rounding on the host, ``/255`` on the device), and the long-video path
uploads a track's crops once and gathers its overlapping windows on the
device. The forward runs under ``torch.inference_mode()``; on CUDA it runs
in bf16 by default (``use_bfloat16=None``), on the CPU in fp32.

The JAX engine's single-device serving options, each off by default:
``shared_visual_encoding`` (the long path encodes a track's frames once and
gathers every window's features), ``quantized_int8`` (encoder convolutions
int8 x int8 -> int32 through K3, ``ModelConfig.conv_lowering="int8"``) and
``fold_hf_stem`` (the HF stem's Laplacian composed into its conv1,
``ModelConfig.hf_stem_fold``). Each loads the same state dict.

``mesh`` (data parallelism, ``parallel/mesh.py``) is a list of devices: the
engine keeps one replica of the model per distinct device and splits every
bucket, rounded up to a multiple of the mesh's size, into contiguous shards
in device order, as the JAX engine's batch sharding does. The per-window
track path uploads the crops to every device and shards the windows. Under
shared encoding the track's frames shard instead, padded to a multiple of
the mesh: each shard encodes its frames plus a halo of the visual
encoder's temporal reach (``VisualEncoder.temporal_halo``) and keeps its
own, which is the whole-track encode; the windows then shard over the
gathered features. Under ``quantized_int8`` the shards run in lockstep, one
thread each, so that every convolution's activation scale is the abs-max of
the whole bucket (``parallel.mesh.Lockstep``).

The engine turns TF32 off for the process (``utils/device.disable_tf32``):
its fp32 stages run in fp32 on CUDA.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from lipsync_tpu_torch.inference.calibration import Calibrator
from lipsync_tpu_torch.models.bridge import (
    unwrap_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import checkpoints
from lipsync_tpu_torch.utils.device import (
    DeviceLike,
    disable_tf32,
    get_device,
)
from lipsync_tpu_torch.utils.weights import default_checkpoint

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _bucket_batch(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    top = _BATCH_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(x.astype(np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to ``n`` rows by repeating the last row."""
    if x.shape[0] == n:
        return x
    return np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], axis=0)])


def _as_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A port/reference state dict (tensors or arrays), or a JAX-layout
    ``{"params", "batch_stats"}`` tree through the bridge."""
    if "params" in variables:
        return variables_to_state_dict(variables)
    return {
        k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        for k, v in unwrap_state_dict(variables).items()
    }


class ScoringEngine:
    """Owns the model and its weights on one device, or a replica on each
    device of ``mesh``."""

    def __init__(
        self,
        variables: Mapping[str, Any],
        config: ModelConfig = ModelConfig(),
        calibrator: Optional[Calibrator] = None,
        use_bfloat16: Optional[bool] = None,
        mesh: Optional[Sequence[DeviceLike]] = None,
        max_batch: int = 256,
        shared_visual_encoding: bool = False,
        quantized_int8: bool = False,
        fold_hf_stem: bool = False,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            self.mesh: Optional[List[torch.device]] = [
                get_device(d) for d in mesh]
            self.device = self.mesh[0]
        else:
            self.mesh = None
            self.device = get_device(device)
        disable_tf32()
        if use_bfloat16 is None:
            use_bfloat16 = self.device.type == "cuda"
        dtype = torch.bfloat16 if use_bfloat16 else torch.float32
        if fold_hf_stem:
            config = dataclasses.replace(config, hf_stem_fold=True)
        if quantized_int8:
            config = dataclasses.replace(config, conv_lowering="int8")
        self.shared_visual_encoding = bool(shared_visual_encoding)
        self.quantized_int8 = bool(quantized_int8)
        self.config = config
        self.model = LipSyncModel(config, dtype=dtype)
        self.model.load_state_dict(_as_state_dict(variables), strict=True)
        self.model.to(self.device).eval()
        self._replicas = {self.device: self.model}
        for d in mesh_lib.distinct(self.mesh or [])[1:]:
            self._replicas[d] = copy.deepcopy(self.model).to(d)
        self.calibrator = calibrator or Calibrator()
        self.max_batch = int(max_batch)
        # Groups a streaming caller keeps enqueued before reading one back.
        self.max_in_flight = 2

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The loaded weights (the model's ``state_dict``), on the device."""
        return self.model.state_dict()

    @staticmethod
    def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def _bucket(self, n: int) -> int:
        """``n`` rounded up to its bucket, and on a mesh to a multiple of
        the mesh's size (at least one row per shard)."""
        bucket = _bucket_batch(n)
        if self.mesh is not None:
            k = len(self.mesh)
            bucket = mesh_lib.pad_to_multiple(max(bucket, k), k)
        return bucket

    def _run_shards(self, calls: List[Callable[[], Any]]) -> List[Any]:
        """Run one call per shard under ``torch.inference_mode``: in
        lockstep threads for the int8 lowering (its scales reduce over
        every shard), in order otherwise (CUDA launches are asynchronous,
        so the devices of a mesh still overlap)."""

        def in_mode(call):
            def run():
                with torch.inference_mode():
                    return call()
            return run

        calls = [in_mode(c) for c in calls]
        if self.quantized_int8 and len(calls) > 1:
            return mesh_lib.Lockstep(len(calls)).run(calls)
        return [c() for c in calls]

    def _over_rows(self, n: int, fn) -> torch.Tensor:
        """``fn(model, device, lo, hi)`` over the mesh's contiguous shards
        of ``n`` rows (all of them on one device), concatenated on the
        first device."""
        if self.mesh is None:
            return self._run_shards([lambda: fn(self.model, self.device,
                                                0, n)])[0]
        bounds = mesh_lib.shard_bounds(n, len(self.mesh))
        outs = self._run_shards([
            (lambda d=d, lo=lo, hi=hi: fn(self._replicas[d], d, lo, hi))
            for d, (lo, hi) in zip(self.mesh, bounds)])
        return torch.cat([o.to(self.device) for o in outs])

    # ------------------------------------------------------------------
    def dispatch_logits(self, visual: np.ndarray,
                        audio: np.ndarray) -> torch.Tensor:
        """Pad, bucket, upload and run one group of ``n <= max_batch``
        windows; returns the bucket's device logits without waiting for
        them (slice ``[:n]`` after reading back)."""
        n = visual.shape[0]
        if audio.ndim == 3:
            audio = audio[..., None]  # (N, F, T_a, 1)
        bucket = self._bucket(n)
        visual, audio = _pad_rows(visual, bucket), _pad_rows(audio, bucket)
        if visual.dtype != np.uint8:
            visual = _to_uint8(visual)
        audio = audio.astype(np.float32, copy=False)

        def run(model, dev, lo, hi):
            v = self._upload(visual[lo:hi], dev)
            return model(v.float() / 255.0, self._upload(audio[lo:hi], dev))

        return self._over_rows(bucket, run)

    @staticmethod
    def _read_back(groups) -> np.ndarray:
        """Read back ``(device logits, n)`` groups in order."""
        return np.concatenate([d[:n].cpu().numpy() for d, n in groups])

    def score_logits(self, visual: np.ndarray,
                     audio: np.ndarray) -> np.ndarray:
        """``(N, T, H, W, 3)`` visual + ``(N, F, T_a[, 1])`` mel -> ``(N,)``
        fp32 logits, in groups of ``max_batch``."""
        n = visual.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        groups = (
            (self.dispatch_logits(visual[i : i + self.max_batch],
                                  audio[i : i + self.max_batch]),
             min(self.max_batch, n - i))
            for i in range(0, n, self.max_batch)
        )
        return self._read_back(groups)

    def score_probs(self, visual: np.ndarray, audio: np.ndarray) -> np.ndarray:
        """Calibrated P(REAL) per window."""
        return self.calibrator(self.score_logits(visual, audio))

    # ------------------------------------------------------------------
    def score_track_logits(
        self,
        crops: np.ndarray,
        starts: Sequence[int],
        audio_windows: np.ndarray,
    ) -> np.ndarray:
        """Score a track's sliding windows with on-device gathering.

        crops: ``(N, crop, crop, 3)`` float32 in [0, 1] or uint8, the whole
            track, uploaded once per group.
        starts: window start indices into the track.
        audio_windows: ``(W, F, T_a[, 1])`` aligned mel windows.
        """
        w = len(starts)
        if w == 0:
            return np.zeros((0,), np.float32)
        groups = (
            (self.dispatch_track_logits(crops, starts[i : i + self.max_batch],
                                        audio_windows[i : i + self.max_batch]),
             len(starts[i : i + self.max_batch]))
            for i in range(0, w, self.max_batch)
        )
        return self._read_back(groups)

    def dispatch_track_logits(
        self,
        crops: np.ndarray,
        starts: Sequence[int],
        audio_windows: np.ndarray,
    ) -> torch.Tensor:
        """Upload one group's crops (uint8, padded to ``video_frames * 2^k``
        frames with the last frame, and on a shared-encoding mesh to a
        multiple of its size) and starts, gather the windows on the device
        and run the forward; returns the device logits without waiting for
        them."""
        w = len(starts)
        chunk = self.config.video_frames
        if audio_windows.ndim == 3:
            audio_windows = audio_windows[..., None]
        if crops.dtype != np.uint8:
            crops = _to_uint8(crops)
        n_needed = max(crops.shape[0], max(starts) + chunk)
        n_pad = chunk
        while n_pad < n_needed:
            n_pad *= 2
        if self.mesh is not None and self.shared_visual_encoding:
            n_pad = mesh_lib.pad_to_multiple(n_pad, len(self.mesh))
        crops = _pad_rows(crops, n_pad)
        bucket = self._bucket(w)
        starts_arr = np.zeros(bucket, np.int64)
        starts_arr[:w] = np.asarray(starts, np.int64)
        audio_windows = _pad_rows(audio_windows, bucket).astype(
            np.float32, copy=False)
        on = {d: self._upload(crops, d) for d in self._replicas}

        def window_idx(dev, lo, hi):
            return (self._upload(starts_arr[lo:hi], dev)[:, None]
                    + torch.arange(chunk, device=dev))

        if not self.shared_visual_encoding:
            def run(model, dev, lo, hi):
                windows = on[dev][window_idx(dev, lo, hi)].float() / 255.0
                return model(windows, self._upload(audio_windows[lo:hi], dev))

            return self._over_rows(bucket, run)
        # Shared-track encoding: the visual encoder has no temporal stride,
        # so the whole padded track is encoded once and every window
        # gathers its frames' features. As in the JAX engine, interior
        # windows then see real neighbour frames in the temporal
        # convolutions where the per-window path pads with zeros; a
        # one-window track is the per-window function.
        v_feat, v_map = self._encode_track(on, n_pad)
        feats = {d: (v_feat.to(d), None if v_map is None else v_map.to(d))
                 for d in self._replicas}

        def score(model, dev, lo, hi):
            idx = window_idx(dev, lo, hi)
            vf, vm = feats[dev]
            return model.score_encoded(
                vf[idx], None if vm is None else vm[idx],
                on[dev][idx].float() / 255.0,
                self._upload(audio_windows[lo:hi], dev))

        return self._over_rows(bucket, score)

    def _encode_track(self, on: Dict[torch.device, torch.Tensor],
                      n_pad: int):
        """The visual encoder over the whole padded track: ``(n_pad, D)``
        pooled features and ``(n_pad, H', W', D)`` maps (None without the
        artifact branch), on the first device. On a mesh each shard
        encodes its frames plus ``temporal_halo`` neighbours each side
        (the track's own ends keep their zero padding) and keeps its
        own."""
        if self.mesh is None:
            feat, fmap = self._run_shards([lambda: self.model.encode_visual(
                on[self.device].float()[None] / 255.0)])[0]
            return feat[0], None if fmap is None else fmap[0]
        halo = self.model.visual_encoder.temporal_halo

        def encode(d, lo, hi):
            a, b = max(0, lo - halo), min(n_pad, hi + halo)
            with mesh_lib.owning_frames(lo - a, hi - a):
                feat, fmap = self._replicas[d].encode_visual(
                    on[d][a:b].float()[None] / 255.0)
            keep = slice(lo - a, hi - a)
            return feat[0, keep], None if fmap is None else fmap[0, keep]

        parts = self._run_shards([
            (lambda d=d, lo=lo, hi=hi: encode(d, lo, hi))
            for d, (lo, hi) in zip(self.mesh,
                                   mesh_lib.shard_bounds(n_pad,
                                                         len(self.mesh)))])
        feat = torch.cat([f.to(self.device) for f, _ in parts])
        if parts[0][1] is None:
            return feat, None
        return feat, torch.cat([m.to(self.device) for _, m in parts])

    def score_track_probs(self, crops, starts, audio_windows) -> np.ndarray:
        return self.calibrator(
            self.score_track_logits(crops, starts, audio_windows)
        )

    def warmup(self) -> None:
        """Run the canonical shapes once: the single-window forward and the
        smallest track gather (two windows over ``video_frames + 1``
        crops)."""
        cfg = self.config
        v = np.zeros((1, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3),
                     np.float32)
        a = np.zeros((1, cfg.mel_bins, cfg.audio_frames), np.float32)
        self.score_logits(v, a)
        crops = np.zeros(
            (cfg.video_frames + 1, cfg.crop_size, cfg.crop_size, 3), np.uint8
        )
        aw = np.zeros((2, cfg.mel_bins, cfg.audio_frames), np.float32)
        self.score_track_logits(crops, [0, 1], aw)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_engine(
    model_path: Optional[Path] = None,
    config: ModelConfig = ModelConfig(),
    calibrator: Optional[Calibrator] = None,
    use_bfloat16: Optional[bool] = None,
    mesh: Optional[object] = None,
    shared_visual_encoding: bool = False,
    quantized_int8: bool = False,
    fold_hf_stem: bool = False,
    device: DeviceLike = None,
) -> ScoringEngine:
    """Build an engine from a reference/port ``.pth`` state dict (raw or in
    a ``model_state_dict``/``state_dict`` wrapper), from a port checkpoint
    directory (``model.pth`` + ``metadata.json``, as the port's trainer
    writes it), or from a ``.npz`` that holds a JAX-layout variables tree
    flattened with ``/``-joined keys (``params/visual_encoder/stem/conv/
    kernel``), through the bridge. The JAX package's orbax directories
    need JAX and raise. ``model_path=None`` falls back to
    ``utils/weights.default_checkpoint()`` (``MODEL_PATH``, then the
    flagship)."""
    if model_path is None:
        model_path = default_checkpoint()
        if model_path is None:
            raise FileNotFoundError(
                "No model path given and no committed flagship checkpoint "
                "at weights/flagship"
            )
    model_path = Path(model_path)
    if not model_path.exists():
        raise FileNotFoundError(f"Model weights not found at {model_path}")
    if model_path.is_dir():
        if not checkpoints.is_checkpoint_dir(model_path):
            raise NotImplementedError(
                "orbax checkpoint directories need JAX; convert them to .npz"
            )
        variables = checkpoints.load_checkpoint(model_path)
    elif model_path.suffix == ".npz":
        with np.load(model_path) as z:
            variables = _unflatten({k: z[k] for k in z.files})
    else:
        variables = torch.load(model_path, map_location="cpu",
                               weights_only=True)
    return ScoringEngine(
        variables, config, calibrator=calibrator, use_bfloat16=use_bfloat16,
        mesh=mesh, shared_visual_encoding=shared_visual_encoding,
        quantized_int8=quantized_int8, fold_hf_stem=fold_hf_stem,
        device=device,
    )
