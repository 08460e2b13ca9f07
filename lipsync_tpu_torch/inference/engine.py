"""Batched window scoring engine.

Counterpart of ``inference/engine.py`` in the JAX package: every window of
a request goes through one batched forward, padded to a power-of-two
bucket by repeating the last row. Pixels travel as uint8 (``x*255+0.5``
rounding on the host, ``/255`` on the device) unless ``transfer_uint8`` is
False, when float windows upload as fp32 and reach the forward unrounded
(uint8 windows keep the ``/255`` path); the long-video path uploads a
track's crops once, as uint8 either way, and gathers its overlapping
windows on the device. A stream of more windows than ``max_batch`` goes in
groups, and up to ``max_in_flight`` groups are dispatched before the oldest
is read back (the host pads, rounds and issues the next group's upload
before it waits for the one before). The forward runs under
``torch.inference_mode()``; on CUDA it runs in bf16 by default
(``use_bfloat16=None``), on the CPU in fp32.

On a CUDA device every upload goes through the device's pinned staging
ring of two slots (``inference/staging.py``): the host copies the group
into a free pinned slot, the device's own copy stream copies it into the
slot's device buffer, and the compute stream waits on that copy's event
alone, so the copy of group k+1 runs on the copy engine beside the
forward of group k. A dispatch holds its slots only until its forward is
enqueued, and group k+2 is staged only after group k is read back, so two
slots keep the copy beside the forward for any ``max_in_flight``. Right
after each forward the group's logits are copied into pinned memory on
the compute stream behind an event of their own, and
:meth:`ScoringEngine.read_back` waits on that event, not on the stream
(which by then holds the next group's forward).
The caller's arrays may be reused as soon as a dispatch returns. On any
other device an upload is a plain ``.to(device)`` and a read-back a plain
``.cpu()``.

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
encoder's temporal reach (the model's ``temporal_halo``) and keeps its
own, which is the whole-track encode; the windows then shard over the
gathered features. Under ``quantized_int8`` the shards run in lockstep, one
thread each, so that every convolution's activation scale is the abs-max of
the whole bucket (``parallel.mesh.Lockstep``).

The engine turns TF32 off for the process (``utils/device.disable_tf32``):
its fp32 stages run in fp32 on CUDA.

The model follows the type of ``config``: ``LipSyncModel`` for a
``ModelConfig``, AV-HuBERT LARGE with its detection head
(``models/avhubert.py``) for an ``AVHubertConfig``, Auto-AVSR's
audio-visual conformer with its detection head (``models/auto_avsr.py``)
for an ``AutoAVSRConfig``. The model says how it takes the host's crops
(its ``host_pixels``, applied after the uint8 rounding): ``LipSyncModel``
as they come, AV-HuBERT and Auto-AVSR grey, RGB ones turned grey with
cv2's luma weights; and the host's audio windows (its ``host_audio``):
log-mel ``(N, F, T_a, 1)`` for ``LipSyncModel`` and AV-HuBERT, PCM ``(N,
1, 640 T)`` for Auto-AVSR, uploaded through the same staging as the mel.
``quantized_int8`` and ``fold_hf_stem`` lower ``LipSyncModel``'s
convolutions and raise ``ValueError`` with any other configuration.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from pathlib import Path
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from lipsync_tpu_torch.inference.calibration import Calibrator
from lipsync_tpu_torch.inference.staging import CudaLink, Slot, StagingRing
from lipsync_tpu_torch.models.auto_avsr import AutoAVSR, AutoAVSRConfig
from lipsync_tpu_torch.models.avhubert import AVHubert, AVHubertConfig
from lipsync_tpu_torch.models.bridge import (
    unwrap_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig
from lipsync_tpu_torch.parallel import mesh as mesh_lib
from lipsync_tpu_torch.training import checkpoints
from lipsync_tpu_torch.utils import profiling
from lipsync_tpu_torch.utils.device import (
    DeviceLike,
    disable_tf32,
    get_device,
)
from lipsync_tpu_torch.utils.weights import default_checkpoint

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# The model each configuration type builds.
MODELS = {ModelConfig: LipSyncModel, AVHubertConfig: AVHubert,
          AutoAVSRConfig: AutoAVSR}
AnyConfig = Union[ModelConfig, AVHubertConfig, AutoAVSRConfig]
_STAGING_SLOTS = 2
# The attribute of a group's device logits that holds their pinned host copy
# and its event (CUDA only).
_READ_BACK = "_engine_read_back"


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
        config: AnyConfig = ModelConfig(),
        calibrator: Optional[Calibrator] = None,
        use_bfloat16: Optional[bool] = None,
        mesh: Optional[Sequence[DeviceLike]] = None,
        max_batch: int = 256,
        transfer_uint8: bool = True,
        shared_visual_encoding: bool = False,
        max_in_flight: int = 2,
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
        if type(config) not in MODELS:
            raise TypeError(f"no model for a {type(config).__name__}")
        if not isinstance(config, ModelConfig) and (quantized_int8
                                                    or fold_hf_stem):
            raise ValueError(
                "quantized_int8 and fold_hf_stem lower LipSyncModel's "
                f"convolutions; an {type(config).__name__} takes neither")
        if fold_hf_stem:
            config = dataclasses.replace(config, hf_stem_fold=True)
        if quantized_int8:
            config = dataclasses.replace(config, conv_lowering="int8")
        self.shared_visual_encoding = bool(shared_visual_encoding)
        self.quantized_int8 = bool(quantized_int8)
        self.config = config
        self.model = MODELS[type(config)](config, dtype=dtype)
        self.model.load_state_dict(_as_state_dict(variables), strict=True)
        self.model.to(self.device).eval()
        self._replicas = {self.device: self.model}
        for d in mesh_lib.distinct(self.mesh or [])[1:]:
            self._replicas[d] = copy.deepcopy(self.model).to(d)
        self.calibrator = calibrator or Calibrator()
        self.max_batch = int(max_batch)
        # Groups kept dispatched before the oldest is read back (1: each
        # group is read back before the next is dispatched).
        self.max_in_flight = max(1, int(max_in_flight))
        self.transfer_uint8 = bool(transfer_uint8)
        # Per CUDA device a staging ring and its copy stream, made at first
        # use.
        self._rings: Dict[torch.device, StagingRing] = {}
        self._rings_lock = threading.Lock()

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The loaded weights (the model's ``state_dict``), on the device."""
        return self.model.state_dict()

    def _ring(self, dev: torch.device) -> Optional[StagingRing]:
        """The staging ring of ``dev`` (None off CUDA)."""
        if dev.type != "cuda":
            return None
        with self._rings_lock:
            ring = self._rings.get(dev)
            if ring is None:
                ring = StagingRing(_STAGING_SLOTS, CudaLink(dev))
                self._rings[dev] = ring
        return ring

    def _upload(self, arrays: Sequence[np.ndarray], dev: torch.device,
                leases: List[Tuple[StagingRing, Slot]]
                ) -> List[torch.Tensor]:
        """Move one upload's host arrays to ``dev`` in an ``engine.upload``
        span. On CUDA they go through the device's staging ring: the span
        is opened on the copy stream and its device time is the copy (as
        the trace's host-to-device copies time it); the host's copy into
        pinned memory before it is the child span ``engine.stage``; the
        slot joins ``leases`` for :meth:`_release`, and the current stream
        waits for the copy before what follows. Elsewhere, or when another
        caller holds every slot, the arrays move with a plain
        ``.to(dev)``."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        nbytes = sum(a.nbytes for a in arrays)
        profiling.count("engine.upload_bytes", nbytes)
        ring = self._ring(dev)
        slot = None if ring is None else ring.acquire()
        if slot is None:
            with profiling.span("engine.upload", device=dev):
                return [torch.from_numpy(a).to(dev) for a in arrays]
        leases.append((ring, slot))
        with ring.link.copying(), profiling.span("engine.upload", device=dev):
            out = ring.fill(slot, arrays)
        profiling.count("engine.upload_staged_bytes", nbytes)
        ring.ready(slot, torch.cuda.current_stream(dev))
        return out

    @staticmethod
    def _release(leases: List[Tuple[StagingRing, Slot]]) -> None:
        """Hand back a dispatch's staging slots, every read of them
        enqueued on each device's current stream."""
        for ring, slot in leases:
            ring.release(slot, torch.cuda.current_stream(ring.link.device))

    @staticmethod
    def _enqueue_read_back(logits: torch.Tensor) -> torch.Tensor:
        """On CUDA, copy a group's logits into pinned memory right behind
        its forward, with an event of their own, for :meth:`read_back`."""
        if logits.device.type == "cuda":
            host = torch.empty(logits.shape, dtype=logits.dtype,
                               pin_memory=True)
            host.copy_(logits, non_blocking=True)
            done = CudaLink.event(torch.cuda.current_stream(logits.device))
            setattr(logits, _READ_BACK, (host, done))
        return logits

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

        parent = profiling.current()  # a lockstep thread's spans hang here

        def in_mode(call):
            def run():
                with profiling.adopt(parent), torch.inference_mode():
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
        them (:meth:`read_back` gives the first ``n`` on the host)."""
        with profiling.span("engine.dispatch"):
            n = visual.shape[0]
            with profiling.span("engine.pad"):
                audio = self.model.host_audio(audio)
                bucket = self._bucket(n)
                visual = _pad_rows(visual, bucket)
                audio = _pad_rows(audio, bucket)
                if visual.dtype != np.uint8:
                    visual = (_to_uint8(visual) if self.transfer_uint8
                              else visual.astype(np.float32, copy=False))
                visual = self.model.host_pixels(visual)
                audio = audio.astype(np.float32, copy=False)
            as_u8 = visual.dtype == np.uint8
            leases: List[Tuple[StagingRing, Slot]] = []

            def run(model, dev, lo, hi):
                v, a = self._upload([visual[lo:hi], audio[lo:hi]], dev,
                                    leases)
                with profiling.span("engine.forward", device=dev):
                    return model(v.float() / 255.0 if as_u8 else v, a)

            try:
                logits = self._over_rows(bucket, run)
            finally:
                self._release(leases)
            return self._enqueue_read_back(logits)

    def _stream(self, groups) -> np.ndarray:
        """Dispatch ``(dispatch, n)`` groups in order, keeping up to
        ``max_in_flight`` dispatched before the oldest is read back, and
        concatenate their first ``n`` logits."""
        out, pending = [], []
        for dispatch, n in groups:
            pending.append((dispatch(), n))
            while len(pending) >= self.max_in_flight:
                out.append(self.read_back(*pending.pop(0)))
        out.extend(self.read_back(d, k) for d, k in pending)
        return np.concatenate(out)

    @staticmethod
    def read_back(logits: torch.Tensor, n: int) -> np.ndarray:
        """The first ``n`` logits of a group from :meth:`dispatch_logits`
        or :meth:`dispatch_track_logits`, on the host: on CUDA a wait on
        the group's own read-back event, not on the stream; otherwise (or
        for logits the engine did not make, such as a new tensor built
        from them) ``logits[:n].cpu()``. On CUDA the values are those the
        group's forward wrote: an in-place edit of the device logits after
        the dispatch returned is not seen."""
        with profiling.span("engine.readback"):
            pending = getattr(logits, _READ_BACK, None)
            if pending is None:
                return logits[:n].cpu().numpy()
            host, done = pending
            done.synchronize()
            return host[:n].numpy()

    def score_logits(self, visual: np.ndarray,
                     audio: np.ndarray) -> np.ndarray:
        """``(N, T, H, W, 3)`` visual + ``(N, F, T_a[, 1])`` mel (or the
        audio the model's ``host_audio`` takes) -> ``(N,)`` fp32 logits, in
        groups of ``max_batch``, ``max_in_flight`` of them dispatched at a
        time."""
        n = visual.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        b = self.max_batch
        with profiling.span("engine.score"):
            return self._stream(
                (lambda i=i: self.dispatch_logits(visual[i : i + b],
                                                  audio[i : i + b]),
                 min(b, n - i))
                for i in range(0, n, b))

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
        audio_windows: ``(W, F, T_a[, 1])`` aligned mel windows (or the
            audio windows the model's ``host_audio`` takes).
        """
        w = len(starts)
        if w == 0:
            return np.zeros((0,), np.float32)
        b = self.max_batch
        with profiling.span("engine.score"):
            return self._stream(
                (lambda i=i: self.dispatch_track_logits(
                    crops, starts[i : i + b], audio_windows[i : i + b]),
                 len(starts[i : i + b]))
                for i in range(0, w, b))

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
        with profiling.span("engine.dispatch"):
            w = len(starts)
            chunk = self.config.video_frames
            with profiling.span("engine.pad"):
                audio_windows = self.model.host_audio(audio_windows)
                if crops.dtype != np.uint8:
                    crops = _to_uint8(crops)
                crops = self.model.host_pixels(crops)
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
            leases: List[Tuple[StagingRing, Slot]] = []
            try:
                on = {d: self._upload([crops], d, leases)[0]
                      for d in self._replicas}
                logits = self._track_forward(on, n_pad, starts_arr,
                                             audio_windows, bucket, leases)
            finally:
                self._release(leases)
            return self._enqueue_read_back(logits)

    def _track_forward(self, on: Dict[torch.device, torch.Tensor],
                       n_pad: int, starts_arr: np.ndarray,
                       audio_windows: np.ndarray, bucket: int,
                       leases: List[Tuple[StagingRing, Slot]]
                       ) -> torch.Tensor:
        """Upload each shard's window starts and mel windows, gather the
        windows from the uploaded crops ``on`` each device and run the
        forward (per window, or over the shared track encoding)."""
        chunk = self.config.video_frames

        def inputs(dev, lo, hi):
            """This shard's window starts and mel windows, uploaded."""
            return self._upload([starts_arr[lo:hi], audio_windows[lo:hi]],
                                dev, leases)

        def window_idx(starts_d, dev):
            return starts_d[:, None] + torch.arange(chunk, device=dev)

        if not self.shared_visual_encoding:
            def run(model, dev, lo, hi):
                starts_d, mel = inputs(dev, lo, hi)
                with profiling.span("engine.forward", device=dev):
                    windows = on[dev][window_idx(starts_d, dev)]
                    return model(windows.float() / 255.0, mel)

            return self._over_rows(bucket, run)
        # Shared-track encoding: the visual encoder has no temporal
        # stride, so the whole padded track is encoded once and every
        # window gathers its frames' features. As in the JAX engine,
        # interior windows then see real neighbour frames in the
        # temporal convolutions where the per-window path pads with
        # zeros; a one-window track is the per-window function.
        with profiling.span("engine.forward", device=self.device):
            v_feat, v_map = self._encode_track(on, n_pad)
            feats = {d: (v_feat.to(d),
                         None if v_map is None else v_map.to(d))
                     for d in self._replicas}

        def score(model, dev, lo, hi):
            starts_d, mel = inputs(dev, lo, hi)
            with profiling.span("engine.forward", device=dev):
                idx = window_idx(starts_d, dev)
                vf, vm = feats[dev]
                return model.score_encoded(
                    vf[idx], None if vm is None else vm[idx],
                    on[dev][idx].float() / 255.0, mel)

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
        halo = self.model.temporal_halo

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
        audio = self.model.audio_shape()
        self.score_logits(v, np.zeros((1,) + audio, np.float32))
        crops = np.zeros(
            (cfg.video_frames + 1, cfg.crop_size, cfg.crop_size, 3), np.uint8
        )
        self.score_track_logits(crops, [0, 1],
                                np.zeros((2,) + audio, np.float32))


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
    config: AnyConfig = ModelConfig(),
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
