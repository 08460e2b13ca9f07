"""Training data pipeline: discovery, windowing, augmentation, batching.

Counterpart of ``training/data.py`` in the JAX package (the reference's
dataset, augmentation and collate modules in channels-last layouts):

* ``discover_video_samples``: the reference's directory/label heuristics
  (1 = REAL, 0 = FAKE).
* ``sample_aligned_contiguous_clip``: the full_sequence window sampler
  with mel alignment ``mel_start = start / fps * 100 Hz``.
* ``LipSyncDataset``: raw-video mode (native ingest, tracker, crops and
  log-mel on ``device``: K1 runs there on a CUDA device) and preprocessed
  mode (``manifest.jsonl`` + npy files, a zarr group or a kvlite file).
  A sample that cannot be used returns None and is skipped end to end:
  in raw mode only a file that ingest could not read or that has no audio
  (a kernel failure propagates and ends the run).
* ``Augmentations``: shape-preserving speed warp, h-flip, rotation,
  brightness/contrast, Gaussian noise on the host. The rotation is
  scipy's (the JAX package takes cv2 where it imports, scipy elsewhere).
* ``BatchLoader``: shuffling, None-dropping host loader with a background
  prefetch thread, so that device steps overlap host decode.

The zarr and lmdb formats are read by the port's own wheel-free readers
(``utils/zarrlite.py``, ``utils/kvlite.py``), as the JAX package reads them
where the wheels are absent.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from lipsync_tpu_torch.utils.device import DeviceLike, get_device
from lipsync_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi")


def _is_video(path: Path) -> bool:
    return path.suffix.lower() in VIDEO_EXTENSIONS


def discover_video_samples(data_dir: Path) -> List[Tuple[Path, int]]:
    """Label inference: 0_real/1_fake dirs, else parent-name heuristics."""
    data_dir = Path(data_dir)
    samples: List[Tuple[Path, int]] = []

    def find_subdir(*names: str):
        lowered = {n.lower() for n in names}
        for n in names:
            p = data_dir / n
            if p.is_dir():
                return p
        for c in data_dir.iterdir():
            if c.is_dir() and c.name.lower() in lowered:
                return c
        return None

    real_dir = find_subdir("0_real", "real")
    fake_dir = find_subdir("1_fake", "fake")
    if real_dir is not None and fake_dir is not None:
        for p in sorted(real_dir.iterdir()):
            if p.is_file() and _is_video(p):
                samples.append((p, 1))
        for p in sorted(fake_dir.iterdir()):
            if p.is_file() and _is_video(p):
                samples.append((p, 0))
        return samples

    for p in sorted(data_dir.rglob("*")):
        if p.is_file() and _is_video(p):
            parent = p.parent.name.lower()
            if any(k in parent for k in ("real", "authentic", "natural")):
                label = 1
            elif any(
                k in parent
                for k in ("fake", "manipulated", "ai", "wav2lip", "deepfake")
            ):
                label = 0
            else:
                label = 1
            samples.append((p, label))
    return samples


def sample_aligned_contiguous_clip(
    visual_seq: np.ndarray,
    audio_seq: np.ndarray,
    video_frames: int = 32,
    audio_frames: int = 128,
    target_fps: float = 15.0,
    mel_hz: float = 100.0,
    train_mode: bool = True,
    rng: Optional[np.random.RandomState] = None,
    keep_uint8: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """full_sequence window sampler.

    visual_seq: (T, H, W, C) uint8; audio_seq: (80, T_a) dB.
    Returns visual (video_frames, H, W, C) float32 [0,1] — or raw uint8
    pixels with ``keep_uint8`` (4x less host copy/stack work; the device
    train step normalizes) — and audio (80, audio_frames) float32.
    Raises on clips shorter than half a window.
    """
    if rng is None:
        rng = np.random
    if visual_seq.ndim != 4:
        raise ValueError(f"Expected (T,H,W,C), got {visual_seq.shape}")
    if audio_seq.ndim == 3:
        audio_seq = audio_seq[0]
    if audio_seq.shape[0] != 80:
        raise ValueError(f"Expected 80 mel bins, got {audio_seq.shape}")

    t_total = visual_seq.shape[0]
    min_frames = max(4, video_frames // 2)
    if t_total < min_frames:
        raise ValueError(
            f"Visual sequence too short ({t_total} frames < minimum "
            f"{min_frames}). Sample skipped."
        )

    if t_total > video_frames:
        start = (
            int(rng.randint(0, t_total - video_frames + 1))
            if train_mode
            else (t_total - video_frames) // 2
        )
        visual_win = visual_seq[start : start + video_frames]
    else:
        start = 0
        pad_n = video_frames - t_total
        visual_win = (
            np.concatenate(
                [visual_seq, np.repeat(visual_seq[-1:], pad_n, axis=0)], axis=0
            )
            if pad_n > 0
            else visual_seq
        )

    if keep_uint8 and visual_win.dtype == np.uint8:
        visual = visual_win
    else:
        visual = visual_win.astype(np.float32) / 255.0

    a_total = audio_seq.shape[1]
    mel_start = int(round((start / max(target_fps, 1e-6)) * mel_hz))
    mel_len = max(1, int(round((video_frames / max(target_fps, 1e-6)) * mel_hz)))
    mel_start = max(0, min(mel_start, max(0, a_total - 1)))
    mel_end = min(a_total, mel_start + mel_len)
    mel_win = audio_seq[:, mel_start:mel_end]
    if mel_win.shape[1] == 0:
        mel_win = np.repeat(audio_seq[:, -1:], 1, axis=1)
    if mel_win.shape[1] < mel_len:
        pad = np.repeat(mel_win[:, -1:], mel_len - mel_win.shape[1], axis=1)
        mel_win = np.concatenate([mel_win, pad], axis=1)
    if mel_win.shape[1] != audio_frames:
        idx = np.linspace(0, mel_win.shape[1] - 1, audio_frames).astype(np.int64)
        mel_win = mel_win[:, idx]
    return visual, mel_win.astype(np.float32)


@dataclasses.dataclass
class Augmentations:
    """Shape-preserving augmentations.

    Operate on native layouts: visual (T, H, W, C) in [0, 1],
    audio (80, T_a) dB.
    """

    speed_range: Tuple[float, float] = (0.9, 1.1)
    rotation_deg: float = 15.0
    enabled: bool = True

    def __call__(
        self,
        visual: np.ndarray,
        audio: np.ndarray,
        rng: Optional[np.random.RandomState] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if not self.enabled:
            return visual, audio
        if rng is None:
            rng = np.random

        # Temporal speed warp, fixed output shapes.
        speed = float(rng.uniform(*self.speed_range))
        if speed != 1.0:
            t = visual.shape[0]
            idx = np.clip(
                np.linspace(0, t - 1, t) * speed, 0, t - 1
            ).astype(np.int64)
            visual = visual[idx]
            t_a = audio.shape[1]
            idx_a = np.clip(
                np.linspace(0, t_a - 1, t_a) * speed, 0, t_a - 1
            ).astype(np.int64)
            audio = audio[:, idx_a]

        # Horizontal flip (50%).
        if rng.rand() > 0.5:
            visual = visual[:, :, ::-1, :].copy()

        # Rotation ±15° with reflect border.
        angle = float(rng.uniform(-self.rotation_deg, self.rotation_deg))
        if abs(angle) > 1e-3:
            visual = _rotate_clip(visual, angle)

        # Brightness / contrast jitter.
        if rng.rand() > 0.5:
            visual = np.clip(visual * rng.uniform(0.8, 1.2), 0, 1)
        if rng.rand() > 0.5:
            contrast = rng.uniform(0.8, 1.2)
            mean = visual.mean()
            visual = np.clip((visual - mean) * contrast + mean, 0, 1)

        # Gaussian noise (visual [0,1]; audio clipped to the dB range).
        if rng.rand() > 0.5:
            visual = np.clip(
                visual + rng.normal(0, 0.02, visual.shape), 0, 1
            ).astype(np.float32)
        if rng.rand() > 0.5:
            audio = np.clip(
                audio + rng.normal(0, 0.01, audio.shape), -80.0, 0.0
            ).astype(np.float32)
        return visual.astype(np.float32), audio.astype(np.float32)


def _rotate_clip(visual: np.ndarray, angle: float) -> np.ndarray:
    """Rotate every frame by ``angle`` degrees about the centre, reflecting
    at the border: ``cv2.warpAffine`` where cv2 imports, as the JAX package
    does, else ``scipy.ndimage.rotate`` (the same rotation, with another
    border reflection and interpolation)."""
    try:
        import cv2
    except ImportError:
        from scipy.ndimage import rotate

        return rotate(
            visual, angle, axes=(2, 1), reshape=False, mode="reflect",
            order=1,
        ).astype(visual.dtype)
    t, h, w, _ = visual.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    out = np.empty_like(visual)
    for i in range(t):
        out[i] = cv2.warpAffine(visual[i], m, (w, h),
                                borderMode=cv2.BORDER_REFLECT)
    return out


class LipSyncDataset:
    """Raw-video or preprocessed training dataset.

    Samples are ``(visual (T,H,W,3) f32, audio (80,T_a) f32, label f32)``
    or None on failure (skipped by the loader). Raw mode crops and computes
    the log-mel on ``device`` (None: cuda:0, which raises without CUDA)."""

    def __init__(
        self,
        data_dir: Optional[Path] = None,
        split: Optional[str] = None,
        video_frames: int = 32,
        audio_frames: int = 128,
        preprocessed_dir: Optional[Path] = None,
        detector_backend=None,
        require_face_detection: bool = True,
        storage_format: str = "auto",
        uint8_visual: bool = False,
        device: DeviceLike = None,
    ):
        self.split = split
        self.video_frames = video_frames
        self.audio_frames = audio_frames
        # Ship raw uint8 windows (full_sequence mode) instead of float32
        # [0,1]; pairs with device-side normalization/augmentation.
        self.uint8_visual = uint8_visual
        self.backend = detector_backend
        self.require_face_detection = require_face_detection
        self.preprocessed_dir = (
            Path(preprocessed_dir) if preprocessed_dir else None
        )
        self.use_preprocessed = self.preprocessed_dir is not None
        self.storage_format = storage_format
        self._zarr_root = None
        self._lmdb_env = None
        self._failed: Dict[int, str] = {}

        if self.use_preprocessed:
            manifest = self.preprocessed_dir / "manifest.jsonl"
            if not manifest.is_file():
                raise ValueError(f"Missing preprocessed manifest: {manifest}")
            self._manifest = [
                json.loads(line)
                for line in manifest.read_text().splitlines()
                if line.strip()
            ]
            if not self._manifest:
                raise ValueError(f"Manifest is empty: {manifest}")
            self.samples = [
                (Path(r.get("source_path", r.get("key", f"sample_{i}"))),
                 int(r["label"]))
                for i, r in enumerate(self._manifest)
            ]
            if self.storage_format == "auto":
                self.storage_format = self._detect_storage_format()
            if self.storage_format not in ("npy", "zarr", "lmdb"):
                raise ValueError(
                    f"Unsupported storage_format={self.storage_format!r} "
                    "(expected npy, zarr or lmdb)"
                )
        else:
            if data_dir is None:
                raise ValueError("data_dir or preprocessed_dir required")
            self.device = get_device(device)
            self.samples = discover_video_samples(Path(data_dir))
            self._manifest = None

    def __len__(self) -> int:
        return len(self.samples)

    def get_item(
        self, idx: int, train_mode_override: Optional[bool] = None
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.float32]]:
        """One window, or None for a sample that cannot be used. In
        preprocessed mode (no kernel runs) any failure skips the sample. In
        raw-video mode only a file that a host stage could not use is
        skipped (``ingest.host_stage_failed``: ingest could not read it, or
        it has no audio); the crops and the log-mel (K1) run on the device,
        and their failures propagate."""
        try:
            if self.use_preprocessed:
                return self._load_preprocessed(idx, train_mode_override)
            return self._load_raw(idx)
        except Exception as e:
            if not self.use_preprocessed:
                from lipsync_tpu_torch.preprocessing import ingest

                if not ingest.host_stage_failed(e):
                    raise
            if idx not in self._failed:
                logger.warning("Sample %d failed: %s", idx, e)
            self._failed[idx] = str(e)
            return None

    __getitem__ = get_item

    def _load_raw(self, idx: int):
        from lipsync_tpu_torch.preprocessing import ingest
        from lipsync_tpu_torch.preprocessing.audio import preprocess_audio_pcm
        from lipsync_tpu_torch.preprocessing.video import preprocess_video

        path, label = self.samples[idx]
        visual = preprocess_video(
            path,
            use_face_detection=self.require_face_detection,
            max_frames=self.video_frames,
            backend=self.backend,
            device=self.device,
        )
        # preprocess_audio's read and its empty-signal check, with no audio
        # marked as the host stage's (its ValueError is the type a kernel
        # wrapper raises for a wrong device).
        pcm = ingest.read_audio(path, sr=16000)
        if pcm.size == 0:
            raise ingest.HostStageError(f"Empty audio signal for {path}")
        audio = preprocess_audio_pcm(pcm, target_frames=self.audio_frames,
                                     device=self.device)
        return visual, audio, np.float32(label)

    def _detect_storage_format(self) -> str:
        """Infer the store from manifest records or the on-disk layout."""
        rec0 = self._manifest[0]
        fmt = rec0.get("storage_format")
        if fmt:
            return str(fmt)
        if "visual_relpath" in rec0:
            return "npy"
        if (self.preprocessed_dir / "samples.zarr").exists():
            return "zarr"
        if (self.preprocessed_dir / "samples.lmdb").exists():
            return "lmdb"
        return "npy"

    def _init_zarr(self):
        """Open samples.zarr with the wheel-free v2 reader."""
        if self._zarr_root is None:
            from lipsync_tpu_torch.utils import zarrlite

            path = self.preprocessed_dir / "samples.zarr"
            if not path.exists():
                raise ValueError(f"Zarr path not found: {path}")
            self._zarr_root = zarrlite.open_group(path)
        return self._zarr_root

    def _init_lmdb(self):
        """Open samples.lmdb written as a kvlite (SQLite) file. A file
        written by the real lmdb wheel raises: the port reads the
        wheel-free format only."""
        if self._lmdb_env is None:
            from lipsync_tpu_torch.utils import kvlite

            path = self.preprocessed_dir / "samples.lmdb"
            if not path.exists():
                raise ValueError(f"LMDB path not found: {path}")
            if not kvlite.is_sqlite_file(path):
                raise RuntimeError(
                    f"{path} is not a kvlite (SQLite) store; re-encode "
                    "wheel-written LMDB files as kvlite"
                )
            self._lmdb_env = kvlite.open(path, readonly=True)
        return self._lmdb_env

    def _load_tensors(self, rec) -> Tuple[np.ndarray, np.ndarray]:
        if self.storage_format == "zarr":
            root = self._init_zarr()
            key = str(rec["key"])
            if key not in root:
                raise KeyError(f"Zarr key not found: {key}")
            grp = root[key]
            return grp["visual"][:], grp["audio"][:]
        if self.storage_format == "lmdb":
            import io

            env = self._init_lmdb()
            with env.begin(write=False) as txn:
                blob = txn.get(str(rec["key"]).encode("utf-8"))
            if blob is None:
                raise KeyError(f"LMDB key not found: {rec['key']}")
            with np.load(io.BytesIO(blob), allow_pickle=False) as data:
                return data["visual"], data["audio"]
        return (
            np.load(self.preprocessed_dir / rec["visual_relpath"]),
            np.load(self.preprocessed_dir / rec["audio_relpath"]),
        )

    def _load_preprocessed(self, idx: int, train_mode_override):
        rec = self._manifest[idx]
        label = np.float32(rec["label"])
        visual, audio = self._load_tensors(rec)
        mode = rec.get("precompute_mode", "fixed_clip")
        if mode == "full_sequence":
            train_default = (
                True if self.split is None else self.split == "train"
            )
            train_mode = (
                train_default
                if train_mode_override is None
                else train_mode_override
            )
            visual, audio = sample_aligned_contiguous_clip(
                visual, audio,
                video_frames=self.video_frames,
                audio_frames=self.audio_frames,
                target_fps=float(rec.get("target_fps", 15.0)),
                mel_hz=float(rec.get("mel_hz", 100.0)),
                train_mode=train_mode,
                keep_uint8=self.uint8_visual,
            )
        else:
            visual = visual.astype(np.float32, copy=False)
            audio = np.asarray(audio, np.float32)
            if audio.ndim == 3:
                audio = audio[0]
        return visual, audio, label


def safe_collate(samples) -> Optional[Dict[str, np.ndarray]]:
    """Drop None samples; None if the whole batch failed.

    uint8 visual windows stay uint8 (4x less stack/copy + host->device
    traffic; the device step normalizes)."""
    good = [s for s in samples if s is not None]
    if not good:
        return None
    visual = np.stack([s[0] for s in good])
    if visual.dtype != np.uint8:
        visual = visual.astype(np.float32, copy=False)
    return {
        "visual": visual,
        "audio": np.stack(
            [s[1] for s in good]
        )[..., None].astype(np.float32, copy=False),
        "label": np.asarray([s[2] for s in good], np.float32),
    }


class BatchLoader:
    """Shuffling epoch iterator with background prefetch.

    The detector stack is thread-safe, so one prefetch thread overlaps
    host decode with device steps.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = True,
        seed: int = 0,
        indices: Optional[Sequence[int]] = None,
        augment: Optional[Augmentations] = None,
        train_mode_override: Optional[bool] = None,
        prefetch: int = 2,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.indices = (
            list(indices) if indices is not None else list(range(len(dataset)))
        )
        self.augment = augment
        self.train_mode_override = train_mode_override
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, idx_batch) -> Optional[Dict[str, np.ndarray]]:
        samples = []
        for i in idx_batch:
            s = self.dataset.get_item(
                i, train_mode_override=self.train_mode_override
            )
            if s is not None and self.augment is not None:
                v, a = self.augment(s[0], s[1], rng=self.rng)
                s = (v, a, s[2])
            samples.append(s)
        return safe_collate(samples)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(self.indices)
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def _put(item) -> bool:
            """Bounded put that aborts when the consumer has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # The sentinel MUST land even if a batch raises (an augmentation
            # or storage error), otherwise the consumer blocks on q.get()
            # forever — try/finally guarantees termination either way.
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if not _put(self._make_batch(b)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                error.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if item is None:
                    continue  # the whole batch failed: skip it
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
        if error:
            raise error[0]
