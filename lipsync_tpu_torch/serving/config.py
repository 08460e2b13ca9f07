"""Service settings: the JAX package's ``serving/config.py`` (the
reference's knobs, names and defaults; they are part of the behavioural
contract, since guards change verdicts) as a stdlib dataclass. Environment
overrides: ``MODEL_PATH``, ``SQLITE_DB_URL``.

One field differs: ``device`` is where the predictor runs, ``"cuda"`` by
default (``"cpu"`` on request), and is passed to ``Predictor(device=...)``;
the JAX package's is an informational ``"tpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

from lipsync_tpu_torch.inference.predictor import PredictorConfig
from lipsync_tpu_torch.serving.schemas import Model
from lipsync_tpu_torch.utils.weights import (
    default_calibration,
    default_checkpoint,
)


@dataclasses.dataclass(kw_only=True)
class Settings(Model):
    project_name: str = "Lip Sync Detection Service"
    model_path: Path = Path("weights_finetune") / "best_model_accuracy.pth"
    device: str = "cuda"
    confidence_threshold: float = 0.5
    use_bfloat16: bool = True  # informational, as in the JAX package
    uncertainty_margin: float = 0.05
    confidence_smoothing: str = "median"
    trim_ratio: float = 0.1
    max_tracks: int = 6
    refine_margin: float = 0.08
    refine_top_k: int = 2
    chunk_size: int = 32
    chunk_stride: int = 8
    long_video_threshold_sec: float = 2.0
    max_total_frames: Optional[int] = None
    confidence_margin: float = 0.10
    calibration_method: str = "none"
    calibration_temperature: float = 1.0
    calibration_platt_a: float = 1.0
    calibration_platt_b: float = 0.0
    calibration_isotonic_path: Optional[str] = None
    mouth_motion_check: bool = True
    mouth_motion_low_threshold: float = 0.015
    mouth_motion_fake_penalty: float = 0.10
    audio_energy_high_threshold: float = -25.0
    audio_energy_low_threshold: float = -50.0
    weak_real_gate: float = 0.08
    weak_real_window_threshold: float = 0.30
    fake_vote_gate: float = 0.10
    fake_vote_min_windows: int = 5
    # Host detector stride of the pipelined long path
    # (PredictorConfig.detection_stride).
    detection_stride: int = 1
    # Encode each track once and gather per-window visual features
    # (PredictorConfig.shared_visual_encoding).
    shared_visual_encoding: bool = False
    # Shard every scoring batch over the first N devices
    # (PredictorConfig.data_parallel_devices).
    data_parallel_devices: int = 0
    # int8 encoder convolutions on K3 (PredictorConfig.quantized_int8).
    quantized_int8: bool = False
    # The HF artifact stem's Laplacian composed into its conv1
    # (PredictorConfig.fold_hf_stem).
    fold_hf_stem: bool = False
    # Coalesce concurrent requests' window batches into shared forwards
    # (inference/batcher.py); the linger adds at most coalesce_max_wait_ms
    # per scoring call.
    coalesce_requests: bool = True
    coalesce_max_wait_ms: float = 2.0
    # Speaking-activity semantics (PredictorConfig.speaking_score_mode).
    speaking_score_mode: str = "alignment"
    sqlite_db_path: str = "./jobs.db"
    run_embedded_worker: bool = True
    worker_poll_interval_sec: float = 1.0
    worker_processing_timeout_sec: int = 900
    host: str = "127.0.0.1"
    port: int = 8000

    def to_predictor_config(self) -> PredictorConfig:
        return PredictorConfig(
            confidence_threshold=self.confidence_threshold,
            uncertainty_margin=self.uncertainty_margin,
            confidence_smoothing=self.confidence_smoothing,
            trim_ratio=self.trim_ratio,
            max_tracks=self.max_tracks,
            refine_margin=self.refine_margin,
            refine_top_k=self.refine_top_k,
            chunk_size=self.chunk_size,
            chunk_stride=self.chunk_stride,
            long_video_threshold_sec=self.long_video_threshold_sec,
            max_total_frames=self.max_total_frames,
            confidence_margin=self.confidence_margin,
            calibration_method=self.calibration_method,
            calibration_temperature=self.calibration_temperature,
            calibration_platt_a=self.calibration_platt_a,
            calibration_platt_b=self.calibration_platt_b,
            calibration_isotonic_path=self.calibration_isotonic_path,
            mouth_motion_check=self.mouth_motion_check,
            mouth_motion_low_threshold=self.mouth_motion_low_threshold,
            mouth_motion_fake_penalty=self.mouth_motion_fake_penalty,
            audio_energy_high_threshold=self.audio_energy_high_threshold,
            audio_energy_low_threshold=self.audio_energy_low_threshold,
            weak_real_gate=self.weak_real_gate,
            weak_real_window_threshold=self.weak_real_window_threshold,
            fake_vote_gate=self.fake_vote_gate,
            fake_vote_min_windows=self.fake_vote_min_windows,
            detection_stride=self.detection_stride,
            shared_visual_encoding=self.shared_visual_encoding,
            data_parallel_devices=self.data_parallel_devices,
            quantized_int8=self.quantized_int8,
            fold_hf_stem=self.fold_hf_stem,
            speaking_score_mode=self.speaking_score_mode,
        )


def get_settings() -> Settings:
    """``MODEL_PATH`` / ``SQLITE_DB_URL`` environment overrides (the db url
    is a bare path or a ``sqlite:///`` url).

    When neither ``MODEL_PATH`` nor the reference's default location
    exists, the committed flagship checkpoint (``weights/flagship``, with
    its fitted Platt constants) is used."""
    kwargs = {}
    if env_path := os.environ.get("MODEL_PATH"):
        kwargs["model_path"] = Path(env_path)
    else:
        default_loc = next(f.default for f in dataclasses.fields(Settings)
                           if f.name == "model_path")
        if not Path(default_loc).exists():
            if shipped := default_checkpoint():
                kwargs["model_path"] = shipped
                if cal := default_calibration():
                    kwargs.update(cal)
    if db_url := os.environ.get("SQLITE_DB_URL"):
        kwargs["sqlite_db_path"] = db_url.replace("sqlite:///", "")
    return Settings(**kwargs)
