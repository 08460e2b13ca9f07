"""End-to-end audio-visual lip-sync deepfake detection model.

Counterpart of ``models/lip_sync_model.py`` in the JAX package: visual
3D-ResNet + audio 2D-ResNet encoders, shared-embedding projection, gated
cross-modal attention, CLS temporal transformer and the artifact branch,
concatenated into the head, which emits a logit for P(REAL).

Layouts (channels-last, as in the JAX package):
  visual: ``(B, T, H, W, 3)`` float in [0, 1]
  audio:  ``(B, F, T_a, 1)``  log-mel dB
Output: ``(B,)`` fp32 logits.

``dtype=torch.bfloat16`` is the serving mode on the card. It departs from
the JAX package's cast points, which put the whole model in bf16: held
against fp32 on BatchNorm-calibrated weights, that moved P(REAL) past the
4e-3 bound the served path must meet (PERF.md). bf16 keeps 8 significant
bits, and the convolutions nearest the pixels and the log-mel dB values
are where its rounding costs most. So bf16 runs only in visual layers 3-4
and the convolutions of the artifact branch's temporal detector and
high-frequency stack (K2 included), under ``torch.autocast``, each handing
back fp32. The visual stem and layers 1-2, the audio encoder and the token
stages (projection, cross-modal attention, temporal transformer, artifact
fusion, head) run in fp32, and parameters stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from lipsync_tpu_torch.models.artifact import ArtifactDetector
from lipsync_tpu_torch.models.audio_encoder import AudioEncoder
from lipsync_tpu_torch.models.classifier import ClassificationHead
from lipsync_tpu_torch.models.fusion import (
    CrossModalAttention,
    FeatureProjection,
)
from lipsync_tpu_torch.models.temporal import TemporalTransformer
from lipsync_tpu_torch.models.visual_encoder import VisualEncoder
from lipsync_tpu_torch.utils.device import DeviceLike, get_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ``ModelConfig``: same fields, same defaults."""

    visual_feature_dim: int = 256
    audio_feature_dim: int = 256
    embed_dim: int = 256
    detect_artifacts: bool = True
    cross_modal_heads: int = 8
    temporal_layers: int = 4
    temporal_heads: int = 8
    temporal_pre_conv: bool = True
    use_delta_artifact: bool = True
    use_high_freq_artifact: bool = True
    preserve_audio_temporal: bool = True
    dropout: float = 0.1
    # Encoder conv lowering: "conv", or "int8" (dynamic post-training
    # quantization through K3, inference only; layers.int8_conv).
    conv_lowering: str = "conv"
    # Serving lowering of the HF artifact stem: the Laplacian composed into
    # conv1 (artifact.compose_spatial). Exact in the strided interior; the
    # border row and column deviate.
    hf_stem_fold: bool = False

    video_frames: int = 32
    crop_size: int = 96
    mel_bins: int = 80
    audio_frames: int = 128


class LipSyncModel(nn.Module):
    def __init__(self, config: ModelConfig = ModelConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.config, self.dtype = config, dtype
        cfg = config
        e = cfg.embed_dim
        self.visual_encoder = VisualEncoder(
            cfg.visual_feature_dim, dropout=cfg.dropout,
            conv_lowering=cfg.conv_lowering,
        )
        self.audio_encoder = AudioEncoder(
            cfg.audio_feature_dim, dropout=cfg.dropout,
            preserve_audio_temporal=cfg.preserve_audio_temporal,
            conv_lowering=cfg.conv_lowering,
        )
        self.projection = FeatureProjection(cfg.visual_feature_dim,
                                            cfg.audio_feature_dim, e)
        self.cross_modal = CrossModalAttention(e, cfg.cross_modal_heads,
                                               cfg.dropout)
        self.temporal = TemporalTransformer(
            e, cfg.temporal_heads, cfg.temporal_layers, cfg.dropout,
            pre_conv=cfg.temporal_pre_conv,
        )
        if cfg.detect_artifacts:
            self.artifact_detector = ArtifactDetector(
                cfg.visual_feature_dim, e,
                use_delta_map=cfg.use_delta_artifact,
                use_high_freq=cfg.use_high_freq_artifact,
                fold_hf_stem=cfg.hf_stem_fold,
            )
            head_in = e + e // 2
        else:
            self.artifact_detector = None
            head_in = e
        self.classifier = ClassificationHead(head_in, 128, cfg.dropout)

    @property
    def temporal_halo(self) -> int:
        """Frames on each side of a frame that its visual features depend
        on (``VisualEncoder.temporal_halo``)."""
        return self.visual_encoder.temporal_halo

    @staticmethod
    def host_pixels(crops):
        """The host's crops as this model takes them: RGB, unchanged."""
        return crops

    @staticmethod
    def host_audio(audio):
        """The host's mel windows as this model takes them: ``(N, F, T_a,
        1)``."""
        return audio[..., None] if audio.ndim == 3 else audio

    def audio_shape(self):
        """One window's mel as the host hands it over: ``(F, T_a)``."""
        return (self.config.mel_bins, self.config.audio_frames)

    def forward(
        self,
        visual: torch.Tensor,
        audio: torch.Tensor,
        return_aux: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        v_feat, v_map = self.encode_visual(visual)
        return self.score_encoded(v_feat, v_map, visual, audio,
                                  return_aux=return_aux)

    def encode_visual(
        self, visual: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(pooled (B,T,D), feature_map (B,T,H',W',D) | None)`` for
        ``(B, T, H, W, 3)`` pixels; T need not equal ``video_frames``."""
        if self.config.detect_artifacts:
            return self.visual_encoder(visual, return_map=True,
                                       dtype=self.dtype)
        return self.visual_encoder(visual, dtype=self.dtype), None

    def score_encoded(
        self,
        v_feat: torch.Tensor,
        v_map: Optional[torch.Tensor],
        raw_visual: Optional[torch.Tensor],
        audio: torch.Tensor,
        return_aux: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
        """Everything after the visual encoder: audio encoder, fusion,
        temporal transformer, artifact branch, head."""
        a_feat = self.audio_encoder(audio.to(torch.float32))
        v_emb, a_emb = self.projection(v_feat, a_feat)
        fused = self.cross_modal(v_emb, a_emb)
        cls_output = self.temporal(fused)
        if self.artifact_detector is not None:
            artifact_feat = self.artifact_detector(
                v_map, cls_output, raw_video=raw_visual.to(self.dtype)
            )
            combined = torch.cat([cls_output, artifact_feat], dim=-1)
        else:
            combined = cls_output
        logits = self.classifier(combined)
        if not return_aux:
            return logits
        return logits, {
            "visual_tokens": v_emb,
            "audio_tokens": a_emb,
            "fused_tokens": fused,
            "cls_output": cls_output,
        }


def example_inputs(
    cfg: ModelConfig = ModelConfig(), batch: int = 1,
    dtype: torch.dtype = torch.float32, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero inputs with the canonical shapes, ``(B, T, H, W, 3)`` and
    ``(B, F, T_a, 1)``, on ``get_device(device)`` (for warm-up and shape
    checks)."""
    dev = get_device(device)
    visual = torch.zeros(
        (batch, cfg.video_frames, cfg.crop_size, cfg.crop_size, 3),
        dtype=dtype, device=dev,
    )
    audio = torch.zeros((batch, cfg.mel_bins, cfg.audio_frames, 1),
                        dtype=dtype, device=dev)
    return visual, audio
