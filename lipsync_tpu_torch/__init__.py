"""PyTorch/CUDA port of the lip-sync deepfake detector.

Mirrors the module paths of the JAX package (``models/layers.py`` here is
the counterpart of ``models/layers.py`` there) and keeps its channels-last
layouts at every public function: ``(B, T, H, W, 3)`` video, ``(B, F, T[, 1])``
mel, ``(B, T, D)`` tokens. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The two hand-written CUDA kernels (log-mel and the
high-frequency artifact stem) live in ``csrc/`` and are built with ``nvcc``
at first use (``ops/kernels/build.py``).

This package imports ``torch`` and ``numpy`` only.
"""

from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig

__all__ = ["LipSyncModel", "ModelConfig"]
