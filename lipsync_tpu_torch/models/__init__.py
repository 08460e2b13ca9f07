from lipsync_tpu_torch.models.bridge import (
    bn_calibrated_state_dict,
    seeded_state_dict,
    unwrap_state_dict,
    variables_to_state_dict,
)
from lipsync_tpu_torch.models.lip_sync_model import LipSyncModel, ModelConfig

__all__ = [
    "LipSyncModel",
    "ModelConfig",
    "bn_calibrated_state_dict",
    "seeded_state_dict",
    "unwrap_state_dict",
    "variables_to_state_dict",
]
