from lipsync_tpu_torch.serving.app import AppState, Server  # noqa: F401
from lipsync_tpu_torch.serving.config import Settings, get_settings  # noqa: F401
