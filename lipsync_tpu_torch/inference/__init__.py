from lipsync_tpu_torch.inference.calibration import Calibrator  # noqa: F401
from lipsync_tpu_torch.inference.engine import (  # noqa: F401
    ScoringEngine,
    load_engine,
)
from lipsync_tpu_torch.inference.predictor import (  # noqa: F401
    Predictor,
    PredictorConfig,
)
