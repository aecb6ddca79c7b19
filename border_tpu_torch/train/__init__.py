"""Training orchestration (≙ border_tpu/train).  Ported so far: the
configuration, the synchronous chunked Trainer, the OfflineTrainer and the
Evaluator."""

from border_tpu_torch.train.config import TrainerConfig  # noqa: F401
from border_tpu_torch.train.evaluator import Evaluator  # noqa: F401
from border_tpu_torch.train.trainer import Trainer, TrainResult  # noqa: F401
from border_tpu_torch.train.offline import OfflineTrainer  # noqa: F401
