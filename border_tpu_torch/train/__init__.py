"""Training orchestration (≙ border_tpu/train): the configuration, the
synchronous chunked Trainer and its decoupled actor-learner variant
(AsyncTrainer), the host-env trainer and evaluator, the OfflineTrainer and
the Evaluator, and the elastic supervisor that restarts a crashed run
from its latest checkpoint."""

from border_tpu_torch.train.config import TrainerConfig  # noqa: F401
from border_tpu_torch.train.evaluator import Evaluator  # noqa: F401
from border_tpu_torch.train.trainer import Trainer, TrainResult  # noqa: F401
from border_tpu_torch.train.async_trainer import AsyncTrainer  # noqa: F401
from border_tpu_torch.train.host import HostEnvTrainer, HostEvaluator  # noqa: F401
from border_tpu_torch.train.offline import OfflineTrainer  # noqa: F401
from border_tpu_torch.train.elastic import TrainingFailed, run_elastic  # noqa: F401
