"""Offline dataset ingestion (≙ border_tpu/data): corpora to replay
buffers, the Minari/D4RL dataset layer, normalized-score evaluation."""

from border_tpu_torch.data.datasets import (  # noqa: F401
    NormalizedEvaluator,
    OfflineDataset,
    collect_dataset,
    normalized_score,
)
from border_tpu_torch.data.minari import (  # noqa: F401
    GoalDictConverter,
    MinariConverter,
    MinariDataset,
    converter_for,
    list_local_datasets,
)
