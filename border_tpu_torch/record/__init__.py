"""Observability: Record values, aggregation, and recorder sinks:
TensorBoard event files and MLflow tracking (≙ border_tpu/record)."""

from border_tpu_torch.record.record import Record, RecordStorage  # noqa: F401
from border_tpu_torch.record.recorder import (  # noqa: F401
    BufferedRecorder,
    NullRecorder,
    Recorder,
    TensorboardRecorder,
)
from border_tpu_torch.record.mlflow import MlflowClient, MlflowRecorder  # noqa: F401
