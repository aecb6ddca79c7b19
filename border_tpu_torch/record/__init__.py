"""Observability: Record values, aggregation, and recorder sinks
(≙ border_tpu/record)."""

from border_tpu_torch.record.record import Record, RecordStorage  # noqa: F401
from border_tpu_torch.record.recorder import (  # noqa: F401
    BufferedRecorder,
    NullRecorder,
    Recorder,
    TensorboardRecorder,
)
