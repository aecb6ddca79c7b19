"""Recorder sinks (own copy of border_tpu/record/recorder.py).

≙ border-core Recorder trait (record/recorder.rs:26-108) with the Null
(null_recorder.rs) and Buffered (buffered_recorder.rs) implementations.
Model saving through the recorder (``save_model``/``load_model``) and the
Tensorboard/MLflow sinks come with the checkpoint slice (ROADMAP A.7).
"""

from __future__ import annotations

from typing import List

from border_tpu_torch.record.record import Record, RecordStorage


class Recorder:
    """Base recorder: write (immediate), store (buffer), flush (aggregate)."""

    def __init__(self) -> None:
        self._storage = RecordStorage()

    def write(self, record: Record) -> None:
        raise NotImplementedError

    def store(self, record: Record) -> None:
        self._storage.store(record)

    def flush(self, step: int) -> None:
        record = self._storage.aggregate()
        if not record.is_empty():
            record["opt_steps"] = float(step)
            self.write_at(record, step)

    def write_at(self, record: Record, step: int) -> None:
        self.write(record)

    def close(self) -> None:
        pass


class NullRecorder(Recorder):
    """Discards everything (≙ NullRecorder)."""

    def write(self, record: Record) -> None:
        pass

    def flush(self, step: int) -> None:
        self._storage.aggregate()


class BufferedRecorder(Recorder):
    """Keeps every written record in memory (≙ BufferedRecorder)."""

    def __init__(self) -> None:
        super().__init__()
        self.records: List[Record] = []

    def write(self, record: Record) -> None:
        self.records.append(record)

    def scalars(self, key: str) -> List[float]:
        return [r.get_scalar(key) for r in self.records if key in r]
