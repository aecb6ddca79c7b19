"""Recorder sinks (own copy of border_tpu/record/recorder.py).

≙ border-core Recorder trait (record/recorder.rs:26-108) with the Null
(null_recorder.rs), Buffered (buffered_recorder.rs) and Tensorboard
(border-tensorboard/src/lib.rs:17-126) implementations.  ``save_model`` /
``load_model`` route agent checkpoints through the recorder as the
reference does (recorder.rs:81-107), so best-model selection and periodic
snapshots live with the telemetry sink.  The MLflow sink ports with the
other utilities (ROADMAP A.17).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from border_tpu_torch.record.record import Record, RecordStorage
from border_tpu_torch.record.tfevent import TFEventWriter


class Recorder:
    """Base recorder: write (immediate), store (buffer), flush (aggregate)."""

    def __init__(self, model_dir: Optional[str] = None) -> None:
        self.model_dir = model_dir
        self._storage = RecordStorage()

    # -- telemetry ---------------------------------------------------------
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

    # -- model checkpoints (≙ recorder.rs:81-107) --------------------------
    def _model_path(self, base: str) -> str:
        if self.model_dir is None:
            raise ValueError("recorder has no model_dir configured")
        path = os.path.join(self.model_dir, base)
        os.makedirs(path, exist_ok=True)
        return path

    def save_model(self, base: str, agent, agent_state) -> None:
        agent.save(agent_state, self._model_path(base))

    def load_model(self, base: str, agent, agent_state):
        return agent.load(agent_state, self._model_path(base))


class NullRecorder(Recorder):
    """Discards everything (≙ NullRecorder)."""

    def write(self, record: Record) -> None:
        pass

    def flush(self, step: int) -> None:
        self._storage.aggregate()


class BufferedRecorder(Recorder):
    """Keeps every written record in memory (≙ BufferedRecorder)."""

    def __init__(self, model_dir: Optional[str] = None) -> None:
        super().__init__(model_dir)
        self.records: List[Record] = []

    def write(self, record: Record) -> None:
        self.records.append(record)

    def scalars(self, key: str) -> List[float]:
        return [r.get_scalar(key) for r in self.records if key in r]


class TensorboardRecorder(Recorder):
    """TFEvent writer (≙ TensorboardRecorder, border-tensorboard/src/lib.rs).

    Scalars become tb scalars; 2-D arrays become images; other arrays become
    histograms.  Tensors are brought to the host first.  Backed by
    :class:`border_tpu_torch.record.tfevent.TFEventWriter`.
    """

    def __init__(self, log_dir: str, model_dir: Optional[str] = None):
        super().__init__(model_dir or os.path.join(log_dir, "model"))
        self._writer = TFEventWriter(log_dir)
        self._step = 0

    def write(self, record: Record) -> None:
        self.write_at(record, self._step)

    def write_at(self, record: Record, step: int) -> None:
        self._step = max(self._step, int(step))
        for k, v in record.items():
            if isinstance(v, str) or hasattr(v, "isoformat"):
                continue
            if torch.is_tensor(v):
                v = v.detach().float().cpu().numpy()
            arr = np.asarray(v)
            if arr.ndim == 0:
                self._writer.add_scalar(k, float(arr), step)
            elif arr.ndim == 2:
                self._writer.add_image(k, arr, step)
            else:
                self._writer.add_histogram(k, arr, step)

    def flush(self, step: int) -> None:
        super().flush(step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
