"""MLflow tracking: minimal REST client + recorder
(≙ border_tpu/record/mlflow.py).

≙ border-mlflow-tracking: MlflowTrackingClient (client.rs:65-300 — REST
experiments/runs/basic-auth) and MlflowTrackingRecorder (recorder.rs:64-328 —
log-metric per scalar on write, RecordStorage aggregation on flush, params
logging, artifact copies, terminate-run-on-drop).

Uses only the standard library (urllib) — no extra dependencies; network
access is entirely optional and all failures surface as MlflowError.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from border_tpu_torch.errors import BorderTpuError
from border_tpu_torch.record.record import Record
from border_tpu_torch.record.recorder import Recorder


class MlflowError(BorderTpuError, RuntimeError):
    pass


class MlflowClient:
    """Thin REST 2.0 client (≙ MlflowTrackingClient, client.rs:65-300)."""

    def __init__(
        self,
        tracking_uri: str,
        username: Optional[str] = None,
        password: Optional[str] = None,
        timeout: float = 5.0,
    ):
        self.base = tracking_uri.rstrip("/")
        self.timeout = timeout
        self._auth = None
        if username is not None:
            token = base64.b64encode(
                f"{username}:{password or ''}".encode()
            ).decode()
            self._auth = f"Basic {token}"

    def _call(self, method: str, path: str, body: Optional[Dict] = None) -> Dict:
        url = f"{self.base}/api/2.0/mlflow/{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self._auth:
            req.add_header("Authorization", self._auth)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode() or "{}")
        except (urllib.error.URLError, OSError) as e:
            raise MlflowError(f"mlflow request {path} failed: {e}") from e

    # -- experiments / runs ------------------------------------------------
    def get_or_create_experiment(self, name: str) -> str:
        try:
            out = self._call(
                "GET", f"experiments/get-by-name?experiment_name={name}"
            )
            return out["experiment"]["experiment_id"]
        except MlflowError:
            out = self._call("POST", "experiments/create", {"name": name})
            return out["experiment_id"]

    def create_run(self, experiment_id: str, run_name: str = "") -> str:
        out = self._call(
            "POST",
            "runs/create",
            {
                "experiment_id": experiment_id,
                "run_name": run_name,
                "start_time": int(time.time() * 1000),
            },
        )
        return out["run"]["info"]["run_id"]

    def log_metric(self, run_id: str, key: str, value: float, step: int) -> None:
        self._call(
            "POST",
            "runs/log-metric",
            {
                "run_id": run_id,
                "key": key,
                "value": float(value),
                "timestamp": int(time.time() * 1000),
                "step": int(step),
            },
        )

    def log_param(self, run_id: str, key: str, value: Any) -> None:
        self._call(
            "POST",
            "runs/log-parameter",
            {"run_id": run_id, "key": key, "value": str(value)},
        )

    def set_tag(self, run_id: str, key: str, value: str) -> None:
        self._call(
            "POST",
            "runs/set-tag",
            {"run_id": run_id, "key": key, "value": value},
        )

    def terminate_run(self, run_id: str, status: str = "FINISHED") -> None:
        self._call(
            "POST",
            "runs/update",
            {
                "run_id": run_id,
                "status": status,
                "end_time": int(time.time() * 1000),
            },
        )


class MlflowRecorder(Recorder):
    """≙ MlflowTrackingRecorder (recorder.rs:64-328).

    ``write`` logs each scalar as a metric (recorder.rs:195-225); model
    artifacts are copied under MLFLOW_DEFAULT_ARTIFACT_ROOT
    (recorder.rs:243-266); ``close`` marks the run FINISHED with duration
    tags (≙ Drop impl, recorder.rs:285-316).
    """

    def __init__(
        self,
        client: MlflowClient,
        experiment: str,
        run_name: str = "",
        params: Optional[Dict[str, Any]] = None,
    ):
        artifact_root = os.environ.get("MLFLOW_DEFAULT_ARTIFACT_ROOT")
        self.client = client
        self.experiment_id = client.get_or_create_experiment(experiment)
        self.run_id = client.create_run(self.experiment_id, run_name)
        model_dir = (
            os.path.join(artifact_root, self.run_id) if artifact_root else None
        )
        super().__init__(model_dir)
        self._start = time.time()
        for k, v in (params or {}).items():
            client.log_param(self.run_id, k, v)

    def log_params(self, tree: Dict[str, Any]) -> None:
        """Log a whole config tree as flattened MLflow params
        (≙ examples/gym/dqn_cartpole/src/main.rs:122-125's config-tree
        serialization into MLflow)."""
        from border_tpu_torch.utils.config import flatten_config

        for k, v in flatten_config(tree).items():
            self.client.log_param(self.run_id, k, v)

    def write(self, record: Record) -> None:
        self.write_at(record, 0)

    def write_at(self, record: Record, step: int) -> None:
        for k, v in record.items():
            try:
                self.client.log_metric(self.run_id, k, float(v), step)
            except (TypeError, ValueError):
                continue  # non-scalar values are not MLflow metrics

    def close(self) -> None:
        dur = time.time() - self._start
        try:
            self.client.set_tag(self.run_id, "duration_sec", f"{dur:.1f}")
            self.client.terminate_run(self.run_id)
        except MlflowError:
            pass
