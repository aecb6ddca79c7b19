"""The port's MLflow client and recorder against a mock in-process REST
server on 127.0.0.1 (``tests/test_mlflow.py``'s cases), then against the
JAX package's: the same calls and the same Records through both recorders
send the same sequence of requests, with the same bodies once the
timestamps (and the run's duration tag) are masked."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from border_tpu.record import MlflowClient as JMlflowClient
from border_tpu.record import MlflowRecorder as JMlflowRecorder
from border_tpu.record import Record as JRecord
from border_tpu.train import TrainerConfig as JTrainerConfig
from border_tpu_torch.errors import BorderTpuError
from border_tpu_torch.record import MlflowClient, MlflowRecorder, Record
from border_tpu_torch.record.mlflow import MlflowError
from border_tpu_torch.train import TrainerConfig


class _Handler(BaseHTTPRequestHandler):
    store = None

    def log_message(self, *a):
        pass

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self.store["requests"].append(("GET", self.path, None,
                                       self.headers.get("Authorization")))
        if "experiments/get-by-name" in self.path:
            name = self.path.split("experiment_name=")[1]
            if name in self.store["experiments"]:
                self._json(200, {"experiment": {"experiment_id": self.store["experiments"][name]}})
            else:
                self._json(404, {"error_code": "RESOURCE_DOES_NOT_EXIST"})
        else:
            self._json(404, {})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        self.store["requests"].append(("POST", self.path, body,
                                       self.headers.get("Authorization")))
        if self.path.endswith("experiments/create"):
            eid = str(len(self.store["experiments"]) + 1)
            self.store["experiments"][body["name"]] = eid
            self._json(200, {"experiment_id": eid})
        elif self.path.endswith("runs/create"):
            rid = f"run{len(self.store['runs']) + 1}"
            self.store["runs"][rid] = body
            self._json(200, {"run": {"info": {"run_id": rid}}})
        elif self.path.endswith("runs/log-metric"):
            self.store["metrics"].append(body)
            self._json(200, {})
        elif self.path.endswith("runs/log-parameter"):
            self.store["params"].append(body)
            self._json(200, {})
        elif self.path.endswith("runs/set-tag"):
            self.store["tags"].append(body)
            self._json(200, {})
        elif self.path.endswith("runs/update"):
            self.store["terminated"].append(body)
            self._json(200, {})
        else:
            self._json(404, {})


def _serve():
    store = {"experiments": {}, "runs": {}, "metrics": [], "params": [],
             "tags": [], "terminated": [], "requests": []}
    handler = type("Handler", (_Handler,), {"store": store})
    srv = HTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_port}", store


@pytest.fixture()
def mlflow_server():
    srv, t, uri, store = _serve()
    yield uri, store
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_client_experiment_and_run_lifecycle(mlflow_server):
    uri, store = mlflow_server
    client = MlflowClient(uri)
    eid = client.get_or_create_experiment("exp1")
    assert eid == client.get_or_create_experiment("exp1")  # idempotent
    rid = client.create_run(eid, "run-name")
    client.log_metric(rid, "loss", 0.5, step=10)
    client.log_param(rid, "lr", 1e-3)
    client.terminate_run(rid)
    assert store["metrics"][0]["key"] == "loss"
    assert store["params"][0]["value"] == "0.001"
    assert store["terminated"][0]["status"] == "FINISHED"


def test_recorder_write_flush_close(mlflow_server):
    uri, store = mlflow_server
    client = MlflowClient(uri)
    rec = MlflowRecorder(client, "exp2", "r1", params={"gamma": 0.99})
    rec.store(Record({"loss": 1.0}))
    rec.store(Record({"loss": 3.0}))
    rec.flush(step=5)  # aggregated loss_mean etc. logged as metrics
    rec.write_at(Record({"Episode return": 100.0, "note": "str-skipped"}), 7)
    rec.close()
    keys = [m["key"] for m in store["metrics"]]
    assert "loss_mean" in keys and "Episode return" in keys
    assert "note" not in keys
    assert store["params"][0]["key"] == "gamma"
    assert store["terminated"]


def test_client_error_on_unreachable():
    client = MlflowClient("http://127.0.0.1:9", timeout=0.2)
    with pytest.raises(MlflowError):
        client.create_run("0")
    assert issubclass(MlflowError, BorderTpuError)
    assert issubclass(MlflowError, RuntimeError)


def test_artifact_root_names_the_model_dir(mlflow_server, monkeypatch, tmp_path):
    uri, _ = mlflow_server
    monkeypatch.setenv("MLFLOW_DEFAULT_ARTIFACT_ROOT", str(tmp_path))
    rec = MlflowRecorder(MlflowClient(uri), "exp3")
    assert rec.model_dir == str(tmp_path / rec.run_id)


_MASKED = ("timestamp", "start_time", "end_time")


def _masked(requests):
    out = []
    for method, path, body, auth in requests:
        if body is not None:
            body = {k: ("<t>" if k in _MASKED else v) for k, v in body.items()}
            if body.get("key") == "duration_sec":
                body["value"] = "<duration>"
        out.append((method, path, body, auth))
    return out


def _drive(client_cls, recorder_cls, record_cls, trainer_cls, uri):
    client = client_cls(uri, username="user", password="pw")
    rec = recorder_cls(client, "exp", run_name="dqn_cartpole",
                       params={"gamma": 0.99, "hidden": (8, 8)})
    rec.log_params({"trainer": trainer_cls(max_opts=7),
                    "agent": {"kind": "dqn", "hidden": (8, 8)},
                    "env": "CartPole-v1"})
    for v in (1.0, 3.0, 2.5):
        rec.store(record_cls({"loss": v, "q_mean": v / 2}))
    rec.flush(step=5)
    rec.store(record_cls({"loss": 0.25}))
    rec.flush(step=9)
    rec.write_at(record_cls({"Episode return": 100.0, "note": "text"}), 9)
    rec.write(record_cls({"average_opt_time": 1.5}))
    client.set_tag(rec.run_id, "stage", "done")
    rec.close()


def test_same_records_send_the_jax_requests():
    logs = []
    for classes in ((MlflowClient, MlflowRecorder, Record, TrainerConfig),
                    (JMlflowClient, JMlflowRecorder, JRecord, JTrainerConfig)):
        srv, t, uri, store = _serve()
        try:
            _drive(*classes, uri)
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=10)
        logs.append(_masked(store["requests"]))
    ours, theirs = logs
    assert len(ours) == len(theirs) > 40
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, i
    assert ours[0][3].startswith("Basic ")
