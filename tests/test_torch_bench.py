"""The port's throughput bench (``border_tpu_torch/bench.py``) against
``bench.py``'s throughput half:

- each of the four bench configs builds field for field as ``bench.py``'s
  (env id, agent config, buffer, ``TrainerConfig``, chunk, step and batch
  counts).  ``bench.py`` is read with ``ast``, never imported: importing it
  resets JAX's process-wide cache settings.  Its config statements are run
  on the JAX package's classes, which allocate nothing until ``init``;
- ``main``'s JSON line has ``bench.py``'s keys plus ``device``;
- each bench function runs on the CPU at a cut width and returns finite
  rates above 0.
"""

import ast
import dataclasses
import functools
import math
from pathlib import Path

import pytest
import torch

from border_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _bench_py():
    """``bench.py``'s functions by name, as ``ast`` nodes."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _jax_objects(fn: str) -> dict:
    """The objects ``bench.py``'s ``fn`` builds before it runs anything
    (``env``, ``agent``, ``buf``/``buffer``, ``cfg``), made by
    running those assignments on the JAX package's classes."""
    from border_tpu.agents import DQN, DQNConfig
    from border_tpu.core.env import VecEnv
    from border_tpu.envs import make
    from border_tpu.models import AtariCNN
    from border_tpu.replay import FrameReplayBuffer, ReplayBuffer
    from border_tpu.train import TrainerConfig

    ns = dict(DQN=DQN, DQNConfig=DQNConfig, VecEnv=VecEnv, AtariCNN=AtariCNN,
              FrameReplayBuffer=FrameReplayBuffer, ReplayBuffer=ReplayBuffer,
              TrainerConfig=TrainerConfig, make=lambda env_id: env_id)
    wanted = {"env", "agent", "buf", "buffer", "cfg"}
    for node in _bench_py()[fn].body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in wanted):
            exec(compile(ast.Module([node], []), "bench.py", "exec"), ns)
    return {k: ns[k] for k in wanted if k in ns}


def _default(fn: str, arg: str):
    f = _bench_py()[fn].args
    names = [a.arg for a in f.args][-len(f.defaults):]
    return ast.literal_eval(f.defaults[names.index(arg)])


def _ints_in(fn: str, call: str):
    """The int literals passed to every ``call(...)`` inside ``fn``."""
    return [a.value for n in ast.walk(_bench_py()[fn])
            if isinstance(n, ast.Call) and isinstance(n.func, (ast.Name, ast.Attribute))
            and getattr(n.func, "id", getattr(n.func, "attr", None)) == call
            for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, int)]


def _main_kwargs(fn: str) -> dict:
    """The keywords ``bench.py``'s ``main`` calls ``fn`` with."""
    return {k.arg: ast.literal_eval(k.value) for n in ast.walk(_bench_py()["main"])
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == fn
            for k in n.keywords}


def _same_agent(agent, jagent):
    c, jc = agent.config, jagent.config
    compared = 0
    for f in dataclasses.fields(jc):
        v = getattr(jc, f.name)
        if f.name == "model":
            assert (v is None) == (c.model is None)
            if v is not None:
                assert type(c.model(6)).__name__ == type(v(6)).__name__
                assert c.model(6).dtype == torch.bfloat16  # flax's default
        elif isinstance(v, (bool, int, float, str, tuple, type(None))):
            assert getattr(c, f.name) == v, f.name
            compared += 1
    assert compared >= 10


def _same_buffer(buf, jbuf):
    assert type(buf).__name__ == type(jbuf).__name__
    for k in ("capacity", "num_envs", "stack", "n_step", "gamma", "sample_mode"):
        if hasattr(jbuf, k):
            assert getattr(buf, k) == getattr(jbuf, k), k
    assert (buf.per is None) == (jbuf.per is None)


@pytest.mark.parametrize("fn, config, n", [
    ("bench_pong_fused", bench.pong_fused_config, "n_chunks"),
    ("bench_fused", bench.cartpole_fused_config, "n_chunks"),
])
def test_fused_bench_configs_are_bench_py_s(fn, config, n):
    env_id, agent, buf, cfg = config("cpu")
    j = _jax_objects(fn)
    assert env_id == j["env"]
    _same_agent(agent, j["agent"])
    _same_buffer(buf, j.get("buf", j.get("buffer")))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j["cfg"])
    ours = getattr(bench, fn).__defaults__[0]
    assert ours == _main_kwargs(fn).get(n, _default(fn, n))


@pytest.mark.parametrize("fn, config, n, fill, first_update, batch", [
    ("bench_pong_reference_architecture", bench.pong_reference_config,
     bench.PONG_BASE_STEPS, bench.PONG_BASE_FILL, None, 32),
    ("bench_reference_architecture", bench.cartpole_reference_config,
     bench.CART_BASE_STEPS, bench.CART_BASE_WARMUP, bench.CART_BASE_FIRST_UPDATE, 64),
])
def test_per_step_bench_configs_are_bench_py_s(fn, config, n, fill, first_update,
                                               batch):
    env_id, agent, buf, num_envs = config("cpu")
    j = _jax_objects(fn)
    assert env_id == j["env"]
    _same_agent(agent, j["agent"])
    _same_buffer(buf, j.get("buf", j.get("buffer")))
    assert _ints_in(fn, "VecEnv") == [num_envs]
    assert n == _main_kwargs(fn).get("n_steps", _default(fn, "n_steps"))
    assert getattr(bench, fn).__defaults__[0] == n
    # the fill loop's length, and the sample's batch
    assert fill in _ints_in(fn, "range")
    assert _ints_in(fn, "sample") == [batch]
    if first_update is not None:  # i >= 65: updates in the warmup's last steps
        cmp = [c for c in ast.walk(_bench_py()[fn]) if isinstance(c, ast.Compare)
               and isinstance(c.ops[0], ast.GtE)]
        assert [ast.literal_eval(c.comparators[0]) for c in cmp] == [first_update]


def test_main_line_has_bench_py_s_keys_plus_device():
    dumped = [n for n in ast.walk(_bench_py()["main"]) if isinstance(n, ast.Dict)]
    keys = {ast.literal_eval(k) for k in dumped[0].keys}
    assert "border_estimate_band_env_steps_per_sec" in keys
    line = bench.result_line(300.0, 10.0, 900.0, 3.0, 1_000.0, 10.0, "cpu")
    assert set(line) == keys | {"device"}
    assert line["device"] == "cpu" and line["vs_baseline"] == 100.0
    assert line["pong_ale_frames_per_sec"] == 1_200.0
    # the estimate is bench.py's constant, not a measurement of this port
    const = [n for n in ast.walk(_bench_py()["main"]) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "BORDER_EST_HIGH"]
    assert bench.BORDER_EST_HIGH == ast.literal_eval(const[0].value)
    band = [v for k, v in zip(dumped[0].keys, dumped[0].values)
            if ast.literal_eval(k) == "border_estimate_band_env_steps_per_sec"]
    assert bench.BORDER_EST_BAND == ast.literal_eval(band[0])


def _rates_ok(*rates):
    assert all(math.isfinite(r) and r > 0 for r in rates), rates


def test_pong_fused_bench_runs_on_the_cpu_at_a_cut_width():
    _rates_ok(*bench.bench_pong_fused(2, "cpu", capacity=16, num_envs=4,
                                      batch_size=32))


def test_pong_per_step_bench_runs_on_the_cpu():
    _rates_ok(bench.bench_pong_reference_architecture(5, "cpu"))


def test_cartpole_fused_bench_runs_on_the_cpu_at_a_cut_width():
    _rates_ok(bench.bench_fused(2, "cpu", num_envs=8))


def test_cartpole_per_step_bench_runs_on_the_cpu():
    _rates_ok(bench.bench_reference_architecture(5, "cpu"))
