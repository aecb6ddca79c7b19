"""The port's examples (``border_tpu_torch.examples``) against the JAX
package's ``examples/``.

- every example's ``main`` path (``build`` then ``run``) on the CPU at a
  tiny size: its options at small values, and its fixed settings (the
  warmup, the evaluation cadence) cut with ``dataclasses.replace``;
- every example's options and defaults against the JAX example's, read
  with ``ast`` from ``examples/<name>.py`` (nothing there is imported or
  run): the same option strings, types, actions, choices and defaults, plus
  ``--device``.  A JAX default under ``/tmp/`` is the same name under the
  temporary directory;
- ``--curve-out`` names the game the run trained on, with the gate's
  target only for Pong (the JAX example writes ``Pong-v0`` and 18 for every
  game).
"""

import argparse
import ast
import dataclasses
import importlib
import json
import os
import tempfile
from pathlib import Path

import pytest
import torch

from border_tpu_torch.envs import make
from border_tpu_torch.train import Evaluator

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["dqn_pong", "play_pong", "dqn_cartpole", "convert_policy",
            "iqn_seaquest", "async_dqn_pong", "dqn_pong_host",
            "dqn_cartpole_native", "sac_pendulum", "sac_reacher",
            "offline_pendulum_medium", "offline_fetch_reacher",
            "offline_pendulum", "dqn_gymnasium", "sac_gymnasium", "sharded_dqn"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside other test processes on the same cores, more intra-op
    threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    return importlib.import_module(f"border_tpu_torch.examples.{name}")


def _run(name, argv, evaluator=None, **cut):
    """``main(argv + --device cpu)`` with the fixed config settings ``cut``
    and, where given, a shorter evaluator."""
    ex = _example(name)
    args = ex.parser().parse_args([*argv, "--device", "cpu"])
    objs = ex.build(args)
    if cut:
        objs["config"] = dataclasses.replace(objs["config"], **cut)
    if evaluator is not None:
        objs["evaluator"] = evaluator
    return ex.run(args, objs)


def _pixel_eval(env_id):
    return Evaluator(make(env_id, train=False), n_episodes=2, max_steps=16,
                     device="cpu")


PIXEL = ["--num-envs", "4", "--batch-size", "8", "--opt-interval", "32"]


def test_dqn_pong_main_writes_its_curve_and_model(tmp_path, capsys):
    curve = tmp_path / "curve.json"
    res = _run("dqn_pong", [*PIXEL, "--max-opts", "8", "--capacity-per-env",
                            "64", "--eval-interval", "4", "--tensorboard",
                            "--out", str(tmp_path / "out"), "--curve-out",
                            str(curve)],
               evaluator=_pixel_eval("Pong-v0"), warmup_period=64)
    assert res.opt_steps == 8 and len(res.eval_history) == 2
    doc = json.loads(curve.read_text())
    assert (doc["env"], doc["target"]) == ("Pong-v0", 18.0)
    assert [c["opt_steps"] for c in doc["curve"]] == [4, 8]
    out = capsys.readouterr().out
    assert "=== done ===" in out and "best eval return=" in out
    assert any(f.name.startswith("events.out.tfevents")
               for f in (tmp_path / "out").iterdir())
    assert (tmp_path / "out" / "model" / "best" / "dqn.npz").exists()


@pytest.mark.parametrize("env_id", ["Pong-v0", "Breakout-v0", "Freeway-v0"])
def test_curve_out_names_the_game_it_trained(env_id):
    """The JAX example writes ``"env": "Pong-v0"`` and ``"target": 18.0``
    whatever ``--env`` selects (``examples/dqn_pong.py:130,132``)."""
    ex = _example("dqn_pong")
    doc = ex.curve_json(ex.parser().parse_args(["--env", env_id]), [])
    assert doc["env"] == env_id
    assert doc["target"] == (18.0 if env_id == "Pong-v0" else None)


def test_dqn_pong_curve_of_another_game(tmp_path):
    curve = tmp_path / "curve.json"
    _run("dqn_pong", [*PIXEL, "--max-opts", "4", "--capacity-per-env", "64",
                      "--eval-interval", "4", "--env", "Breakout-v0",
                      "--out", str(tmp_path / "out"), "--curve-out", str(curve)],
         evaluator=_pixel_eval("Breakout-v0"), warmup_period=64)
    doc = json.loads(curve.read_text())
    assert (doc["env"], doc["target"]) == ("Breakout-v0", None)


def test_play_pong_plays_the_committed_jax_policy_into_a_gif(tmp_path, capsys):
    PIL = pytest.importorskip("PIL.Image")
    gif = tmp_path / "play.gif"
    returns = _example("play_pong").main(
        ["--steps", "24", "--no-render", "--gif", str(gif), "--device", "cpu"])
    assert returns == []  # no point is over in 24 steps
    assert "gif:" in capsys.readouterr().out
    assert PIL.open(gif).n_frames == 24


def test_play_pong_reads_a_port_saved_model(tmp_path, capsys):
    ex = _example("play_pong")
    args = ex.parser().parse_args(["--device", "cpu"])
    objs = ex.build(args)
    objs["agent"].save(objs["state"], str(tmp_path))
    args = ex.parser().parse_args(["--model", str(tmp_path), "--steps", "8",
                                   "--device", "cpu"])
    objs2 = ex.build(args)
    for a, b in zip(objs["state"].params.parameters(),
                    objs2["state"].params.parameters()):
        assert torch.equal(a, b)
    ex.run(args, objs2)  # renders to the terminal
    assert "▀" in capsys.readouterr().out


def test_dqn_cartpole_checkpoints_then_resumes(tmp_path, capsys):
    # 8 envs x 32 steps a chunk / 64: 4 updates a chunk
    argv = ["--num-envs", "8", "--opt-interval", "64", "--out", str(tmp_path),
            "--checkpoint-interval", "4"]
    cut = dict(warmup_period=64, eval_interval=4)
    res = _run("dqn_cartpole", [*argv, "--max-opts", "8"], **cut)
    assert res.opt_steps == 8
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "8"]
    res2 = _run("dqn_cartpole", [*argv, "--max-opts", "16", "--resume"], **cut)
    assert res2.opt_steps == 16 and [s for s, _ in res2.eval_history] == [12, 16]
    assert "best eval return=" in capsys.readouterr().out


def test_dqn_cartpole_from_an_agent_yaml(tmp_path):
    pytest.importorskip("yaml")
    from border_tpu_torch.agents import DQNConfig
    from border_tpu_torch.utils import save_config

    path = str(tmp_path / "agent.yaml")
    save_config(DQNConfig(hidden=(16,), lr=5e-4), path, kind="dqn")
    res = _run("dqn_cartpole", ["--agent-config", path, "--num-envs", "8",
                                "--opt-interval", "64", "--max-opts", "4",
                                "--out", str(tmp_path)], warmup_period=64)
    assert res.opt_steps == 4
    assert sum(p.numel() for p in res.agent_state.params.parameters()) == (
        4 * 16 + 16 + 16 * 2 + 2)  # the YAML's hidden=(16,)


def test_convert_policy_exports_and_deploys_on_the_cpp_pool(tmp_path, capsys):
    returns = _run("convert_policy", ["--max-opts", "8", "--episodes", "3",
                                      "--out", str(tmp_path)],
                   warmup_period=64, num_envs=8, eval_interval=4)
    assert sorted(os.listdir(tmp_path)) == ["policy.json", "policy.npz"]
    assert returns is not None and returns.shape == (3,)
    assert "numpy-only deployment on C++ envs" in capsys.readouterr().out


def test_iqn_seaquest_main(tmp_path, capsys):
    res = _run("iqn_seaquest", [*PIXEL, "--max-opts", "4", "--out",
                                str(tmp_path)],
               evaluator=_pixel_eval("Seaquest-v0"), warmup_period=64,
               eval_interval=4)
    assert res.opt_steps == 4 and len(res.eval_history) == 1
    assert "=== done ===" in capsys.readouterr().out


def test_async_dqn_pong_main(tmp_path, capsys):
    res = _run("async_dqn_pong", [*PIXEL, "--max-opts", "8", "--sync-interval",
                                  "4", "--out", str(tmp_path)],
               evaluator=_pixel_eval("Pong-v0"), warmup_period=64,
               eval_interval=4)
    assert res.opt_steps == 8 and len(res.eval_history) == 2
    assert "opt/s=" in capsys.readouterr().out


def test_dqn_pong_host_main(capsys):
    from border_tpu_torch.train import HostEvaluator

    res = _run("dqn_pong_host", ["--num-envs", "4", "--max-opts", "4",
                                 "--capacity", "64"],
               evaluator=HostEvaluator("Pong-v0", n_episodes=2, max_steps=16),
               warmup_period=64, batch_size=8, opt_interval=16, eval_interval=4)
    assert res.opt_steps == 4 and len(res.eval_history) == 1
    assert "host_wait_frac" in capsys.readouterr().out


def test_dqn_cartpole_native_main(tmp_path, capsys):
    res = _run("dqn_cartpole_native", ["--num-envs", "8", "--max-opts", "8",
                                       "--n-threads", "2", "--out",
                                       str(tmp_path)],
               warmup_period=64, eval_interval=4)
    assert res.opt_steps == 8 and len(res.eval_history) == 2
    assert "best eval return=" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["sac_pendulum", "sac_reacher"])
def test_sac_examples_main(name, tmp_path, capsys):
    # 8 envs x 32 steps / 16: 16 updates a chunk
    res = _run(name, ["--num-envs", "8", "--max-opts", "32", "--out",
                      str(tmp_path)], warmup_period=64, eval_interval=16)
    assert res.opt_steps == 32 and len(res.eval_history) == 2
    assert "best eval return=" in capsys.readouterr().out


@pytest.mark.parametrize("agent", ["bc", "awac", "iql"])
def test_offline_pendulum_medium_main(agent, capsys):
    res = _run("offline_pendulum_medium", ["--agent", agent, "--max-opts", "4",
                                           "--batch-size", "16"],
               eval_interval=2)
    assert res.opt_steps >= 4 and res.eval_history
    out = capsys.readouterr().out
    assert "dataset pendulum-medium-v0: 40000 transitions" in out
    assert f"{agent}: eval return" in out


@pytest.mark.parametrize("dataset", ["fetch-reacher-medium-v0",
                                     "fetch-reacher-medium-h5-v0"])
def test_offline_fetch_reacher_main(dataset, capsys):
    if dataset.endswith("-h5-v0"):
        pytest.importorskip("h5py")
    res = _run("offline_fetch_reacher", ["--agent", "bc", "--max-opts", "4",
                                         "--batch-size", "16", "--dataset",
                                         dataset], eval_interval=2)
    assert res.opt_steps >= 4 and res.eval_history
    assert "bc: best normalized" in capsys.readouterr().out


def test_offline_pendulum_builds_its_corpus_then_trains(tmp_path, capsys):
    ex = _example("offline_pendulum")
    path = str(tmp_path / "corpus.npz")
    ex.build_corpus(path, 256, 0, "cpu", dataclasses.replace(
        ex.corpus_config(0), max_opts=4, warmup_period=64, num_envs=8))
    res = _run("offline_pendulum", ["--dataset", path, "--max-opts", "4",
                                    "--algo", "awac"], eval_interval=2)
    assert res.opt_steps >= 4 and res.eval_history
    out = capsys.readouterr().out
    assert "dataset: 256 transitions" in out and "awac: best eval return=" in out


@pytest.mark.parametrize("name, argv", [
    ("dqn_gymnasium", ["--num-envs", "4", "--max-opts", "8", "--batch-size", "16"]),
    ("sac_gymnasium", ["--num-envs", "4", "--max-opts", "8", "--batch-size", "16",
                       "--cpu"]),
])
def test_gymnasium_examples_main(name, argv, capsys):
    pytest.importorskip("gymnasium")
    res = _run(name, argv, warmup_period=64)
    assert res.opt_steps == 8 and res.eval_history
    assert "best eval return" in capsys.readouterr().out


# -- options and defaults against the JAX examples ---------------------------

def _jax_options(name):
    """``{option: {type, action, default, choices}}`` of the JAX example,
    from its ``add_argument`` calls."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    consts = {}
    for node in ast.walk(tree):  # module-level names a default may use
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            consts[getattr(node.targets[0], "id", None)] = node.value
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            opt = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            spec = {}
            for key in ("default", "choices", "action"):
                if key in kw:
                    v = kw[key]
                    if isinstance(v, ast.Name) and v.id in consts:
                        spec[key] = ("expr", ast.unparse(consts[v.id]))
                    else:
                        spec[key] = ast.literal_eval(v)
            if "type" in kw:
                spec["type"] = kw["type"].id
            out[opt] = spec
    return out


def _port_options(name):
    p = _example(name).parser()
    out = {}
    for a in p._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        spec = {"default": a.default}
        if a.choices is not None:
            spec["choices"] = list(a.choices)
        if isinstance(a, argparse._StoreTrueAction):
            spec["action"] = "store_true"
        if a.type is not None:
            spec["type"] = a.type.__name__
        out[a.option_strings[0]] = spec
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_options_and_defaults_match_the_jax_example(name):
    want, got = _jax_options(name), _port_options(name)
    assert set(got) == set(want) | {"--device"}, name
    assert got["--device"]["default"] == "cuda"
    for opt, spec in want.items():
        g = dict(got[opt])
        if spec.get("action") == "store_true":
            assert g == {"default": False, "action": "store_true"}, opt
            continue
        default = spec.get("default")
        if isinstance(default, tuple) and default[0] == "expr":
            # play_pong's model: <examples>/../artifacts/pong_model/best
            assert "artifacts" in default[1] and "pong_model" in default[1]
            assert Path(g["default"]) == ROOT / "artifacts" / "pong_model" / "best"
        elif isinstance(default, str) and default.startswith("/tmp/"):
            assert g["default"] == os.path.join(tempfile.gettempdir(),
                                                default[len("/tmp/"):]), opt
        else:
            assert g["default"] == default, opt
        assert g.get("type") == spec.get("type"), opt
        assert g.get("choices") == spec.get("choices"), opt


def test_every_example_is_ported_but_the_sharded_one():
    """Every JAX example has its port, ``sharded_dqn`` too (the name is
    older than the multi-GPU slice)."""
    jax_names = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert jax_names == set(EXAMPLES)
    port = {p.stem for p in (ROOT / "border_tpu_torch" / "examples").glob("*.py")}
    assert port - {"__init__"} == set(EXAMPLES)
