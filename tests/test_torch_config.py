"""The port's config construction and flattening against the JAX
package's (``tests/test_config.py``'s cases, then parity): one YAML per
agent kind builds agents whose ``config_to_dict`` is the same on both sides
(the port's agent configs have exactly the JAX fields: none missing, none
added), ``flatten_config`` of one tree is equal, and a ``save_config`` from
either side builds on the other."""

import dataclasses

import jax
import pytest
import torch

from border_tpu import agents as jagents
from border_tpu.train import TrainerConfig as JTrainerConfig
from border_tpu.utils import config as jconfig
from border_tpu_torch import agents
from border_tpu_torch.agents import DQN, SAC
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.train import TrainerConfig
from border_tpu_torch.utils import (
    build_agent,
    build_agent_from_path,
    build_env,
    build_env_from_path,
    config_to_dict,
    flatten_config,
    register_model,
    save_config,
)

yaml = pytest.importorskip("yaml")

# one YAML config per agent kind, every list a tuple field
KINDS = {
    "dqn": {"lr": 0.0005, "double_dqn": True, "hidden": [32, 32],
            "model": "atari_cnn", "eps_final_step": 5000},
    "iqn": {"feature_dim": 32, "n_cos": 16, "hidden": [24],
            "sample_percents_act": "const16", "tau": 1.0},
    "sac": {"actor_hidden": [16], "critic_hidden": [16, 8], "n_critics": 3,
            "ent_coef_mode": "auto"},
    "awac": {"actor_hidden": [16], "critic_hidden": [8], "lambda_": 10.0},
    "iql": {"value_hidden": [12], "expectile": 0.8},
    "bc": {"hidden": [64], "action_mode": "discrete", "lr": 0.001},
}


def _write(tmp_path, doc, name="agent.yaml"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def test_build_agent_from_yaml(tmp_path):
    path = _write(tmp_path, {"kind": "dqn", "config": KINDS["dqn"]})
    agent = build_agent_from_path(path)
    assert isinstance(agent, DQN)
    assert agent.config.lr == 0.0005 and agent.config.double_dqn
    assert agent.config.hidden == (32, 32)
    assert callable(agent.config.model)
    # the resolved factory builds the port's CNN for a given action count
    net = agent.config.model(6)
    assert isinstance(net, AtariCNN)
    assert net(torch.zeros((2, 84, 84, 4), dtype=torch.uint8)).shape == (2, 6)


def test_agent_config_yaml_roundtrip(tmp_path):
    agent = build_agent("sac", {"actor_hidden": [16], "critic_hidden": [16]})
    assert isinstance(agent, SAC)
    path = str(tmp_path / "sac.yaml")
    save_config(agent.config, path, kind="sac")
    rebuilt = build_agent_from_path(path)
    assert config_to_dict(rebuilt.config) == config_to_dict(agent.config)


def test_build_agent_rejects_unknown_fields():
    with pytest.raises(ConfigError, match="unknown"):
        build_agent("dqn", {"learning_rate": 1e-3})
    with pytest.raises(ValueError, match="unknown"):  # ConfigError is one
        build_agent("sac", {"hidden": [8]})


def test_build_env_from_config(tmp_path):
    env = build_env({"name": "CartPole-v1"})
    assert VecEnv(env, 1, device="cpu").observation_space.shape == (4,)
    path = _write(tmp_path, {"name": "Pong-v0", "train": False}, "env.yaml")
    env = build_env_from_path(path)
    assert VecEnv(env, 1, device="cpu").observation_space.shape == (84, 84, 4)


def test_flatten_config_tree():
    tree = {
        "trainer": TrainerConfig(max_opts=7),
        "agent": {"kind": "dqn", "hidden": (8, 8)},
        "env": "CartPole-v1",
    }
    flat = flatten_config(tree)
    assert flat["trainer.max_opts"] == 7
    assert flat["agent.kind"] == "dqn"
    assert flat["agent.hidden"] == "[8, 8]"
    assert flat["env"] == "CartPole-v1"
    jtree = dict(tree, trainer=JTrainerConfig(max_opts=7))
    assert flat == jconfig.flatten_config(jtree)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_yaml_builds_the_same_config_on_both_sides(kind, tmp_path):
    path = _write(tmp_path, {"kind": kind, "config": KINDS[kind]})
    ours, theirs = build_agent_from_path(path), jconfig.build_agent_from_path(path)
    assert type(ours).__name__ == type(theirs).__name__
    port_fields = {f.name for f in dataclasses.fields(ours.config)}
    jax_fields = {f.name for f in dataclasses.fields(theirs.config)}
    assert port_fields - jax_fields == set(), "fields the port adds"
    assert jax_fields - port_fields == set(), "fields the port lacks"
    assert config_to_dict(ours.config) == jconfig.config_to_dict(theirs.config)
    tree = {"trainer": TrainerConfig(max_opts=5), "agent": ours.config}
    jtree = {"trainer": JTrainerConfig(max_opts=5), "agent": theirs.config}
    assert flatten_config(tree) == jconfig.flatten_config(jtree)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_a_saved_config_builds_on_the_other_side(kind, tmp_path):
    ours = build_agent(kind, KINDS[kind])
    theirs = jconfig.build_agent(kind, KINDS[kind])
    save_config(ours.config, str(tmp_path / "port.yaml"), kind=kind)
    jconfig.save_config(theirs.config, str(tmp_path / "jax.yaml"), kind=kind)
    with open(tmp_path / "port.yaml") as f, open(tmp_path / "jax.yaml") as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    from_port = jconfig.build_agent_from_path(str(tmp_path / "port.yaml"))
    from_jax = build_agent_from_path(str(tmp_path / "jax.yaml"))
    assert jconfig.config_to_dict(from_port.config) == config_to_dict(ours.config)
    assert config_to_dict(from_jax.config) == jconfig.config_to_dict(theirs.config)


def test_register_model_names_a_factory(tmp_path):
    def small_cnn():
        return lambda n: AtariCNN(out_dim=n, dtype=torch.float32)

    register_model("small_cnn_for_test", small_cnn)
    agent = build_agent("dqn", {"model": "small_cnn_for_test"})
    assert agent.config.model(3).dtype == torch.float32
    assert config_to_dict(agent.config)["model"] == "small_cnn_for_test"


def test_config_module_reads_yaml_only_when_asked():
    """``build_agent`` from a dict works where PyYAML is not installed:
    the module imports ``yaml`` inside its YAML functions only."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; sys.modules['yaml'] = None\n"
            "from border_tpu_torch.utils import build_agent, flatten_config\n"
            "a = build_agent('dqn', {'hidden': [8]})\n"
            "print(flatten_config({'agent': a.config})['agent.hidden'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[8]"
