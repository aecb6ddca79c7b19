"""Package rules of the port: it imports neither JAX nor the JAX package,
and its entry points run on the GPU unless the caller asks for the CPU."""

import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from border_tpu_torch import convert
from border_tpu_torch.agents import AWAC, BC, DQN, IQL, IQN, SAC, DQNConfig
from border_tpu_torch.data import MinariDataset, NormalizedEvaluator, collect_dataset
from border_tpu_torch.core import VecEnv, spaces
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer
from border_tpu_torch.train import (AsyncTrainer, Evaluator, HostEnvTrainer,
                                    Trainer, TrainerConfig)


def test_port_imports_no_jax_and_nothing_of_border_tpu():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import border_tpu_torch
        for m in pkgutil.walk_packages(border_tpu_torch.__path__,
                                       "border_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "border_tpu"))
        assert not bad, bad
        print(sum(n.startswith("border_tpu_torch.") for n in sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 53  # every submodule was imported


def test_port_sources_name_no_jax_module_in_an_import():
    """A grep over the port's sources and ``chip_smoke.py``: no import
    statement, at any depth (inside functions too), names jax, flax, optax,
    orbax or the JAX package."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "border_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py", root / "tests" / "helpers" / "torch_dist_worker.py"]
    assert len(files) >= 57
    for new in ("models/mlp.py", "models/iqn.py", "agents/iqn.py",
                "envs/classic_control.py", "envs/breakout.py",
                "envs/seaquest.py", "envs/freeway.py",
                "envs/space_invaders.py", "agents/gaussian.py",
                "agents/sac.py", "agents/bc.py", "agents/awac.py",
                "agents/iql.py", "envs/reacher.py", "data/datasets.py",
                "data/minari.py", "data/__init__.py", "train/offline.py",
                "envs/native.py", "envs/py_env.py", "envs/gym_bridge.py",
                "envs/ale.py", "train/host.py", "train/async_trainer.py",
                "parallel/__init__.py", "parallel/distributed.py",
                "parallel/mesh.py", "parallel/sharded.py",
                "parallel/async_sharded.py", "parallel/gspmd.py",
                "utils/collectives.py", "examples/sharded_dqn.py"):
        assert root / "border_tpu_torch" / new in files
    banned = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|border_tpu)(?:[.\s]|$)",
        re.MULTILINE)
    bad = [f"{f.relative_to(root)}: {m.group(0).strip()}"
           for f in files for m in banned.finditer(f.read_text())]
    assert not bad, bad
    # the pattern does catch what it should
    assert banned.search("    from border_tpu.replay import x")
    assert banned.search("import jax")
    assert not banned.search("from border_tpu_torch.replay import x")


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _no_gpu(monkeypatch)
    env = make("Pong-v0")
    agent = DQN(DQNConfig(model=AtariCNN))
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(env, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameReplayBuffer(capacity=8, num_envs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        agent.init(0, env.observation_space(None), spaces.Discrete(6))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(env, agent, FrameReplayBuffer(8, 2, device="cpu"),
                TrainerConfig(num_envs=2))
    # the entry points added with the flat-replay and IQN paths
    for env_id in ("CartPole-v1", "Seaquest-v0", "SpaceInvaders-v0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            VecEnv(make(env_id), 2)
    cart = make("CartPole-v1")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplayBuffer(capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DQN().init(0, cart.observation_space(None), spaces.Discrete(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        IQN().init(0, cart.observation_space(None), spaces.Discrete(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cart, DQN(), ReplayBuffer(8, device="cpu"),
                TrainerConfig(num_envs=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(cart)
    assert ReplayBuffer(8, device="cpu").device == torch.device("cpu")
    # the converters of JAX state put their result on the GPU too
    tree = types.SimpleNamespace(sum_tree=[0.0, 1.0], min_tree=[0.0, 1.0],
                                 max_priority=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sum_tree_state(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.cartpole_state(types.SimpleNamespace(
            x=[0.0], x_dot=[0.0], theta=[0.0], theta_dot=[0.0], t=[0]))
    assert convert.sum_tree_state(tree, device="cpu").sum_tree.device.type == "cpu"
    # the continuous-control and offline entry points
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(make("Reacher-v0"), 2)
    reacher = make("ReacherGoal-v0")
    obs, act = reacher.observation_space(None), reacher.action_space(None)
    for agent in (SAC(), BC(), AWAC(), IQL()):
        with pytest.raises(RuntimeError, match="CUDA"):
            agent.init(0, obs, act)
        assert agent.init(0, obs, act, device="cpu") is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(reacher)
    with pytest.raises(RuntimeError, match="CUDA"):
        NormalizedEvaluator(reacher, ref_min=0.0, ref_max=1.0)
    md = MinariDataset.load("pendulum-medium-v0")
    with pytest.raises(RuntimeError, match="CUDA"):
        md.create_replay_buffer()
    with pytest.raises(RuntimeError, match="CUDA"):
        md.make_evaluator()
    with pytest.raises(RuntimeError, match="CUDA"):
        collect_dataset(reacher, BC(), None, n_steps=4, num_envs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.reacher_state(types.SimpleNamespace(
            q=[[0.0, 0.0]], qd=[[0.0, 0.0]], goal=[[0.1, 0.2]], t=[0]))
    for name in ("sac_state", "bc_state", "awac_state", "iql_state"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(convert, name)(None, types.SimpleNamespace(), obs, act)
    # the host-env trainer (before it starts any host env) and the
    # decoupled actor-learner
    for build in (
            lambda: HostEnvTrainer("CartPole-v1", DQN(), ReplayBuffer(8, device="cpu"),
                                   TrainerConfig(num_envs=2)),
            lambda: AsyncTrainer(cart, DQN(), ReplayBuffer(8, device="cpu"),
                                 TrainerConfig(num_envs=2))):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # asked for explicitly, the CPU works
    assert VecEnv(env, 2, device="cpu").device == torch.device("cpu")
    assert FrameReplayBuffer(8, 2, device="cpu").init().frames.device.type == "cpu"


def test_entry_points_raise_on_this_gpu_less_box():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameReplayBuffer(capacity=8, num_envs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        VecEnv(make("Pong-v0"), 2)


EXAMPLES = ["dqn_pong", "play_pong", "dqn_cartpole", "convert_policy",
            "iqn_seaquest", "async_dqn_pong", "dqn_pong_host",
            "dqn_cartpole_native", "sac_pendulum", "sac_reacher",
            "offline_pendulum_medium", "offline_fetch_reacher",
            "offline_pendulum", "dqn_gymnasium", "sac_gymnasium", "sharded_dqn"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda_and_raise_without_it(name, monkeypatch):
    import importlib

    _no_gpu(monkeypatch)
    ex = importlib.import_module(f"border_tpu_torch.examples.{name}")
    argv = ["--dataset", "fetch-reacher-medium-v0"] if name == "offline_fetch_reacher" else []
    assert ex.parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.main(argv)


def test_slice_6_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from border_tpu_torch.train import run_elastic
    from border_tpu_torch.utils import CheckpointManager

    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_elastic(lambda mgr: None, str(tmp_path / "elastic"))
    pix = spaces.Box(0, 255, (84, 84, 4), torch.uint8)
    model = Path(__file__).resolve().parents[1] / "artifacts" / "pong_model" / "best"
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.load_jax_policy(DQN(DQNConfig(model=AtariCNN)), str(model),
                                pix, spaces.Discrete(6))
