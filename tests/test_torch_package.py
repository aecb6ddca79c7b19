"""Package rules of the port: it imports neither JAX nor the JAX package,
and its entry points run on the GPU unless the caller asks for the CPU."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.core import VecEnv, spaces
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.replay import FrameReplayBuffer
from border_tpu_torch.train import Trainer, TrainerConfig


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
    assert int(out.stdout.split()[-1]) >= 25  # every submodule was imported


def test_port_sources_name_no_jax_module_in_an_import():
    """A grep over the port's sources and ``chip_smoke.py``: no import
    statement, at any depth (inside functions too), names jax, flax, optax,
    orbax or the JAX package."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "border_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    assert len(files) >= 30
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
