"""The learning gate on the port (≙ benchmarks/learning.py and bench.py's
``gate``).

Trains one of the 15 gate configs for one seed, on the GPU unless asked
for the CPU, and streams a JSON learning-curve artifact, rewritten after
every evaluation.  After training the best checkpoint is reloaded and
scored on fresh evaluations (``final_evals``); the gate passes a config
when at least 3 seeds each have a median of those at or above the
config's target.  Artifacts go to ``artifacts/torch/`` in the JAX gate's
naming (``<config>_curve.json`` is seed 0, ``<config>_curve_seed<s>.json``
the others), where the JAX gate, which globs ``artifacts/`` only, never
reads them.

Usage::

    python -m border_tpu_torch.learning pong --seed 1 --max-opts 40000
    python -m border_tpu_torch.learning gate      # over artifacts/torch/
    python -m border_tpu_torch.learning assemble  # merge the artifacts
    python -m border_tpu_torch.learning pendulum_host --pendulum-env numpy

Each artifact carries the JAX artifact's keys plus ``device`` (the card's
name and power limit as ``nvidia-smi`` gives them, or ``cpu``) and
``duration_sec`` (the training loop's seconds); the run prints it as one
JSON line at its end.

The configs are the JAX harness's, field for field (the tests hold them
against it); the gate configs' tables and builders here are also what
``chip_smoke.py`` reads.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from border_tpu_torch.utils.device import DeviceLike, resolve_device

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARTIFACTS = os.path.join(ROOT, "artifacts", "torch")

# gate targets (benchmarks/learning.py:45-62): CartPole at the reference's
# comparison point (CartPole-v0's solved 200), Pendulum-v1's solved band,
# Pong >= 18 (the north star), the games' bands; the offline configs score
# on the D4RL-normalized scale and must beat the behavior policy (74.2 under
# the same protocol, artifacts/fetch_behavior_protocol.json)
TARGETS = {"cartpole": 200.0, "pendulum": -200.0, "pong": 18.0,
           "seaquest": 200.0, "breakout": 100.0, "freeway": 30.0,
           "spaceinvaders": 600.0, "pong_host": 18.0,
           "pendulum_host": -200.0, "breakout_host": 100.0,
           "pong_per": 18.0, "pong_slice": 18.0,
           "bc_offline": 76.0, "awac_offline": 78.0, "iql_offline": 88.0}

# fresh best-checkpoint evaluations for the final certification: 10 for the
# high-variance games and BC, 5 elsewhere
N_FINAL_EVALS = {"spaceinvaders": 10, "seaquest": 10, "bc_offline": 10}

OFFLINE_CONFIGS = ("bc_offline", "awac_offline", "iql_offline")

# -- the gate configs' tables (also read by chip_smoke.py) ---------------------
# cartpole (learning.py:79-94): DQN + MLP, n-step 3
CART_GATE = dict(max_opts=12_000, warmup_period=1_000, opt_interval=16,
                 batch_size=256, num_envs=128, steps_per_chunk=32,
                 eval_interval=500)
CART_CAPACITY = 65_536
# pendulum (learning.py:95-105): SAC + Gaussian, two critics
PEND_GATE = dict(max_opts=20_000, warmup_period=1_000, opt_interval=16,
                 batch_size=128, num_envs=128, steps_per_chunk=32,
                 eval_interval=2_000)
PEND_CAPACITY = 65_536
# the host-env configs (learning.py:181-223, :262-288)
HOST_PIXEL_GATE = dict(max_opts=40_000, warmup_period=50_000, opt_interval=64,
                       batch_size=512, num_envs=256, steps_per_chunk=32,
                       eval_interval=2_000)
HOST_GATE = {
    "pong_host": HOST_PIXEL_GATE,
    "breakout_host": HOST_PIXEL_GATE,
    "pendulum_host": dict(max_opts=20_000, warmup_period=1_000, opt_interval=8,
                          batch_size=128, num_envs=32, steps_per_chunk=32,
                          eval_interval=2_000),
}
HOST_CAPACITY = {"pong_host": 1_024, "breakout_host": 1_024,
                 "pendulum_host": 65_536}
# (episodes, steps) of each host config's HostEvaluator
HOST_EVAL = {"pong_host": (5, 3_000), "breakout_host": (5, 6_750),
             "pendulum_host": (10, 200)}
HOST_META = {
    "pong_host": {"env": "Pong-v0 (host C++ envpool)", "agent": "DQN+AtariCNN",
                  "trainer": "HostEnvTrainer"},
    "breakout_host": {"env": "Breakout-v0 (host C++ envpool)",
                      "agent": "DQN+AtariCNN", "trainer": "HostEnvTrainer"},
    "pendulum_host": {"agent": "SAC+Gaussian", "trainer": "HostEnvTrainer"},
}
# the offline configs (learning.py:294-378) over the fetch-reacher corpora
# with the full goal-dict layout (8 features), evaluated on the Reacher
OFFLINE_GATE_OPTS = {"bc_offline": 12_000, "awac_offline": 8_000,
                     "iql_offline": 12_000}
OFFLINE_KEYS = ("observation", "desired_goal", "achieved_goal")
OFFLINE_BATCH, OFFLINE_EVAL_INTERVAL = 256, 2_000
OFFLINE_EVAL_EPISODES, OFFLINE_EVAL_STEPS = 200, 50
OFFLINE_UPDATES_PER_CHUNK = 250
# bc and awac read the committed .npz corpus; iql reads its gate corpus, the
# Minari-format HDF5 file converted to a port-only .npz (the GPU machine has
# no h5py; data/minari.py::hdf5_to_local)
OFFLINE_CORPUS = "fetch-reacher-medium-v0"
IQL_CORPUS = "fetch-reacher-medium-h5-v0"
IQL_CORPUS_DIR = os.path.join(ROOT, "artifacts", "datasets", "torch")
# the behavior policy scored under the gate's evaluation protocol
BEHAVIOR_PROTOCOL_MEDIAN = 74.2


def pixel_dqn(eps_final_step: int = 1_000_000):
    """The pixel configs' DQN + AtariCNN (double DQN, hard target sync
    every 2,000 updates)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN

    return DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n), lr=1e-4,
                         double_dqn=True, soft_update_interval=2_000, tau=1.0,
                         eps_final_step=eps_final_step))


def sac_agent():
    from border_tpu_torch.agents import SAC, SACConfig

    return SAC(SACConfig(actor_hidden=(128, 128), critic_hidden=(128, 128),
                         n_critics=2, actor_lr=3e-4, critic_lr=3e-4,
                         ent_coef_mode="auto"))


def _gym_pendulum(n: int, seed: int):
    from border_tpu_torch.envs import PyVecEnv

    return PyVecEnv.gym("Pendulum-v1", n, seed=seed)


def _numpy_pendulum(n: int, seed: int):
    from border_tpu_torch.envs.py_env import numpy_pendulum

    return numpy_pendulum(n, seed)


# pendulum_host's host envs, chosen by name (``--pendulum-env``): Gymnasium's
# Pendulum-v1 as in the JAX config, or NumpyPendulum, its equations in plain
# numpy (bitwise the same), for a machine without gymnasium
PENDULUM_ENVS = {
    "gymnasium": (_gym_pendulum,
                  "Pendulum-v1 (external Gymnasium via PyVecEnv)"),
    "numpy": (_numpy_pendulum,
              "Pendulum-v1 (NumpyPendulum: Gymnasium's equations in numpy, "
              "via PyVecEnv)"),
}


def host_config(name: str, device: DeviceLike = None, seed: int = 0,
                capacity=None, eval_steps=None, cuda_graphs=None,
                make_env=_gym_pendulum, **cut):
    """The host-env gate config ``name`` (pong_host, breakout_host,
    pendulum_host): (env, agent, buffer, TrainerConfig, evaluator).
    ``cut`` replaces TrainerConfig fields (``num_envs`` cuts the width, the
    ring following it); ``capacity`` and ``eval_steps`` cut the ring's
    depth and the evaluation's horizon; ``cuda_graphs`` is the evaluator's
    switch.  pendulum_host's envs come from ``make_env(n, seed)``:
    Gymnasium's Pendulum-v1 behind ``PyVecEnv``, as in the JAX config."""
    from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer
    from border_tpu_torch.train import HostEvaluator, TrainerConfig

    cfg = TrainerConfig(seed=seed, **{**HOST_GATE[name], **cut})
    capacity = capacity or HOST_CAPACITY[name]
    episodes, steps = HOST_EVAL[name]
    steps = eval_steps or steps
    if name in ("pong_host", "breakout_host"):
        env_id = "Pong-v0" if name == "pong_host" else "Breakout-v0"
        buffer = FrameReplayBuffer(capacity=capacity, num_envs=cfg.num_envs,
                                   device=device)
        return (env_id, pixel_dqn(), buffer, cfg,
                HostEvaluator(env_id, n_episodes=episodes, max_steps=steps,
                              cuda_graphs=cuda_graphs))
    return (make_env(cfg.num_envs, cfg.seed), sac_agent(),
            ReplayBuffer(capacity=capacity, device=device), cfg,
            HostEvaluator(make_env, n_episodes=episodes, max_steps=steps,
                          cuda_graphs=cuda_graphs))


def build(config: str, seed: int, device: DeviceLike = None,
          pendulum_env: str = "gymnasium"):
    """The online gate config ``config`` (benchmarks/learning.py::_build):
    (env, agent, buffer, TrainerConfig, evaluator, meta).  The host configs'
    env is a native env id or a host vec env, for ``HostEnvTrainer``;
    ``pendulum_env`` names pendulum_host's (a key of ``PENDULUM_ENVS``)."""
    from border_tpu_torch.agents import DQN, IQN, DQNConfig, IQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig, ReplayBuffer
    from border_tpu_torch.train import Evaluator, TrainerConfig

    if config in HOST_GATE:
        make_env, label = PENDULUM_ENVS[pendulum_env]
        env, agent, buffer, cfg, evaluator = host_config(config, device, seed,
                                                         make_env=make_env)
        meta = dict(HOST_META[config])
        if config == "pendulum_host":
            meta["env"] = label
        return env, agent, buffer, cfg, evaluator, meta

    def pixel(env_id, agent, num_envs, n_episodes, max_steps, **buffer_kw):
        return (make(env_id), agent,
                FrameReplayBuffer(capacity=512, num_envs=num_envs,
                                  device=device, **buffer_kw),
                Evaluator(make(env_id, train=False), n_episodes=n_episodes,
                          max_steps=max_steps, device=device))

    gate = dict(warmup_period=50_000, opt_interval=64, batch_size=512,
                steps_per_chunk=32, seed=seed)
    if config == "cartpole":
        env = make("CartPole-v1")
        agent = DQN(DQNConfig(hidden=(64, 64), lr=5e-4, gamma=0.99, tau=1.0,
                              soft_update_interval=500, double_dqn=True,
                              eps_final_step=10_000))
        cfg = TrainerConfig(seed=seed, **CART_GATE)
        buffer = ReplayBuffer(capacity=CART_CAPACITY, n_step=3,
                              stride=CART_GATE["num_envs"], device=device)
        evaluator = Evaluator(env, n_episodes=20, max_steps=500, device=device)
        meta = {"env": "CartPole-v1", "agent": "DQN+MLP (n-step 3)"}
    elif config == "pendulum":
        env = make("Pendulum-v1")
        agent = sac_agent()
        cfg = TrainerConfig(seed=seed, **PEND_GATE)
        buffer = ReplayBuffer(capacity=PEND_CAPACITY, device=device)
        evaluator = Evaluator(env, n_episodes=10, max_steps=200, device=device)
        meta = {"env": "Pendulum-v1", "agent": "SAC+Gaussian"}
    elif config == "pong":
        env, agent, buffer, evaluator = pixel(
            "Pong-v0", pixel_dqn(2_000_000), 1024, 10, 3_000)
        cfg = TrainerConfig(max_opts=120_000, num_envs=1024,
                            eval_interval=2_000, **gate)
        meta = {"env": "Pong-v0", "agent": "DQN+AtariCNN"}
    elif config == "seaquest":
        agent = IQN(IQNConfig(
            psi_fn=functools.partial(AtariCNN, out_dim=0, skip_linear=True),
            feature_dim=512, n_cos=64, hidden=(512,),
            sample_percents_pred="uniform8", sample_percents_tgt="uniform8",
            sample_percents_act="const32", lr=1e-4,
            soft_update_interval=2_000, tau=1.0, eps_final_step=2_000_000))
        env, agent, buffer, evaluator = pixel("Seaquest-v0", agent, 512, 10, 3_000)
        cfg = TrainerConfig(max_opts=100_000, num_envs=512, eval_interval=2_500,
                            **{**gate, "batch_size": 256})
        meta = {"env": "Seaquest-v0", "agent": "IQN+AtariCNN"}
    elif config == "breakout":
        env, agent, buffer, evaluator = pixel(
            "Breakout-v0", pixel_dqn(), 512, 5, 3_000)
        cfg = TrainerConfig(max_opts=60_000, num_envs=512, eval_interval=4_000,
                            **gate)
        meta = {"env": "Breakout-v0", "agent": "DQN+AtariCNN"}
    elif config == "freeway":
        # n-step 3 with γ 0.99 end to end (the buffer's γ drives the n-step
        # sum and the bootstrap discount; the Trainer rejects a mismatch)
        env, agent, buffer, evaluator = pixel(
            "Freeway-v0", pixel_dqn(), 512, 5, 2_100, n_step=3, gamma=0.99)
        cfg = TrainerConfig(max_opts=30_000, num_envs=512, eval_interval=2_000,
                            **gate)
        meta = {"env": "Freeway-v0", "agent": "DQN+AtariCNN"}
    elif config == "spaceinvaders":
        env, agent, buffer, evaluator = pixel(
            "SpaceInvaders-v0", pixel_dqn(), 512, 5, 3_000, n_step=3)
        cfg = TrainerConfig(max_opts=30_000, num_envs=512, eval_interval=2_000,
                            **gate)
        meta = {"env": "SpaceInvaders-v0", "agent": "DQN+AtariCNN (n-step 3)"}
    elif config == "pong_per":
        # the sum tree over the ring's env × slot leaves (1024 × 512 = 2^19)
        env, agent, buffer, evaluator = pixel(
            "Pong-v0", pixel_dqn(2_000_000), 1024, 10, 3_000,
            per=PerConfig(n_opts_final=50_000))
        cfg = TrainerConfig(max_opts=60_000, num_envs=1024, eval_interval=2_000,
                            **gate)
        meta = {"env": "Pong-v0", "agent": "DQN+AtariCNN (PER)"}
    elif config == "pong_slice":
        env, agent, buffer, evaluator = pixel(
            "Pong-v0", pixel_dqn(2_000_000), 1024, 10, 3_000, sample_mode="slice")
        cfg = TrainerConfig(max_opts=60_000, num_envs=1024, eval_interval=2_000,
                            **gate)
        meta = {"env": "Pong-v0", "agent": "DQN+AtariCNN (slice sampling)"}
    else:
        raise KeyError(config)
    return env, agent, buffer, cfg, evaluator, meta


def offline_config(name: str, device: DeviceLike = None, max_opts=None,
                   seed: int = 0):
    """The offline gate config ``name`` (bc_offline, awac_offline,
    iql_offline): (dataset, agent, TrainerConfig, evaluator).  ``max_opts``
    cuts the run; BC's cosine learning-rate horizon is the run's own
    ``max_opts`` (the JAX harness hard-codes 12,000, which leaves a cut
    run's rate far from 0)."""
    from border_tpu_torch.agents import AWAC, BC, IQL, AWACConfig, BCConfig, IQLConfig
    from border_tpu_torch.agents.common import cosine_decay_schedule
    from border_tpu_torch.data import GoalDictConverter, MinariDataset, NormalizedEvaluator
    from border_tpu_torch.envs import make
    from border_tpu_torch.envs.reacher import FlattenDictWrapper
    from border_tpu_torch.train import TrainerConfig

    max_opts = max_opts or OFFLINE_GATE_OPTS[name]
    converter = GoalDictConverter(keys=OFFLINE_KEYS)
    if name == "iql_offline":
        md = MinariDataset.load_local(IQL_CORPUS, IQL_CORPUS_DIR, converter)
    else:
        md = MinariDataset.load(OFFLINE_CORPUS, converter=converter)
    if name == "bc_offline":
        agent = BC(BCConfig(hidden=(256, 256),
                            lr=cosine_decay_schedule(1e-3, max_opts)))
    elif name == "awac_offline":
        # λ=10: the measured-best advantage temperature on this corpus
        agent = AWAC(AWACConfig(actor_hidden=(256, 256), critic_hidden=(256, 256),
                                lambda_=10.0))
    elif name == "iql_offline":
        agent = IQL(IQLConfig())
    else:
        raise KeyError(name)
    evaluator = NormalizedEvaluator(
        FlattenDictWrapper(make("Reacher-v0"), keys=OFFLINE_KEYS),
        n_episodes=OFFLINE_EVAL_EPISODES, max_steps=OFFLINE_EVAL_STEPS,
        ref_min=md.ref_min, ref_max=md.ref_max, device=device)
    # evaluations every 2,000 updates, as the JAX harness (its 24 picks at
    # 500 let the best-model pick ride evaluation noise)
    cfg = TrainerConfig(max_opts=max_opts, batch_size=OFFLINE_BATCH,
                        eval_interval=OFFLINE_EVAL_INTERVAL,
                        flush_record_interval=10**9, seed=seed)
    return md, agent, cfg, evaluator


def build_offline(config: str, seed: int, device: DeviceLike = None,
                  max_opts=None):
    """The offline gate config ``config`` (benchmarks/learning.py::
    _build_offline): (dataset, agent, TrainerConfig, evaluator, eval_env,
    meta)."""
    md, agent, cfg, evaluator = offline_config(config, device, max_opts, seed)
    label = {"bc_offline": "BC", "awac_offline": "AWAC", "iql_offline": "IQL"}[config]
    meta = {"env": md.env_name, "agent": label, "trainer": "OfflineTrainer",
            "dataset": md.dataset_id, "unit": "normalized_score",
            "behavior_normalized": round(md.behavior_normalized_score(), 2),
            "behavior_protocol_median": BEHAVIOR_PROTOCOL_MEDIAN}
    return md, agent, cfg, evaluator, evaluator.vec.env, meta


# -- runs -------------------------------------------------------------------------
def device_label(device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


class GateRun(NamedTuple):
    """What :func:`run` made: the artifact (as written), the trainer and
    its result.  The certification loads the best checkpoint into the
    result's agent state in place (its networks are the trained ones)."""

    artifact: dict
    trainer: Any
    result: Any


class _Curve:
    """The curve artifact at ``out``, rewritten after every point."""

    def __init__(self, out: str, head: dict, config: dict):
        self.out, self.head, self.config = out, head, config
        self.extra, self.points = {}, []
        self.t0 = time.perf_counter()

    def artifact(self) -> dict:
        return {**self.head, **self.extra, "config": self.config,
                "curve": self.points}

    def add(self, point: dict) -> None:
        point["wall_sec"] = round(time.perf_counter() - self.t0, 1)
        self.points.append(point)
        with open(self.out, "w") as f:
            json.dump(self.artifact(), f, indent=1)


def _certify(config, curve, agent, result, model_dir, evaluator, score) -> bool:
    """Reload the best checkpoint and score it on fresh evaluations (the
    gate reads their median); ``score`` maps a raw score to the artifact's
    unit.  False when the run saved no best checkpoint."""
    best_dir = os.path.join(model_dir, "best")
    if not (os.path.isdir(best_dir) and curve.points):
        return False
    best_state = agent.load(result.agent_state, best_dir)
    finals = []
    for i in range(N_FINAL_EVALS.get(config, 5)):
        s, _ = evaluator.evaluate(agent, best_state, eval_index=10_000 + 7 * i)
        finals.append(round(float(score(s)), 2))
    curve.extra["final_evals"] = finals
    curve.extra["final_median"] = round(float(np.median(finals)), 2)
    print(f"  best-checkpoint fresh evals: {finals} "
          f"(median {curve.extra['final_median']})", flush=True)
    return True


def run_offline(config: str, seed: int, out: str, max_opts=None,
                device: DeviceLike = None) -> GateRun:
    """An offline gate config for one seed (≙ learning.py::run_offline)."""
    from border_tpu_torch.data import normalized_score
    from border_tpu_torch.record import BufferedRecorder
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import OfflineTrainer

    device = resolve_device(device)
    md, agent, cfg, evaluator, eval_env, meta = build_offline(
        config, seed, device, max_opts)
    buffer = ReplayBuffer(capacity=md.get_num_transitions(), device=device)
    buf_state = md.create_replay_buffer(buffer)
    vec = evaluator.vec
    agent_state = agent.init(seed, vec.observation_space, vec.action_space,
                             device=device)

    def norm(s):
        return normalized_score(s, md.ref_min, md.ref_max)

    curve = _Curve(out, {**meta, "device": device_label(device),
                         "target": TARGETS[config], "seed": seed},
                   {"max_opts": cfg.max_opts, "batch_size": cfg.batch_size})

    def on_eval(opt_steps, env_steps, score, best):
        curve.add({"opt_steps": int(opt_steps), "env_steps": 0,
                   "eval_return": round(float(norm(score)), 2),
                   "best": round(float(norm(best)), 2),
                   "raw_return": round(float(score), 2)})
        print(f"  opt {opt_steps:>6d}: normalized {norm(score):+.1f} "
              f"(best {norm(best):+.1f})", flush=True)

    model_dir = tempfile.mkdtemp(prefix=f"{config}_s{seed}_")
    trainer = OfflineTrainer(agent, buffer, cfg,
                             recorder=BufferedRecorder(model_dir=model_dir),
                             evaluator=evaluator,
                             updates_per_chunk=OFFLINE_UPDATES_PER_CHUNK,
                             eval_callback=on_eval)
    result = trainer.train(agent_state, buf_state, seed=1000 + seed)
    curve.extra["duration_sec"] = round(result.duration_sec, 2)
    if _certify(config, curve, agent, result, model_dir, evaluator, norm):
        on_eval(result.opt_steps, 0, curve.points[-1]["raw_return"],
                result.best_score)
    print(f"{config}: best_normalized={norm(result.best_score):.1f} "
          f"behavior={meta['behavior_normalized']:.1f} "
          f"duration={result.duration_sec:.0f}s", flush=True)
    return GateRun(curve.artifact(), trainer, result)


def run(config: str, seed: int, out: str, max_opts=None,
        device: DeviceLike = None, pendulum_env: Optional[str] = None) -> GateRun:
    """One gate config for one seed (≙ learning.py::run): trains, then
    certifies the best checkpoint on fresh evaluations; the artifact at
    ``out`` is rewritten after every evaluation.  ``max_opts`` overrides
    the config's; ``pendulum_env`` is :func:`build`'s (its default when
    None)."""
    from border_tpu_torch.record import BufferedRecorder
    from border_tpu_torch.train import HostEnvTrainer, Trainer

    if config in OFFLINE_CONFIGS:
        return run_offline(config, seed, out, max_opts=max_opts, device=device)
    device = resolve_device(device)
    env, agent, buffer, cfg, evaluator, meta = build(
        config, seed, device,
        **({} if pendulum_env is None else {"pendulum_env": pendulum_env}))
    if max_opts:
        cfg = cfg.replace(max_opts=max_opts)

    curve = _Curve(out, {**meta, "device": device_label(device),
                         "target": TARGETS[config], "seed": seed},
                   {"max_opts": cfg.max_opts, "num_envs": cfg.num_envs,
                    "batch_size": cfg.batch_size,
                    "opt_interval": cfg.opt_interval})

    def on_eval(opt_steps, env_steps, score, best):
        curve.add({"opt_steps": int(opt_steps), "env_steps": int(env_steps),
                   "eval_return": float(score), "best": float(best)})
        print(f"  opt {opt_steps:>8d}: eval return {score:+.1f} (best {best:+.1f})",
              flush=True)

    model_dir = tempfile.mkdtemp(prefix=f"{config}_s{seed}_")
    rec = BufferedRecorder(model_dir=model_dir)
    if meta.get("trainer") == "HostEnvTrainer":
        trainer = HostEnvTrainer(env, agent, buffer, cfg, recorder=rec,
                                 evaluator=evaluator, eval_callback=on_eval,
                                 device=device)
        try:
            result = trainer.train()
        finally:
            trainer.env.close()
        # the host/device overlap of the run's windows
        waits = [r["host_wait_frac"] for r in rec.records if "host_wait_frac" in r]
        if waits:
            curve.extra["host_wait_frac_mean"] = round(float(np.mean(waits)), 4)
            curve.extra["host_wait_frac_last"] = round(float(waits[-1]), 4)
    else:
        trainer = Trainer(env, agent, buffer, cfg, recorder=rec,
                          evaluator=evaluator, eval_callback=on_eval,
                          device=device)
        result = trainer.train()
    curve.extra["duration_sec"] = round(result.duration_sec, 2)
    if _certify(config, curve, agent, result, model_dir, evaluator, float):
        on_eval(result.opt_steps, result.env_steps,
                curve.points[-1]["eval_return"], result.best_score)
    print(f"{config}: best={result.best_score:.1f} "
          f"samples/s={result.samples_per_sec:,.0f} "
          f"duration={result.duration_sec:.0f}s", flush=True)
    return GateRun(curve.artifact(), trainer, result)


# -- the gate ---------------------------------------------------------------------
def _curve_paths(art_dir: str, name: str):
    """``<name>_curve.json`` (seed 0) and ``<name>_curve_seed<s>.json``."""
    return sorted(
        [p for p in (os.path.join(art_dir, f"{name}_curve.json"),)
         if os.path.exists(p)]
        + glob.glob(os.path.join(art_dir, f"{name}_curve_seed*.json")))


def gate(art_dir: Optional[str] = None) -> int:
    """The learning gate over ``art_dir`` (default ``artifacts/torch/``),
    bench.py's rule unchanged: every config needs at least 3 seeds, and on
    every seed the median of the best checkpoint's fresh evaluations
    (``final_evals``) must reach the target; a seed without them fails.
    Prints one JSON line, bench.py's; returns 0 when all pass, else 1."""
    art_dir = art_dir or ARTIFACTS
    results = {}
    ok = True
    for name in TARGETS:
        paths = _curve_paths(art_dir, name)
        if len(paths) < 3:
            results[name] = {"status": "MISSING_SEEDS", "seeds": len(paths),
                             "seeds_required": 3}
            ok = False
            continue
        seeds = {}
        target = None
        passed = True
        for p in paths:
            with open(p) as f:
                d = json.load(f)
            target = d.get("target")
            finals = d.get("final_evals")
            if not finals:
                seeds[str(d.get("seed", "?"))] = {
                    "status": "NO_FINAL_EVALS", "pass": False,
                }
                passed = False
                continue
            final_med = statistics.median(finals)
            seed_pass = target is None or final_med >= target
            best = max((pt["best"] for pt in d["curve"]), default=None)
            seeds[str(d.get("seed", "?"))] = {
                "final_median": round(float(final_med), 2),
                "best": None if best is None else round(float(best), 2),
                "pass": seed_pass,
            }
            passed = passed and seed_pass
        results[name] = {
            "status": "pass" if passed else "FAIL",
            "target": target,
            "rule": "median(5 fresh best-checkpoint evals) >= target, every seed",
            "seeds": seeds,
        }
        ok = ok and passed
    print(json.dumps({"metric": "learning_gate", "value": int(ok),
                      "unit": "pass", "vs_baseline": int(ok),
                      "results": results}))
    return 0 if ok else 1


def assemble(out: str, art_dir: Optional[str] = None) -> None:
    """Merge every config's per-seed artifacts under ``art_dir`` into one
    file."""
    art_dir = art_dir or ARTIFACTS
    merged = {}
    for name in sorted(TARGETS):
        seeds = {}
        for p in _curve_paths(art_dir, name):
            with open(p) as f:
                d = json.load(f)
            seeds[str(d.get("seed", "?"))] = d
        if seeds:
            merged[name] = seeds
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    for name, seeds in merged.items():
        for s, d in seeds.items():
            best = max((p["best"] for p in d["curve"]), default=None)
            wall = d["curve"][-1]["wall_sec"] if d["curve"] else None
            print(f"{name} seed {s}: max_opts={d['config'].get('max_opts')} "
                  f"best={best} final_median={d.get('final_median')} "
                  f"target={d.get('target')} train_sec={d.get('duration_sec')} "
                  f"run_sec={wall} device={d.get('device')}")


def artifact_path(config: str, seed: int, art_dir: Optional[str] = None) -> str:
    """The gate's name for ``config``'s seed ``seed``."""
    name = f"{config}_curve.json" if seed == 0 else f"{config}_curve_seed{seed}.json"
    return os.path.join(art_dir or ARTIFACTS, name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m border_tpu_torch.learning",
        description="Train a learning-gate config for one seed, or run the gate.")
    p.add_argument("config", choices=sorted(TARGETS) + ["assemble", "gate"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the same as --device cpu)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda, or cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="",
                   help="the artifact (default: artifacts/torch/ in the gate's "
                        "naming); for assemble, the merged file")
    p.add_argument("--artifacts", type=str, default="",
                   help="the artifacts' directory of gate and assemble "
                        "(default artifacts/torch/)")
    p.add_argument("--max-opts", type=int, default=0,
                   help="override the config's max_opts (the gate scores the "
                        "best checkpoint, not the curve's length)")
    p.add_argument("--pendulum-env", choices=sorted(PENDULUM_ENVS),
                   help="pendulum_host's envs: gymnasium's Pendulum-v1 (the "
                        "default, as the JAX config) or NumpyPendulum, its "
                        "equations in numpy; the artifact's env field names it")
    args = p.parse_args(argv)
    if args.config == "gate":
        return gate(args.artifacts or None)
    if args.config == "assemble":
        assemble(args.out or os.path.join(args.artifacts or ARTIFACTS,
                                          "learning.json"),
                 args.artifacts or None)
        return 0
    out = args.out or artifact_path(args.config, args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    options = {}
    if args.pendulum_env:
        if args.config != "pendulum_host":
            p.error("--pendulum-env is pendulum_host's")
        options["pendulum_env"] = args.pendulum_env
    r = run(args.config, args.seed, out, max_opts=args.max_opts or None,
            device="cpu" if args.cpu else args.device, **options)
    print(json.dumps(r.artifact), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
