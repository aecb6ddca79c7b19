"""Throughput bench of the port on one device (≙ bench.py less its gate).

    python -m border_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line with ``bench.py``'s keys plus ``device`` (the card's
name and power limit as ``nvidia-smi`` gives them, or ``cpu``).  The
headline is the env-steps/s of DQN-Pong training at ``bench.py``'s config
(1024 envs, 32 steps a chunk, batch 512, 8 gradient samples per
transition, a 1024 × 256-frame ring); the configs here are ``bench.py``'s,
field for field.

How a window is timed: the port's ``Trainer._chunk`` is called once
untimed (on the card that first call captures the chunk's CUDA graphs,
which takes the place of the JAX bench's compile), then ``n_chunks`` times;
the window ends with ``torch.cuda.synchronize()`` and one scalar read, the
counterpart of the JAX bench's ``device_get`` plus ``block_until_ready``.
On the card a chunk is CUDA-graph replays of the captured env step and
update, the frame gather launched inside every update.

The baselines (``vs_baseline``, ``cartpole_vs_baseline``) re-create the
reference Border's per-step loop: one env, a batch-1 act, one update
every env step and a host read every step.  The JAX bench runs that shape
with one ``jax.jit`` per function; here ``select_action``,
``process_step``/``push``, ``sample`` and ``update`` run eagerly each
step, the shape of Border's eager libtorch loop.  ``vs_baseline`` is
therefore the graphed chunk against the eager per-step loop on the same
device: an architecture-shape ratio, not a measurement of Border.
``BORDER_EST_HIGH`` and the estimate band are the JAX bench's estimate of
the Rust reference's asynchronous Atari throughput, not a measurement.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from border_tpu_torch.utils.device import DeviceLike, resolve_device

# chunks and steps of each bench (bench.py's defaults)
PONG_CHUNKS, PONG_BASE_STEPS, PONG_BASE_FILL = 20, 100, 40
CART_CHUNKS, CART_BASE_STEPS, CART_BASE_WARMUP, CART_BASE_FIRST_UPDATE = 10, 200, 70, 65
# the JAX bench's estimate band of real Border's async Atari env-steps/s
# (per-step ALE ~0.1-0.2 ms + batch-1 CNN forward ~0.3-2 ms per actor, ×8
# actors; BASELINE.md "Estimate band"); not a measurement
BORDER_EST_HIGH = 6_000.0
BORDER_EST_BAND = [1_000, 6_000]


def _sync(device: torch.device, x: torch.Tensor) -> None:
    """The end of a timed window: every queued kernel done, one scalar on
    the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    x.reshape(-1)[0].item()


def _first_tensor(state) -> torch.Tensor:
    """A tensor of an agent state (its first parameter)."""
    return next(state.params.parameters()).detach()


def _time_chunks(tr, n_chunks: int, do_update: bool = True):
    """(env-steps/s, updates/s) over ``n_chunks`` chunks after one untimed
    chunk, from fresh states (seed 0)."""
    cfg = tr.config
    agent_state, vec_state, buf_state = tr.init_states(0, 0)
    gen = torch.Generator(device=tr.device).manual_seed(0)
    agent_state, vec_state, buf_state, *_ = tr._chunk(
        agent_state, vec_state, buf_state, gen, do_update)
    _sync(tr.device, _first_tensor(agent_state))
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        agent_state, vec_state, buf_state, *_ = tr._chunk(
            agent_state, vec_state, buf_state, gen, do_update)
    _sync(tr.device, _first_tensor(agent_state))
    dt = time.perf_counter() - t0
    env_steps_s = n_chunks * cfg.steps_per_chunk * cfg.num_envs / dt
    updates_s = n_chunks * tr.updates_per_chunk / dt if do_update else 0.0
    return env_steps_s, updates_s


# -- the configs (bench.py's, field for field) ------------------------------------
def pong_fused_config(device: DeviceLike = None, capacity: int = 256, **cut):
    """bench_pong_fused's (env id, agent, buffer, TrainerConfig); ``cut``
    replaces TrainerConfig fields (``num_envs`` cuts the width, the ring
    following it), ``capacity`` the ring's depth."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer
    from border_tpu_torch.train import TrainerConfig

    agent = DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n), lr=1e-4,
                          double_dqn=True, soft_update_interval=2_000, tau=1.0))
    cfg = TrainerConfig(**{**dict(
        num_envs=1024, steps_per_chunk=32, batch_size=512,
        opt_interval=64,  # 8 gradient samples per transition (DQN-paper ratio)
        warmup_period=0, max_opts=10**9), **cut})
    buf = FrameReplayBuffer(capacity=capacity, num_envs=cfg.num_envs, device=device)
    return "Pong-v0", agent, buf, cfg


def pong_reference_config(device: DeviceLike = None):
    """bench_pong_reference_architecture's (env id, agent, buffer,
    num_envs)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer

    agent = DQN(DQNConfig(model=lambda n: AtariCNN(out_dim=n), lr=1e-4))
    return ("Pong-v0", agent,
            FrameReplayBuffer(capacity=4_096, num_envs=1, device=device), 1)


def cartpole_fused_config(device: DeviceLike = None, **cut):
    """bench_fused's (env id, agent, buffer, TrainerConfig); ``cut``
    replaces TrainerConfig fields."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.replay import ReplayBuffer
    from border_tpu_torch.train import TrainerConfig

    agent = DQN(DQNConfig(double_dqn=True))
    buffer = ReplayBuffer(capacity=65536, device=device)
    cfg = TrainerConfig(**{**dict(
        num_envs=4096, steps_per_chunk=64, batch_size=512, opt_interval=256,
        warmup_period=0, max_opts=10**9), **cut})
    return "CartPole-v1", agent, buffer, cfg


def cartpole_reference_config(device: DeviceLike = None):
    """bench_reference_architecture's (env id, agent, buffer, num_envs)."""
    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.replay import ReplayBuffer

    return ("CartPole-v1", DQN(DQNConfig(double_dqn=True)),
            ReplayBuffer(capacity=10_000, device=device), 1)


# -- the benches -------------------------------------------------------------------
def bench_pong_fused(n_chunks: int = PONG_CHUNKS, device: DeviceLike = None,
                     capacity: int = 256, **cut):
    """Fused DQN-Pong: env-steps/s and updates/s, plus the env-only rate
    (updates disabled).  ``capacity`` and ``cut``: see
    :func:`pong_fused_config`."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.train import Trainer

    device = resolve_device(device)
    env_id, agent, buf, cfg = pong_fused_config(device, capacity, **cut)
    tr = Trainer(make(env_id), agent, buf, cfg, device=device)
    train_eps, train_ups = _time_chunks(tr, n_chunks, do_update=True)
    env_only_eps, _ = _time_chunks(tr, n_chunks, do_update=False)
    return train_eps, train_ups, env_only_eps


def bench_pong_reference_architecture(n_steps: int = PONG_BASE_STEPS,
                                      device: DeviceLike = None) -> float:
    """Border's per-step shape on Pong, eager: 1 env, batch-1 act, one
    batch-32 update a step, a host read a step (the reference's loop reads
    every step on the host, trainer/sampler.rs:99-144)."""
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make

    device = resolve_device(device)
    env_id, agent, buffer, n = pong_reference_config(device)
    vec = VecEnv(make(env_id), n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    agent_state = agent.init(0, vec.observation_space, vec.action_space,
                             device=device)
    buf_state = buffer.init()
    vec_state = vec.reset(0)

    def step():
        nonlocal vec_state, buf_state
        action = agent.select_action(agent_state, vec_state.obs, gen)
        prev_obs, prev_len = vec_state.obs, vec_state.episode_length
        ts, vec_state = vec.step(vec_state, action)
        buf_state = buffer.process_step(buf_state, prev_obs, action, ts, prev_len)
        return ts

    for _ in range(PONG_BASE_FILL):  # fill
        step().reward.cpu()
    agent_state, _, _ = agent.update(agent_state, buffer.sample(buf_state, gen, 32), gen)
    _sync(device, _first_tensor(agent_state))

    t0 = time.perf_counter()
    for _ in range(n_steps):
        ts = step()
        agent_state, _, _ = agent.update(agent_state,
                                         buffer.sample(buf_state, gen, 32), gen)
        ts.reward.cpu()  # per-step host read, as in the reference
    _sync(device, _first_tensor(agent_state))
    return n_steps / (time.perf_counter() - t0)


def bench_fused(n_chunks: int = CART_CHUNKS, device: DeviceLike = None,
                **cut) -> float:
    """Fused vectorized CartPole trainer: env-steps/s over steady-state
    chunks (4096 envs, 1 update per 256 transitions)."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.train import Trainer

    device = resolve_device(device)
    env_id, agent, buffer, cfg = cartpole_fused_config(device, **cut)
    tr = Trainer(make(env_id), agent, buffer, cfg, device=device)
    eps, _ = _time_chunks(tr, n_chunks, do_update=True)
    return eps


def bench_reference_architecture(n_steps: int = CART_BASE_STEPS,
                                 device: DeviceLike = None) -> float:
    """Border's per-step synchronous loop on CartPole, eager: 1 env, a
    batch-1 act, one batch-64 update every env step (≙
    examples/gym/dqn_cartpole), a host read every step."""
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make
    from border_tpu_torch.replay import Transition
    from border_tpu_torch.train.trainer import example_transition

    device = resolve_device(device)
    env_id, agent, buffer, n = cartpole_reference_config(device)
    vec = VecEnv(make(env_id), n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    agent_state = agent.init(0, vec.observation_space, vec.action_space,
                             device=device)
    buf_state = buffer.init(example_transition(
        vec.observation_space, vec.action_space, device))
    vec_state = vec.reset(0)

    def step(do_update):
        nonlocal agent_state, vec_state, buf_state
        action = agent.select_action(agent_state, vec_state.obs, gen)
        prev_obs = vec_state.obs
        ts, vec_state = vec.step(vec_state, action)
        buf_state = buffer.push(buf_state, Transition(
            obs=prev_obs, act=action, next_obs=ts.final_obs, reward=ts.reward,
            terminated=ts.terminated, truncated=ts.truncated))
        if do_update:
            agent_state, _, _ = agent.update(
                agent_state, buffer.sample(buf_state, gen, 64), gen)
        ts.reward.cpu()  # per-step host read, as in the reference

    for i in range(CART_BASE_WARMUP):  # warmup fill
        step(i >= CART_BASE_FIRST_UPDATE)
    _sync(device, _first_tensor(agent_state))

    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(True)
    _sync(device, _first_tensor(agent_state))
    return n_steps / (time.perf_counter() - t0)


def result_line(pong_eps, pong_ups, pong_env_only, pong_base, cp_fused, cp_base,
                device: str) -> dict:
    """The bench's JSON line: bench.py's keys, and ``device``."""
    return {
        "metric": "dqn_pong_env_steps_per_sec",
        "value": round(pong_eps, 1),
        "unit": "env-steps/s/device",
        "vs_baseline": round(pong_eps / pong_base, 2),
        "baseline_def": "architecture-shape ratio: the graphed chunk vs the "
                        "reference's per-step loop shape (1 env, batch-1 CNN "
                        "act, 1 update/step, host read/step) run eagerly on the "
                        "same device; not real Border",
        "vs_border_estimate": round(pong_eps / BORDER_EST_HIGH, 1),
        "border_estimate_band_env_steps_per_sec": BORDER_EST_BAND,
        "pong_updates_per_sec": round(pong_ups, 1),
        "pong_ale_frames_per_sec": round(4 * pong_eps, 1),
        "pong_env_only_steps_per_sec": round(pong_env_only, 1),
        "baseline_env_steps_per_sec": round(pong_base, 1),
        "cartpole_env_steps_per_sec": round(cp_fused, 1),
        "cartpole_vs_baseline": round(cp_fused / cp_base, 2),
        "device": device,
    }


def _free(device: torch.device) -> None:
    """Drop the last bench's ring before the next."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> dict:
    from border_tpu_torch.learning import device_label

    p = argparse.ArgumentParser(
        prog="python -m border_tpu_torch.bench",
        description="Training throughput of the port: one JSON line.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda, or cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pong_eps, pong_ups, pong_env_only = bench_pong_fused(device=device)
    _free(device)
    pong_base = bench_pong_reference_architecture(device=device)
    _free(device)
    cp_fused = bench_fused(device=device)
    _free(device)
    cp_base = bench_reference_architecture(device=device)
    line = result_line(pong_eps, pong_ups, pong_env_only, pong_base, cp_fused,
                       cp_base, device_label(device))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
