"""Worker ranks for the port's multi-process tests (gloo on the CPU).

    python tests/helpers/torch_dist_worker.py <spec.json> <rank>

``spec.json``: ``{"world": n, "store": <file>, "out": <dir>, "tasks":
[[<id>, <task name>, {args}], ...]}``.  Every rank joins one gloo group
through a ``FileStore`` and runs the tasks in order; task ``<id>`` writes
``<out>/<id>.rank<r>.npz`` (the arrays and numbers it returns).  A rank
imports torch, numpy and the port only (the test modules import JAX).

:func:`launch` starts the ranks as subprocesses and waits for them, with a
timeout, so a deadlock fails the test that launched them; :func:`results`
reads what a task wrote.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- the parent's side ---------------------------------------------------------

def launch(tmp_path, world: int, tasks: List[list], timeout: float = 240.0) -> None:
    """Run ``tasks`` on ``world`` spawned ranks; raises with the ranks'
    errors if one fails or the ranks outlast ``timeout`` seconds."""
    out = os.path.join(str(tmp_path), "out")
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(str(tmp_path), "spec.json")
    with open(spec, "w") as f:
        json.dump({"world": world, "store": os.path.join(str(tmp_path), "store"),
                   "out": out, "tasks": tasks}, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, __file__, spec, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"the ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("\n".join(errors))


def results(tmp_path, task_id: str, world: int) -> List[Dict[str, np.ndarray]]:
    """Each rank's arrays of task ``task_id``."""
    out = []
    for r in range(world):
        with np.load(os.path.join(str(tmp_path), "out",
                                  f"{task_id}.rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# -- the agents of the data-parallel update cases -------------------------------

def port_case(case: str):
    """``(agent, obs_space, act_space)`` of an update case; the JAX tests
    build the same configurations."""
    import torch

    from border_tpu_torch import agents
    from border_tpu_torch.core import spaces
    from border_tpu_torch.models import AtariCNN

    vec = lambda n: spaces.Box(-np.inf, np.inf, (n,), torch.float32)  # noqa: E731
    box2 = spaces.Box(-1.0, 1.0, (2,), torch.float32)
    if case == "dqn_mlp":
        return (agents.DQN(agents.DQNConfig(hidden=(16, 12), lr=1e-3,
                                            double_dqn=True, tau=0.5,
                                            max_grad_norm=0.5)),
                vec(5), spaces.Discrete(3))
    if case == "dqn_cnn":
        return (agents.DQN(agents.DQNConfig(
            model=lambda n: AtariCNN(n, dtype=torch.float32), optimizer="sgd",
            lr=1e-2, double_dqn=True, tau=0.5)),
            spaces.Box(0, 255, (84, 84, 4), torch.uint8), spaces.Discrete(6))
    if case == "iqn":
        return (agents.IQN(agents.IQNConfig(feature_dim=16, n_cos=8,
                                            hidden=(12,), tau=0.5)),
                vec(5), spaces.Discrete(3))
    if case == "sac":
        return (agents.SAC(agents.SACConfig(actor_hidden=(16, 12),
                                            critic_hidden=(16, 12),
                                            ent_coef_mode="auto",
                                            ent_lr=1e-2)),
                vec(6), box2)
    if case == "iql":
        return (agents.IQL(agents.IQLConfig(actor_hidden=(16, 12),
                                            critic_hidden=(16, 12),
                                            value_hidden=(12,))),
                vec(6), box2)
    raise ValueError(case)


def state_arrays(state) -> Dict[str, np.ndarray]:
    """Every module's state dict and tensor field of an agent state,
    ``<field>/<key>``."""
    import dataclasses

    import torch
    from torch import nn

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            for k, t in v.state_dict().items():
                out[f"{f.name}/{k}"] = t.detach().cpu().numpy()
        elif torch.is_tensor(v):
            out[f.name] = v.detach().cpu().numpy()
    return out


# -- tasks ---------------------------------------------------------------------

def _batch(z, prefix):
    import torch

    from border_tpu_torch.replay import TransitionBatch

    fields = ("obs", "act", "next_obs", "reward", "terminated", "truncated")
    return TransitionBatch(**{k: torch.from_numpy(z[f"{prefix}{k}"]) for k in fields})


def task_dp_update(rank, world, args):
    """Two updates of a case's agent on this rank's batches, the gradients
    averaged over the world (or, with ``single``, rank 0 alone on the
    ranks' batches laid end to end)."""
    import torch
    import torch.distributed as dist

    agent, obs_space, act_space = port_case(args["case"])
    state = agent.load(agent.init(0, obs_space, act_space, device="cpu"),
                       args["state_dir"])
    agent.axis_group = dist.group.WORLD
    z = np.load(args["data"])
    ranks = [rank]
    if args.get("single"):
        agent.axis_group = None
        ranks = list(range(world))
    for k in range(args["updates"]):
        parts = [f"r{r}_k{k}_" for r in ranks]
        batches = [_batch(z, p) for p in parts]
        batch = type(batches[0])(**{
            f: torch.cat([getattr(b, f) for b in batches])
            for f in ("obs", "act", "next_obs", "reward", "terminated", "truncated")})
        kw = {}
        if f"{parts[0]}taus0" in z:
            kw["taus"] = tuple(torch.cat([torch.from_numpy(z[f"{p}taus{i}"])
                                          for p in parts]) for i in range(3))
        if f"{parts[0]}noise0" in z:
            kw["noise"] = tuple(torch.cat([torch.from_numpy(z[f"{p}noise{i}"])
                                           for p in parts]) for i in range(2))
        state, metrics, _ = agent.update(state, batch, **kw)
    return state_arrays(state)


def _cartpole_cfg(world, **kw):
    from border_tpu_torch.train import TrainerConfig

    base = dict(num_envs=2 * world, steps_per_chunk=4, batch_size=2 * world,
                opt_interval=8, warmup_period=0, max_opts=4, eval_interval=10**9)
    base.update(kw)
    return TrainerConfig(**base)


def _agent(kind):
    import functools

    import torch

    from border_tpu_torch import agents
    from border_tpu_torch.models import AtariCNN

    if kind in ("dqn", "dqn_per"):
        return agents.DQN(agents.DQNConfig(hidden=(8,)))
    if kind == "pong":
        return agents.DQN(agents.DQNConfig(
            model=functools.partial(AtariCNN, dtype=torch.float32), lr=1e-4))
    if kind == "iqn":
        return agents.IQN(agents.IQNConfig(hidden=(16,), feature_dim=16, n_cos=8))
    if kind == "sac":
        return agents.SAC(agents.SACConfig(actor_hidden=(8,), critic_hidden=(8,)))
    if kind == "awac":
        return agents.AWAC(agents.AWACConfig(actor_hidden=(8,), critic_hidden=(8,)))
    if kind == "iql":
        return agents.IQL(agents.IQLConfig(actor_hidden=(8,), critic_hidden=(8,),
                                           value_hidden=(8,)))
    if kind == "bc":
        return agents.BC(agents.BCConfig(hidden=(8,), action_mode="discrete"))
    raise ValueError(kind)


ENV = {"dqn": "CartPole-v1", "dqn_per": "CartPole-v1", "iqn": "CartPole-v1",
       "bc": "CartPole-v1", "sac": "Pendulum-v1", "awac": "Pendulum-v1",
       "iql": "Pendulum-v1", "pong": "Pong-v0"}


def _buffer(kind, cfg, capacity=128):
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig, ReplayBuffer

    if kind == "pong":
        return FrameReplayBuffer(capacity=32, num_envs=cfg.num_envs, device="cpu")
    per = PerConfig() if kind == "dqn_per" else None
    return ReplayBuffer(capacity, per=per, device="cpu")


def task_sharded_train(rank, world, args):
    """``train()`` of a ShardedTrainer (or ShardedAsyncTrainer); the final
    parameters, the counters and the replay fill of this rank."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.parallel import ShardedAsyncTrainer, ShardedTrainer

    kind = args["kind"]
    cfg = _cartpole_cfg(world, **args.get("cfg", {}))
    cls = ShardedAsyncTrainer if args.get("async") else ShardedTrainer
    tr = cls(make(ENV[kind]), _agent(kind), _buffer(kind, cfg), cfg, device="cpu")
    res = tr.train()
    return {**state_arrays(res.agent_state), "opt_steps": res.opt_steps,
            "env_steps": res.env_steps, "local_envs": tr.local_envs,
            "fill": tr.buffer.fill(res.buffer_state)}


def task_sharded_chunk(rank, world, args):
    """``init_states`` and one ``_chunk`` with updates: the parameters, the
    rank's buffer, the fill summed over the shards and the draws of the
    loop generator."""
    import torch

    from border_tpu_torch.envs import make
    from border_tpu_torch.parallel import ShardedTrainer

    kind = args["kind"]
    cfg = _cartpole_cfg(world, **args.get("cfg", {}))
    tr = ShardedTrainer(make(ENV[kind]), _agent(kind), _buffer(kind, cfg), cfg,
                        device="cpu")
    agent_state, vec_state, buf_state = tr.init_states(0, 0)
    gen = tr._loop_generator(0)
    noise = torch.randn(1, 4, generator=tr._loop_generator(0))
    agent_state, vec_state, buf_state, metrics, _, _ = tr._chunk(
        agent_state, vec_state, buf_state, gen, True)
    out = {**state_arrays(agent_state), "n_opts": agent_state.n_opts,
           "local_envs": tr.local_envs, "buffer_num_envs": getattr(tr.buffer, "num_envs", -1),
           "fill_sum": tr._buffer_fill(buf_state),
           "loss": float(metrics["loss"]), "noise": noise.numpy(),
           "obs0": vec_state.obs.numpy()}
    if kind == "pong":
        out["frames_shape"] = np.asarray(buf_state.frames.shape)
        out["total"] = buf_state.total
    else:
        out["size"] = buf_state.size
    return out


def task_graphable(rank, world, args):
    """Whether ShardedTrainer and ShardedAsyncTrainer graph their chunk
    over this group's backend: ``graphable``, the resolved ``cuda_graphs``
    and whether ``cuda_graphs=True`` raises ``ConfigError``."""
    from border_tpu_torch.envs import make
    from border_tpu_torch.errors import ConfigError
    from border_tpu_torch.parallel import ShardedAsyncTrainer, ShardedTrainer

    cfg = _cartpole_cfg(world)
    out = {}
    for cls in (ShardedTrainer, ShardedAsyncTrainer):
        tr = cls(make("CartPole-v1"), _agent("dqn"), _buffer("dqn", cfg), cfg,
                 device="cpu")
        out[f"{cls.__name__}/graphable"] = tr.graphable
        out[f"{cls.__name__}/cuda_graphs"] = tr.cuda_graphs
        try:
            cls(make("CartPole-v1"), _agent("dqn"), _buffer("dqn", cfg), cfg,
                device="cpu", cuda_graphs=True)
            out[f"{cls.__name__}/true_raises"] = False
        except ConfigError:
            out[f"{cls.__name__}/true_raises"] = True
    return out


def _gspmd_cfg(**kw):
    from border_tpu_torch.train import TrainerConfig

    base = dict(num_envs=8, steps_per_chunk=4, batch_size=16, opt_interval=2,
                warmup_period=0, max_opts=16, eval_interval=10**9, seed=5)
    base.update(kw)
    return TrainerConfig(**base)


def gspmd_case(kind: str, **agent_kw):
    """``(env, agent, buffer, config)`` of a GSPMD numerics case: CartPole
    DQN 32x32 on the flat ring (uniform or prioritized), or Pong DQN on the
    float32 AtariCNN, with SGD, on a prioritized frame ring.  The tests
    build the plain Trainer from the same."""
    import torch

    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.replay import FrameReplayBuffer, PerConfig, ReplayBuffer

    if kind == "pong_per":
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                              optimizer="sgd", lr=1e-2, **agent_kw))
        return (make("Pong-v0"), agent,
                FrameReplayBuffer(16, 8, per=PerConfig(), device="cpu"),
                _gspmd_cfg(steps_per_chunk=8, batch_size=8, opt_interval=16,
                           max_opts=8))
    per = PerConfig() if kind == "cartpole_per" else None
    return (make("CartPole-v1"), DQN(DQNConfig(hidden=(32, 32), lr=1e-3, **agent_kw)),
            ReplayBuffer(256, per=per, device="cpu"), _gspmd_cfg())


def task_gspmd_train(rank, world, args):
    """``train()`` of a GSPMDTrainer on a :func:`gspmd_case`: the gathered
    parameters, the local shapes and the counters."""
    from border_tpu_torch.parallel import GSPMDTrainer, make_dp_tp_mesh
    from border_tpu_torch.parallel.gspmd import full_state_dict

    tr = GSPMDTrainer(*gspmd_case(args["kind"], **args.get("agent", {})),
                      mesh=make_dp_tp_mesh(*args["mesh"]), device="cpu")
    res = tr.train()
    out = {f"full/{k}": v.numpy() for k, v in full_state_dict(
        res.agent_state.params).items()}
    out.update({f"local/{k}": np.asarray(v.shape) for k, v in
                res.agent_state.params.state_dict().items()})
    out["opt_steps"] = res.opt_steps
    return out


def task_gspmd_parts(rank, world, args):
    """A 2x2 GSPMDTrainer: what each rank holds, and the collectives of one
    update counted per group."""
    import torch

    from border_tpu_torch.agents import DQN, DQNConfig
    from border_tpu_torch.envs import make
    from border_tpu_torch.models import AtariCNN
    from border_tpu_torch.parallel import GSPMDTrainer, make_dp_tp_mesh
    from border_tpu_torch.replay import FrameReplayBuffer, ReplayBuffer
    from border_tpu_torch.utils import collectives

    mesh = make_dp_tp_mesh(2, 2)
    pixel = args.get("pixel", False)
    if pixel:
        cfg = _gspmd_cfg(num_envs=2 * world, batch_size=2 * world, opt_interval=8,
                         max_opts=10**9)
        agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                              lr=1e-4))
        env, buf = make("Pong-v0"), FrameReplayBuffer(16, cfg.num_envs, device="cpu")
    else:
        cfg = _gspmd_cfg()
        agent = DQN(DQNConfig(hidden=(32, 32)))
        env, buf = make("CartPole-v1"), ReplayBuffer(256, device="cpu")
    tr = GSPMDTrainer(env, agent, buf, cfg, mesh=mesh, device="cpu")
    agent_state, vec_state, buf_state = tr.init_states(0, 1)
    gen = tr._loop_generator(0)
    agent_state, vec_state, buf_state, _, _, _ = tr._chunk(
        agent_state, vec_state, buf_state, gen, False)
    tr.updates_per_chunk = 1
    collectives.counts.clear()
    agent_state, buf_state, metrics = tr._update_scan(agent_state, buf_state, gen)
    names = {"actors": tr.actors_group.group_name,
             "model": tr.model_group.group_name}
    out = {f"count/{g}": collectives.counts["all_reduce", n]
           for g, n in names.items()}
    out.update({f"shape/{k}": np.asarray(v.shape) for k, v in
                agent_state.params.state_dict().items()})
    out.update({f"sharded/{k}": hasattr(v, "tp_group") for k, v in
                agent_state.params.state_dict(keep_vars=True).items()})
    out.update({f"adam/{i}": np.asarray(s["exp_avg"].shape) for i, s in
                enumerate(agent_state.opt_state.state.values())})
    out["env_rows"] = vec_state.episode_length.shape[0]
    out["loss"] = float(metrics["loss"])
    if pixel:
        out["frames_shape"] = np.asarray(buf_state.frames.shape)
        out["total"] = buf_state.total
    return out


TASKS = {"dp_update": task_dp_update, "sharded_train": task_sharded_train,
         "graphable": task_graphable,
         "sharded_chunk": task_sharded_chunk, "gspmd_train": task_gspmd_train,
         "gspmd_parts": task_gspmd_parts}


def main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=world)
    try:
        for task_id, name, args in spec["tasks"]:
            torch.manual_seed(0)
            out = TASKS[name](rank, world, args)
            np.savez(os.path.join(spec["out"], f"{task_id}.rank{rank}.npz"),
                     **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
