"""dp×tp trainer over a 2-D ``("actors", "model")`` mesh (≙ border_tpu/
parallel/gspmd.py).

The JAX trainer places its states with shardings and lets XLA partition
the unsharded ``Trainer``'s chunk: one global program.  Here every rank
runs the chunk on its part of the states and the collectives are written
out, with the same contract:

- every ≥2-D weight whose output-feature axis divides by ``tp`` is
  column-sharded over ``model`` (dim 0 of a ``Linear`` or ``Conv2d``
  weight, the last axis of an ``EnsembleMLP`` kernel; the flax kernel's
  last axis), its Adam moments and its target copy with it: each rank
  holds ``out/tp`` rows.  A sharded layer computes its block of output
  features and gathers the blocks over ``model`` (``models/cnn.py``); what
  follows is replicated, so the gather's backward slices.  1-D leaves
  (biases, scales) are replicated;
- env state is sharded over ``actors``: each rank holds ``num_envs/dp``
  rows;
- a frame ring's env axis is sharded over ``actors`` (the ring is the
  dominant tenant of device memory at pixel scale); a flat ring is
  replicated;
- the trajectory equals the unsharded ``Trainer``'s up to the order of
  reductions.

How the trajectory stays the unsharded one: every rank holds one loop
generator, seeded as the ``Trainer``'s, and makes the global-size draws
(actions, env steps, replay samples), keeping its rows.  An env step or an
action draws inside the env's or the agent's code at the batch's size, so a
rank steps its rows tiled ``dp`` times to the global batch and keeps its
own block: env state is stored sharded, but the env step's and the
acting forward's compute is ``dp``-fold (none at ``dp = 1``).  A flat ring
pushes the global step gathered over ``actors``.  A replay sample is drawn
globally and assembled exactly (each rank reads the rows of its ring
columns, zeros elsewhere, summed over ``actors``); each ``actors`` rank
takes the loss on its ``batch/dp`` rows and the agent averages the
gradients over ``actors``.  PER's tree is replicated and updated from the
TD errors gathered over ``actors``.  An agent whose update draws (IQN's τ,
SAC's noise) draws from the loop generator at ``dp = 1``, and at ``dp > 1``
from a generator of its ``actors`` rank, so its draws then differ from the
unsharded run's; DQN's update draws nothing.

Like the JAX class it takes no checkpoint manager; it also saves no models
(a sharded parameter is a block on each rank: :func:`full_state_dict`
gathers it).  At ``dp > 1`` the updates run in the sequential order
(neither ``prefetch_sample`` nor ``updates_per_sample_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, Timestep, index_seed
from border_tpu_torch.errors import ConfigError
from border_tpu_torch.models.mlp import EnsembleMLP
from border_tpu_torch.parallel.mesh import make_mesh
from border_tpu_torch.parallel.sharded import broadcast_state_, mean_metrics
from border_tpu_torch.record.recorder import Recorder
from border_tpu_torch.replay.buffer import map_obs
from border_tpu_torch.replay.frame_buffer import FrameReplayBuffer
from border_tpu_torch.train.config import TrainerConfig
from border_tpu_torch.train.evaluator import Evaluator
from border_tpu_torch.train.graphs import add_metrics
from border_tpu_torch.train.trainer import Trainer, _slice_batch
from border_tpu_torch.utils import collectives
from border_tpu_torch.utils.device import DeviceLike


def make_dp_tp_mesh(dp: int, tp: int):
    """A ``(dp, tp)`` mesh with axes ``("actors", "model")`` over every rank,
    row-major: a ``model`` group is ``tp`` neighbouring ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp != world:
        raise ValueError(f"dp×tp = {dp * tp} != {world} devices")
    return make_mesh(("actors", "model"), (dp, tp))


# -- column sharding -----------------------------------------------------------

def _block(w: nn.Parameter, dim: int, rank: int, tp: int,
           group_name: str) -> nn.Parameter:
    k = w.shape[dim] // tp
    p = nn.Parameter(w.detach().narrow(dim, rank * k, k).clone(),
                     requires_grad=w.requires_grad)
    p.tp_group, p.tp_dim = group_name, dim % w.dim()
    return p


def shard_columns_(module: nn.Module, group_name: str, rank: int,
                   tp: int) -> Dict[nn.Parameter, nn.Parameter]:
    """Replace, in place, every weight of ``module`` whose output-feature
    axis divides by ``tp`` by the rank's block of it; returns
    ``{old parameter: new}``."""
    new = {}
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.weight.shape[0] % tp == 0:
            old = m.weight
            m.weight = new[old] = _block(old, 0, rank, tp, group_name)
        elif isinstance(m, EnsembleMLP):
            for i, old in enumerate(m.weights):
                if old.shape[-1] % tp == 0:
                    m.weights[i] = new[old] = _block(old, -1, rank, tp, group_name)
    return new


@torch.no_grad()
def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every column-sharded weight gathered
    over its model group (a collective: every rank of the group calls
    it)."""
    out = {}
    for k, v in module.state_dict(keep_vars=True).items():
        name = getattr(v, "tp_group", None)
        out[k] = v.detach() if name is None else collectives.gather_rows(
            v.detach(), collectives.group_by_name(name), v.tp_dim)
    return out


class ActorShardedFrames:
    """A :class:`FrameReplayBuffer` whose env columns are sharded over the
    ``actors`` group: the rank's ring holds ``num_envs/dp`` columns, while
    the draws, the fill, the sum tree and the priority updates are the
    global buffer's (replicated).  Any other attribute reads the global
    buffer's."""

    def __init__(self, buffer: FrameReplayBuffer, rank: int, n: int, group):
        self.glob, self.rank, self.group = buffer, rank, group
        self.local = FrameReplayBuffer(
            capacity=buffer.capacity, num_envs=buffer.num_envs // n,
            frame_hw=buffer.frame_hw, stack=buffer.stack,
            n_step=buffer.n_step, gamma=buffer.gamma,
            sample_mode=buffer.sample_mode, slice_group=1,
            device=buffer.device)

    def __getattr__(self, name):
        return getattr(self.glob, name)

    def init(self, example=None):
        state = self.local.init()
        if self.glob.tree is not None:
            state.tree = self.glob.tree.init()
        return state

    def process_step(self, state, prev_obs, action, ts, prev_ep_len):
        """Push the rank's rows; the tree's residency update is global."""
        if self.glob.tree is not None:
            self.glob._tree_push(state, state.total % self.glob.capacity)
        return self.local.process_step(state, prev_obs, action, ts, prev_ep_len)

    def fill(self, state) -> int:
        return self.glob.fill(state)

    def sample(self, state, gen: torch.Generator, batch_size: int,
               n_opts: Optional[int] = None):
        """The global batch: drawn globally, each row read by the rank that
        holds its env column and summed over ``actors`` (exact)."""
        g = self.glob
        if g.per is not None:
            e, s, w = g.draw_per(state, gen, batch_size, n_opts or 0)
        else:
            (e, s), w = g.draw(state, gen, batch_size), None
        k = self.local.num_envs
        own = e // k == self.rank
        b = self.local.sample_at(state, torch.where(own, e - self.rank * k, 0), s)

        def assemble(x):
            mask = own.view(-1, *(1,) * (x.dim() - 1))
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            return collectives.all_reduce_(torch.where(mask, x, zero), self.group)

        rows = {f.name: map_obs(assemble, getattr(b, f.name))
                for f in dataclasses.fields(b)
                if getattr(b, f.name) is not None
                and f.name not in ("weight", "ix_sample")}
        return dataclasses.replace(
            b, **rows, weight=w,
            ix_sample=(e * g.capacity + s % g.capacity).to(torch.int32))

    def update_priority(self, state, ix_sample, td_err):
        return self.glob.update_priority(state, ix_sample, td_err)


def _map_rows(x, n: int, fn):
    """``fn`` on every tensor of a (nested) dataclass or dict whose leading
    axis is ``n``; anything else passes through."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _map_rows(getattr(x, f.name), n, fn)
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _map_rows(v, n, fn) for k, v in x.items()}
    if torch.is_tensor(x) and x.dim() and x.shape[0] == n:
        return fn(x)
    return x


class GSPMDTrainer(Trainer):
    """Trainer over a dp×tp mesh: env state, frame ring and batch rows
    sharded over ``actors``, weights column-sharded over ``model``.  The
    chunk runs eagerly (its collectives are outside any graph)."""

    graphable = False

    def __init__(
        self,
        env: Environment,
        agent: Agent,
        buffer,
        config: TrainerConfig = TrainerConfig(),
        recorder: Optional[Recorder] = None,
        evaluator: Optional[Evaluator] = None,
        mesh=None,
        device: DeviceLike = None,
    ):
        if mesh is None:
            mesh = make_dp_tp_mesh(1, dist.get_world_size())
        if set(mesh.mesh_dim_names or ()) != {"actors", "model"}:
            raise ValueError("GSPMDTrainer needs a ('actors','model') mesh")
        if recorder is not None and recorder.model_dir is not None:
            raise ValueError("GSPMDTrainer saves no models: a sharded weight "
                             "is a block on each rank (full_state_dict)")
        self.mesh = mesh
        self.actors_group = mesh.get_group("actors")
        self.model_group = mesh.get_group("model")
        self.dp = dist.get_world_size(self.actors_group)
        self.tp = dist.get_world_size(self.model_group)
        self.dp_rank = dist.get_rank(self.actors_group)
        self.tp_rank = dist.get_rank(self.model_group)
        super().__init__(env, agent, buffer, config,
                         recorder if dist.get_rank() == 0 else None,
                         evaluator, device=device)
        c = config
        if c.num_envs % self.dp:
            raise ValueError("num_envs must divide the actors axis")
        if c.batch_size % self.dp:
            raise ValueError("batch_size must divide the actors axis")
        if self.dp > 1 and (c.prefetch_sample or c.updates_per_sample_batch > 1):
            raise ConfigError("GSPMDTrainer at dp > 1 runs the sequential "
                              "update order: no prefetch_sample or "
                              "updates_per_sample_batch")
        self.local_envs = c.num_envs // self.dp
        self.local_batch = c.batch_size // self.dp
        self.model_name = collectives.register_group(self.model_group, "model")
        if self.dp > 1 and isinstance(buffer, FrameReplayBuffer):
            self.buffer = ActorShardedFrames(buffer, self.dp_rank, self.dp,
                                             self.actors_group)
        agent.axis_group = self.actors_group
        self._loop_generator(c.seed)  # sets the update's generator

    # -- state ---------------------------------------------------------------
    def init_states(self, seed_agent, seed_env):
        """The unsharded states, then each rank keeps its part."""
        agent_state, vec_state, buffer_state = super().init_states(
            seed_agent, seed_env)
        broadcast_state_(agent_state)
        new: Dict[nn.Parameter, nn.Parameter] = {}
        for f in dataclasses.fields(agent_state):
            v = getattr(agent_state, f.name)
            if isinstance(v, nn.Module):
                new.update(shard_columns_(v, self.model_name, self.tp_rank, self.tp))
        for f in dataclasses.fields(agent_state):
            v = getattr(agent_state, f.name)
            if isinstance(v, torch.optim.Optimizer):  # fresh: no moments yet
                for group in v.param_groups:
                    group["params"] = [new.get(p, p) for p in group["params"]]
        return agent_state, self._own(vec_state), buffer_state

    def _loop_generator(self, seed: int) -> torch.Generator:
        """The shared loop generator (the Trainer's); the update's draws
        come from it at dp = 1 and from a generator of the actors rank
        otherwise."""
        gen = super()._loop_generator(seed)
        self._update_gen = gen if self.dp == 1 else torch.Generator(
            device=self.device).manual_seed(index_seed(seed + 3, self.dp_rank))
        return gen

    # -- rows ----------------------------------------------------------------
    def _own(self, x):
        """The rank's rows of global-size tensors."""
        lo = self.dp_rank * self.local_envs
        return _map_rows(x, self.config.num_envs,
                         lambda t: t[lo:lo + self.local_envs])

    def _tiled(self, x):
        """The rank's rows tiled to the global batch, its own in its block."""
        return _map_rows(x, self.local_envs, lambda t: torch.cat([t] * self.dp))

    def _gathered(self, x):
        return map_obs(lambda t: collectives.gather_rows(t, self.actors_group), x)

    # -- the chunk -----------------------------------------------------------
    def _env_scan(self, agent_state, vec_state, buf_state,
                  gen: torch.Generator, explore: bool):
        if self.dp == 1:
            return super()._env_scan(agent_state, vec_state, buf_state, gen,
                                     explore)
        act = self.agent.select_action if explore else self.agent.select_action_eval
        flat = not isinstance(self.buffer, ActorShardedFrames)
        ep_ret = torch.zeros((), device=self.device)
        ep_cnt = torch.zeros((), device=self.device)
        for _ in range(self.config.steps_per_chunk):
            action = self._own(act(agent_state, self._tiled(vec_state.obs), gen))
            prev_obs = vec_state.obs
            prev_ep_len = vec_state.episode_length
            ts, vec_all = self.vec.step(self._tiled(vec_state), self._tiled(action))
            ts, vec_state = self._own(ts), self._own(vec_all)
            if flat:  # the replicated ring takes the global step
                g = self._gathered
                buf_state = self.buffer.process_step(
                    buf_state, g(prev_obs), g(action),
                    Timestep(obs=None, final_obs=g(ts.final_obs),
                             reward=g(ts.reward), terminated=g(ts.terminated),
                             truncated=g(ts.truncated), info={}),
                    g(prev_ep_len))
            else:
                buf_state = self.buffer.process_step(
                    buf_state, prev_obs, action, ts, prev_ep_len)
            agent_state = self.agent.on_env_step(agent_state, self.config.num_envs)
            done_f = ts.done.float()
            ep_ret += (done_f * vec_state.last_return).sum()
            ep_cnt += done_f.sum()
        ep_ret, ep_cnt = collectives.all_reduce_(
            torch.stack([ep_ret, ep_cnt]), self.actors_group).unbind()
        return agent_state, vec_state, buf_state, ep_ret, ep_cnt

    def _update_scan(self, agent_state, buf_state, gen: torch.Generator):
        if self.dp == 1:
            return super()._update_scan(agent_state, buf_state, gen)
        B, M = self.config.batch_size, self.updates_per_chunk
        lo = self.dp_rank * self.local_batch
        sums: dict = {}
        for _ in range(M):
            batch = self.buffer.sample(buf_state, gen, B, n_opts=agent_state.n_opts)
            agent_state, metrics, td_err = self.agent.update(
                agent_state, _slice_batch(batch, lo, lo + self.local_batch),
                self._update_gen)
            add_metrics(sums, metrics)
            if td_err is not None and self.buffer.per is not None:
                buf_state = self.buffer.update_priority(
                    buf_state, batch.ix_sample,
                    collectives.gather_rows(td_err.detach(), self.actors_group))
        return agent_state, buf_state, mean_metrics(
            {k: v / M for k, v in sums.items()}, self.actors_group)
