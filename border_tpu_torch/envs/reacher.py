"""Goal-conditioned planar reacher with dict observations, batched
(≙ border_tpu/envs/reacher.py).

A 2-DoF arm on a plane, torque-controlled, dense negative-distance reward,
a +1 bonus within 0.05 of the goal, 50-step episodes.  The state is
``[N, 2]`` joint angles, velocities and goals; every step is trig and
arithmetic over the batch.

Obs: ``{"observation": [N, 4] (angles, velocities), "achieved_goal": [N, 2],
"desired_goal": [N, 2]}``; :class:`FlattenDictWrapper` concatenates the
entries for MLP agents, in the ``Dict`` space's sorted key order unless
given its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from border_tpu_torch.core import spaces
from border_tpu_torch.core.env import Environment, first_leaf, scale_uniform

L1 = 0.5
L2 = 0.4


@dataclasses.dataclass
class ReacherState:
    q: torch.Tensor  # [N, 2] joint angles
    qd: torch.Tensor  # [N, 2] joint velocities
    goal: torch.Tensor  # [N, 2] target xy
    t: torch.Tensor  # [N] int32


@dataclasses.dataclass(frozen=True)
class ReacherParams:
    dt: float = 0.05
    torque_scale: float = 1.0
    damping: float = 0.9
    success_radius: float = 0.05
    max_steps: int = 50


def _fk(q: torch.Tensor) -> torch.Tensor:
    """End-effector xy ``[N, 2]`` from joint angles ``[N, 2]``."""
    q0, q01 = q[:, 0], q[:, 0] + q[:, 1]
    x = L1 * torch.cos(q0) + L2 * torch.cos(q01)
    y = L1 * torch.sin(q0) + L2 * torch.sin(q01)
    return torch.stack([x, y], dim=1)


class Reacher(Environment):
    name = "Reacher-v0"

    @property
    def default_params(self) -> ReacherParams:
        return ReacherParams()

    def observation_space(self, params) -> spaces.Dict:
        return spaces.Dict({
            "observation": spaces.Box(-10.0, 10.0, (4,), torch.float32),
            "achieved_goal": spaces.Box(-1.0, 1.0, (2,), torch.float32),
            "desired_goal": spaces.Box(-1.0, 1.0, (2,), torch.float32),
        })

    def action_space(self, params) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (2,), torch.float32)

    def _obs(self, state: ReacherState):
        return {
            "observation": torch.cat([state.q, state.qd], dim=1),
            "achieved_goal": _fk(state.q),
            "desired_goal": state.goal,
        }

    def reset_env(self, gen, n, params, device,
                  u: Optional[torch.Tensor] = None):
        """``u`` [N, 4] injects the U[0,1) draws: the two angles, the goal's
        radius and its bearing."""
        if u is None:
            u = torch.rand((n, 4), generator=gen, device=device)
        q = scale_uniform(u[:, :2], -math.pi, math.pi)
        # the goal uniformly in the reachable annulus
        r = scale_uniform(u[:, 2], abs(L1 - L2) + 0.05, L1 + L2 - 0.05)
        th = scale_uniform(u[:, 3], -math.pi, math.pi)
        state = ReacherState(
            q=q, qd=torch.zeros_like(q),
            goal=torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=1),
            t=torch.zeros((n,), dtype=torch.int32, device=device),
        )
        return self._obs(state), state

    def step_env(self, gen, state, action, params):
        torque = action.reshape(-1, 2).clamp(-1.0, 1.0) * params.torque_scale
        qd = params.damping * state.qd + torque * params.dt * 10.0
        qd = qd.clamp(-8.0, 8.0)
        q = state.q + qd * params.dt
        # floor-mod as jnp's %: torch's % (remainder) takes the divisor's sign
        q = ((q + math.pi) % (2 * math.pi)) - math.pi
        t = state.t + 1
        new = ReacherState(q=q, qd=qd, goal=state.goal, t=t)
        dist = torch.linalg.vector_norm(_fk(q) - state.goal, dim=1)
        reward = -dist + (dist < params.success_radius).float()
        truncated = t >= params.max_steps
        return (self._obs(new), new, reward, torch.zeros_like(truncated),
                truncated, {})


class FlattenDictWrapper(Environment):
    """Dict obs → one flat ``[N, dim]`` float32 observation, the entries of
    ``keys`` (default: the Dict space's sorted keys) concatenated."""

    def __init__(self, env: Environment, keys=None):
        self.env = env
        self.keys = keys
        self.name = env.name + "-flat"

    @property
    def default_params(self):
        return self.env.default_params

    def _keys(self, params):
        if self.keys is not None:
            return list(self.keys)
        return [k for k, _ in self.env.observation_space(params).spaces]

    def observation_space(self, params) -> spaces.Box:
        inner = self.env.observation_space(params).as_dict()
        dim = sum(inner[k].flat_dim for k in self._keys(params))
        return spaces.Box(-np.inf, np.inf, (dim,), torch.float32)

    def action_space(self, params):
        return self.env.action_space(params)

    def _flatten(self, obs, params) -> torch.Tensor:
        n = first_leaf(obs).shape[0]
        return torch.cat([obs[k].reshape(n, -1) for k in self._keys(params)],
                         dim=1).float()

    def reset_env(self, gen, n, params, device, **kw):
        obs, state = self.env.reset_env(gen, n, params, device, **kw)
        return self._flatten(obs, params), state

    def step_env(self, gen, state, action, params):
        obs, state, r, term, trunc, info = self.env.step_env(
            gen, state, action, params)
        return self._flatten(obs, params), state, r, term, trunc, info

    def post_done_state(self, gen, state, obs, params):
        new_obs, st = self.env.post_done_state(gen, state, obs, params)
        if isinstance(new_obs, dict):
            new_obs = self._flatten(new_obs, params)
        return new_obs, st
