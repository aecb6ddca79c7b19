"""Implicit Q-Learning, offline (≙ border_tpu/agents/iql.py).

- expectile value function: asymmetric L2 on ``minQ_tgt(s, a) − V(s)``,
- critic target ``r + γ(1−terminated)·V(s')`` from the value net just
  updated,
- AWR actor with ``w = min(exp(adv/λ), exp_adv_max)``.

The update draws nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from border_tpu_torch.agents.awac import GaussianActorAgent
from border_tpu_torch.agents.common import (
    bootstrap_discount,
    critic_input,
    make_optimizer,
    minimize,
    new_critics,
    param_generator,
    polyak_update,
    weighted_mean,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.models.mlp import MLP, EnsembleMLP, GaussianHeadMLP
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils.counters import advance, new_counts
from border_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class IQLConfig:
    gamma: float = 0.99
    tau: float = 0.005
    n_critics: int = 2
    expectile: float = 0.7
    lambda_: float = 0.3333  # inverse of AWR β
    exp_adv_max: float = 100.0
    action_limit: str = "clamp"
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    value_lr: float = 3e-4
    optimizer: str = "adam"
    actor_hidden: Sequence[int] = (256, 256)
    critic_hidden: Sequence[int] = (256, 256)
    value_hidden: Sequence[int] = (256, 256)


@dataclasses.dataclass
class IQLState:
    actor_params: GaussianHeadMLP
    critic_params: EnsembleMLP
    critic_target_params: EnsembleMLP
    value_params: MLP
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    value_opt: torch.optim.Optimizer
    n_opts: int
    n_samples: int
    counts: Optional[torch.Tensor] = None  # on a CUDA device

    COUNTERS = ("n_opts", "n_samples")


class IQL(GaussianActorAgent):
    name = "iql"

    def __init__(self, config: IQLConfig = IQLConfig()):
        self.config = config
        self.make_actor_opt = make_optimizer(config.optimizer, config.actor_lr)
        self.make_critic_opt = make_optimizer(config.optimizer, config.critic_lr)
        self.make_value_opt = make_optimizer(config.optimizer, config.value_lr)

    def init(self, seed_or_gen, obs_space: spaces.Box, act_space: spaces.Box,
             device=None) -> IQLState:
        """Parameters are drawn on the CPU from ``seed_or_gen``, then moved
        to ``device`` (``None`` = the GPU)."""
        c = self.config
        device = resolve_device(device)
        gen = param_generator(seed_or_gen)
        self._bounds(act_space)
        actor = self._actor(gen, obs_space.flat_dim, c.actor_hidden, device)
        critic, target = new_critics(gen, c.n_critics,
                                     obs_space.flat_dim + self.act_dim,
                                     c.critic_hidden, device)
        value = MLP(obs_space.flat_dim, 1, tuple(c.value_hidden))
        value.reset_parameters(gen)
        value = value.to(device)
        return IQLState(
            actor_params=actor, critic_params=critic,
            critic_target_params=target, value_params=value,
            actor_opt=self.make_actor_opt(actor.parameters()),
            critic_opt=self.make_critic_opt(critic.parameters()),
            value_opt=self.make_value_opt(value.parameters()),
            n_opts=0, n_samples=0,
            counts=new_counts(device, (0, 0)),
        )

    def update(
        self, state: IQLState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[IQLState, Dict[str, Any], torch.Tensor]:
        c = self.config
        obs, act, next_obs, reward, _term, _trunc, _ix, weight = batch.unpack()
        act2d = act.reshape(act.shape[0], -1)
        reward = reward.float()
        critic, value = state.critic_params, state.value_params

        # expectile value step
        with torch.no_grad():
            q_tgt = state.critic_target_params(
                critic_input(obs, act2d))[..., 0].min(0).values
        v = value(obs)[:, 0]
        u = q_tgt - v
        w_exp = torch.where(u < 0.0, 1.0 - c.expectile, c.expectile)
        v_loss = (w_exp * u**2).mean()
        minimize(state.value_opt, v_loss, group=self.axis_group)
        v = v.detach()

        # critic toward r + γ(1−d)·V(s') of the value net just updated
        with torch.no_grad():
            target = reward + bootstrap_discount(c.gamma, batch) * value(next_obs)[:, 0]
        q = critic(critic_input(obs, act2d))[..., 0]
        c_loss = weighted_mean(weight, (q - target[None, :]) ** 2)
        minimize(state.critic_opt, c_loss, group=self.axis_group)

        # AWR actor
        adv = q_tgt - v
        w = torch.exp(adv / c.lambda_).clamp_max(c.exp_adv_max)
        a_loss = self._actor_step(state, obs, act2d, w)

        polyak_update(c.tau, critic, state.critic_target_params)
        advance(state, "n_opts", 1)
        with torch.no_grad():
            q_now = critic(critic_input(obs, act2d))[..., 0].min(0).values
        metrics = {
            "loss_value": v_loss.detach(),
            "loss_critic": c_loss.detach(),
            "loss_actor": a_loss,
            "adv_mean": adv.mean(),
            "v_mean": v.mean(),
        }
        return state, metrics, q_now - target
