"""Advantage-Weighted Actor-Critic, offline or off-policy
(≙ border_tpu/agents/awac.py).

- critic: TD to ``r + γ(1−terminated)·minQ'(s', a'~π)`` over the ensemble,
- actor: ``−logπ(a|s)·w`` on the dataset's actions, with the advantage
  ``minQ(s, a) − minQ(s, a~π)`` from the critics just updated and
  ``w = min(exp(adv/λ), exp_adv_max)`` or ``B·softmax(adv/λ)`` over the
  batch.

The update's two normal draws (the next action's, the policy action's)
come from the generator or are injected as ``noise``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from border_tpu_torch.agents import gaussian
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
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.models.mlp import EnsembleMLP, GaussianHeadMLP
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils.counters import advance, new_counts
from border_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AWACConfig:
    gamma: float = 0.99
    tau: float = 0.005
    n_critics: int = 2
    lambda_: float = 1.0  # advantage temperature
    exp_adv_max: float = 100.0
    weight_mode: str = "exp"  # "exp" | "softmax"
    action_limit: str = "clamp"
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    optimizer: str = "adam"
    actor_hidden: Sequence[int] = (256, 256)
    critic_hidden: Sequence[int] = (256, 256)


@dataclasses.dataclass
class AWACState:
    actor_params: GaussianHeadMLP
    critic_params: EnsembleMLP
    critic_target_params: EnsembleMLP
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    n_opts: int
    n_samples: int
    counts: Optional[torch.Tensor] = None  # on a CUDA device

    COUNTERS = ("n_opts", "n_samples")


class GaussianActorAgent(Agent):
    """What AWAC and IQL share: a Gaussian actor whose actions the action
    limit bounds (``clamp`` to the Box's bounds, or ``tanh``)."""

    policy_field = "actor_params"

    def _bounds(self, act_space: spaces.Box) -> None:
        self.act_dim = int(act_space.flat_dim)
        self.act_low = float(torch.as_tensor(act_space.low).min())
        self.act_high = float(torch.as_tensor(act_space.high).max())

    def _actor(self, gen, in_dim: int, hidden, device) -> GaussianHeadMLP:
        actor = GaussianHeadMLP(in_dim, self.act_dim, tuple(hidden))
        actor.reset_parameters(gen)
        return actor.to(device)

    def _sample(self, gen, mean, log_std, z=None) -> torch.Tensor:
        return gaussian.sample(gen, mean, log_std, self.config.action_limit,
                               self.act_low, self.act_high, z=z)[0]

    @torch.no_grad()
    def select_action(self, state, obs: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
        return self._sample(gen, *state.actor_params(obs))

    @torch.no_grad()
    def select_action_eval(self, state, obs: torch.Tensor,
                           gen: Optional[torch.Generator] = None) -> torch.Tensor:
        mean, _ = state.actor_params(obs)
        if self.config.action_limit == "tanh":
            return torch.tanh(mean)
        return mean.clamp(self.act_low, self.act_high)

    def on_env_step(self, state, n: int):
        advance(state, "n_samples", n)
        return state

    def _actor_step(self, state, obs, act2d, w) -> torch.Tensor:
        """The advantage-weighted step −mean(w·logπ(a|s)); its loss."""
        mean, log_std = state.actor_params(obs)
        logp = gaussian.logp_of(act2d, mean, log_std, self.config.action_limit)
        loss = -(w * logp).mean()
        minimize(state.actor_opt, loss, group=self.axis_group)
        return loss.detach()


class AWAC(GaussianActorAgent):
    name = "awac"

    def __init__(self, config: AWACConfig = AWACConfig()):
        self.config = config
        self.make_actor_opt = make_optimizer(config.optimizer, config.actor_lr)
        self.make_critic_opt = make_optimizer(config.optimizer, config.critic_lr)

    def init(self, seed_or_gen, obs_space: spaces.Box, act_space: spaces.Box,
             device=None) -> AWACState:
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
        return AWACState(
            actor_params=actor, critic_params=critic,
            critic_target_params=target,
            actor_opt=self.make_actor_opt(actor.parameters()),
            critic_opt=self.make_critic_opt(critic.parameters()),
            n_opts=0, n_samples=0,
            counts=new_counts(device, (0, 0)),
        )

    def update(
        self, state: AWACState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[AWACState, Dict[str, Any], torch.Tensor]:
        """``noise``: the standard-normal draws ``(next action, policy
        action)``, each ``[B, act_dim]``, in place of ``gen``'s."""
        c = self.config
        obs, act, next_obs, reward, _term, _trunc, _ix, weight = batch.unpack()
        act2d = act.reshape(act.shape[0], -1)
        reward = reward.float()
        z_next, z_pi = noise if noise is not None else (None, None)
        actor, critic = state.actor_params, state.critic_params

        with torch.no_grad():
            next_act = self._sample(gen, *actor(next_obs), z=z_next)
            q_next = state.critic_target_params(
                critic_input(next_obs, next_act))[..., 0].min(0).values
            target = reward + bootstrap_discount(c.gamma, batch) * q_next

        q = critic(critic_input(obs, act2d))[..., 0]
        c_loss = weighted_mean(weight, (q - target[None, :]) ** 2)
        minimize(state.critic_opt, c_loss, group=self.axis_group)

        # advantage weights from the critics just updated
        with torch.no_grad():
            a_pi = self._sample(gen, *actor(obs), z=z_pi)
            both = critic(torch.cat([critic_input(obs, a_pi),
                                     critic_input(obs, act2d)]))[..., 0]
            v, q_data = both.min(0).values.split(obs.shape[0])
            adv = q_data - v
            if c.weight_mode == "softmax":
                w = torch.softmax(adv / c.lambda_, dim=0) * adv.shape[0]
            else:
                w = torch.exp(adv / c.lambda_).clamp_max(c.exp_adv_max)

        a_loss = self._actor_step(state, obs, act2d, w)
        polyak_update(c.tau, critic, state.critic_target_params)
        advance(state, "n_opts", 1)
        metrics = {
            "loss_critic": c_loss.detach(),
            "loss_actor": a_loss,
            "adv_mean": adv.mean(),
            "w_mean": w.mean(),
        }
        return state, metrics, q_data - target
