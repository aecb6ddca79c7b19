"""Soft Actor-Critic (≙ border_tpu/agents/sac.py).

- squashed Gaussian policy ``a = tanh(μ + σ·z)·scale + bias`` with the
  tanh log-prob Jacobian in its stable form,
- an n-critic min-Q ensemble held as one :class:`EnsembleMLP` (stacked
  parameters, one batched matmul a layer: the JAX agent's ``vmap``),
- critic target ``r·scale + γ(1−terminated)(minQ' − α·logπ')``,
- actor loss ``α·logπ − minQ`` against the critics just updated,
- the entropy coefficient fixed or tuned on ``log α`` by its own Adam,
- per-update τ-polyak of the target critics.

The state holds the modules, ``log_alpha`` (a 0-dim tensor) and three
``torch.optim`` optimizers; ``update`` steps them in place.  Its two normal
draws (the next action's, the actor's) come from the generator or are
injected as ``noise``.  At tracing level ``detail`` the update is split
into the spans ``update.critic`` (the target, the critics' forward,
backward and step), ``update.actor``, ``update.alpha``, ``update.target``
(the Polyak update) and ``update.priority`` (the TD error's forward)
(:func:`border_tpu_torch.utils.profiling.detail`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from border_tpu_torch.agents.common import (
    CRITIC_LOSSES,
    bootstrap_discount,
    critic_input,
    make_optimizer,
    minimize,
    new_critics,
    param_generator,
    polyak_update,
    weighted_mean,
)
from border_tpu_torch.agents.gaussian import HALF_LOG_2PI, standard_normal, tanh_log_det
from border_tpu_torch.core import spaces
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.models.mlp import EnsembleMLP, GaussianHeadMLP
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils import profiling
from border_tpu_torch.utils.counters import advance, new_counts
from border_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """≙ SacConfig (border-tch-agent/src/sac/config.rs:23-207)."""

    gamma: float = 0.99
    tau: float = 0.005
    n_critics: int = 2
    reward_scale: float = 1.0
    critic_loss: str = "mse"
    # entropy coefficient (≙ EntCoef, sac/ent_coef.rs:9-94)
    ent_coef_mode: str = "auto"  # "auto" | "fix"
    ent_coef_init: float = 1.0
    target_entropy: Optional[float] = None  # default: -act_dim
    ent_lr: float = 3e-4
    # optimizers
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    optimizer: str = "adam"
    # models
    actor_hidden: Sequence[int] = (64, 64)
    critic_hidden: Sequence[int] = (64, 64)


@dataclasses.dataclass
class SACState:
    actor_params: GaussianHeadMLP
    critic_params: EnsembleMLP
    critic_target_params: EnsembleMLP
    log_alpha: torch.Tensor  # 0-dim, requires grad
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    alpha_opt: torch.optim.Optimizer
    n_opts: int
    n_samples: int
    counts: Optional[torch.Tensor] = None  # on a CUDA device

    COUNTERS = ("n_opts", "n_samples")


class SAC(Agent):
    name = "sac"
    policy_field = "actor_params"

    def __init__(self, config: SACConfig = SACConfig()):
        self.config = config
        self.make_actor_opt = make_optimizer(config.optimizer, config.actor_lr)
        self.make_critic_opt = make_optimizer(config.optimizer, config.critic_lr)
        self.make_alpha_opt = make_optimizer("adam", config.ent_lr)

    # -- construction ------------------------------------------------------
    def init(self, seed_or_gen, obs_space: spaces.Box, act_space: spaces.Box,
             device=None) -> SACState:
        """Parameters are drawn on the CPU from ``seed_or_gen``, then moved
        to ``device`` (``None`` = the GPU), as in ``DQN.init``."""
        c = self.config
        device = resolve_device(device)
        gen = param_generator(seed_or_gen)
        self.act_dim = int(act_space.flat_dim)
        # tanh(u)·scale + bias spans the env's bounds
        low = torch.as_tensor(act_space.low, dtype=torch.float32).expand(act_space.shape)
        high = torch.as_tensor(act_space.high, dtype=torch.float32).expand(act_space.shape)
        self.act_scale = ((high - low) / 2.0).to(device)
        self.act_bias = ((high + low) / 2.0).to(device)
        self.target_entropy = (c.target_entropy if c.target_entropy is not None
                               else -float(self.act_dim))
        actor = GaussianHeadMLP(obs_space.flat_dim, self.act_dim,
                                tuple(c.actor_hidden))
        actor.reset_parameters(gen)
        actor = actor.to(device)
        critic, target = new_critics(gen, c.n_critics,
                                     obs_space.flat_dim + self.act_dim,
                                     c.critic_hidden, device)
        log_alpha = torch.tensor(c.ent_coef_init, device=device).log()
        log_alpha.requires_grad_(True)
        return SACState(
            actor_params=actor,
            critic_params=critic,
            critic_target_params=target,
            log_alpha=log_alpha,
            actor_opt=self.make_actor_opt(actor.parameters()),
            critic_opt=self.make_critic_opt(critic.parameters()),
            alpha_opt=self.make_alpha_opt([log_alpha]),
            n_opts=0,
            n_samples=0,
            counts=new_counts(device, (0, 0)),
        )

    # -- policy ------------------------------------------------------------
    def _sample_action(self, actor: nn.Module, obs: torch.Tensor,
                       gen: Optional[torch.Generator],
                       z: Optional[torch.Tensor] = None):
        """Squashed-Gaussian sample and its log-prob: log N(u; μ, σ) from
        the draw z, minus Σ log(1 − tanh²(u))."""
        mean, log_std = actor(obs)
        if z is None:
            z = standard_normal(gen, mean)
        u = mean + torch.exp(log_std) * z
        log_prob = (-0.5 * z**2 - log_std - HALF_LOG_2PI).sum(-1) - tanh_log_det(u)
        return torch.tanh(u) * self.act_scale + self.act_bias, log_prob

    @torch.no_grad()
    def select_action(self, state: SACState, obs: torch.Tensor,
                      gen: torch.Generator) -> torch.Tensor:
        return self._sample_action(state.actor_params, obs, gen)[0]

    @torch.no_grad()
    def select_action_eval(self, state: SACState, obs: torch.Tensor,
                           gen: Optional[torch.Generator] = None) -> torch.Tensor:
        mean, _ = state.actor_params(obs)
        return torch.tanh(mean) * self.act_scale + self.act_bias

    def on_env_step(self, state: SACState, n: int) -> SACState:
        advance(state, "n_samples", n)
        return state

    # -- learning ----------------------------------------------------------
    def update(
        self, state: SACState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[SACState, Dict[str, Any], torch.Tensor]:
        """``noise``: the standard-normal draws ``(next action, actor
        action)``, each ``[B, act_dim]``, in place of ``gen``'s."""
        c = self.config
        obs, act, next_obs, reward, _term, _trunc, _ix, weight = batch.unpack()
        cuda = reward.is_cuda
        z_next, z_actor = noise if noise is not None else (None, None)
        actor, critic = state.actor_params, state.critic_params

        with profiling.detail("update.critic", cuda):
            reward = reward.float() * c.reward_scale
            alpha = state.log_alpha.detach().exp()
            # critic target
            with torch.no_grad():
                next_act, next_logp = self._sample_action(actor, next_obs, gen, z_next)
                q_next = state.critic_target_params(critic_input(next_obs, next_act))[..., 0]
                target = reward + bootstrap_discount(c.gamma, batch) * (
                    q_next.min(0).values - alpha * next_logp)

            q = critic(critic_input(obs, act))[..., 0]  # [n, B]
            c_loss = weighted_mean(weight, CRITIC_LOSSES[c.critic_loss](q, target[None, :]))
            minimize(state.critic_opt, c_loss, group=self.axis_group)

        with profiling.detail("update.actor", cuda):
            # actor loss α·logπ − minQ, through the critics just updated
            a, logp = self._sample_action(actor, obs, gen, z_actor)
            min_q = critic(critic_input(obs, a))[..., 0].min(0).values
            a_loss = (alpha * logp - min_q).mean()
            minimize(state.actor_opt, a_loss, inputs=list(actor.parameters()),
                     group=self.axis_group)
            logp = logp.detach()

        with profiling.detail("update.alpha", cuda):
            if c.ent_coef_mode == "auto":
                al_loss = -(state.log_alpha * (logp + self.target_entropy)).mean()
                minimize(state.alpha_opt, al_loss, group=self.axis_group)
                al_loss = al_loss.detach()
            else:
                al_loss = torch.zeros((), device=reward.device)

        with profiling.detail("update.target", cuda):
            polyak_update(c.tau, critic, state.critic_target_params)
            advance(state, "n_opts", 1)
        # TD error for PER: the ensemble's mean Q after the update − target
        with profiling.detail("update.priority", cuda), torch.no_grad():
            td_err = critic(critic_input(obs, act))[..., 0].mean(0) - target
        metrics = {
            "loss_critic": c_loss.detach(),
            "loss_actor": a_loss.detach(),
            "loss_alpha": al_loss,
            "ent_coef": state.log_alpha.detach().exp(),
            "entropy": -logp.mean(),
            "q_mean": q.detach().mean(),
        }
        return state, metrics, td_err

