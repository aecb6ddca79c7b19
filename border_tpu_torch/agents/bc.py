"""Behavior cloning (≙ border_tpu/agents/bc.py).

The continuous mode regresses the dataset's actions with MSE; the discrete
mode trains logits with the cross-entropy of a log-softmax and acts by
argmax.  ``lr`` may be a schedule of the update count, e.g.
``cosine_decay_schedule(1e-3, max_opts)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from border_tpu_torch.agents.common import (
    LearningRate,
    make_optimizer,
    minimize,
    param_generator,
)
from border_tpu_torch.core import spaces
from border_tpu_torch.core.agent import Agent
from border_tpu_torch.models.mlp import MLP
from border_tpu_torch.replay.buffer import TransitionBatch
from border_tpu_torch.utils.counters import advance, count, new_counts
from border_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BCConfig:
    action_mode: str = "continuous"  # "continuous" | "discrete"
    optimizer: str = "adam"
    lr: LearningRate = 3e-4
    hidden: Sequence[int] = (256, 256)


@dataclasses.dataclass
class BCState:
    params: MLP
    opt_state: torch.optim.Optimizer
    n_opts: int
    n_samples: int
    counts: Optional[torch.Tensor] = None  # on a CUDA device

    COUNTERS = ("n_opts", "n_samples")


class BC(Agent):
    name = "bc"

    def __init__(self, config: BCConfig = BCConfig()):
        self.config = config
        self.make_opt = make_optimizer(config.optimizer, config.lr)

    def init(self, seed_or_gen, obs_space: spaces.Space,
             act_space: spaces.Space, device=None) -> BCState:
        """Parameters are drawn on the CPU from ``seed_or_gen``, then moved
        to ``device`` (``None`` = the GPU)."""
        c = self.config
        device = resolve_device(device)
        if c.action_mode == "discrete":
            out_dim = act_space.n
        else:
            out_dim = int(act_space.flat_dim)
            self.act_shape = tuple(act_space.shape)
        net = MLP(obs_space.flat_dim, out_dim, tuple(c.hidden))
        net.reset_parameters(param_generator(seed_or_gen))
        net = net.to(device)
        return BCState(params=net, opt_state=self.make_opt(net.parameters()),
                       n_opts=0, n_samples=0,
                       counts=new_counts(device, (0, 0)))

    @torch.no_grad()
    def select_action(self, state: BCState, obs: torch.Tensor,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        out = state.params(obs)
        if self.config.action_mode == "discrete":
            return out.argmax(-1).to(torch.int32)
        return out.reshape((obs.shape[0],) + self.act_shape)

    def on_env_step(self, state: BCState, n: int) -> BCState:
        advance(state, "n_samples", n)
        return state

    def update(
        self, state: BCState, batch: TransitionBatch,
        gen: Optional[torch.Generator] = None,
    ) -> Tuple[BCState, Dict[str, Any], None]:
        obs, act = batch.obs, batch.act
        out = state.params(obs)
        if self.config.action_mode == "discrete":
            logp = F.log_softmax(out, dim=-1)
            loss = -logp.gather(1, act.long()[:, None]).mean()
        else:
            loss = ((out - act.reshape(act.shape[0], -1)) ** 2).mean()
        minimize(state.opt_state, loss, self.config.lr, count(state, "n_opts"),
                 group=self.axis_group)
        advance(state, "n_opts", 1)
        return state, {"loss": loss.detach()}, None

