"""Agent contract (≙ border_tpu/core/agent.py).

An agent is a strategy object over an agent state (networks, optimizer,
counters).  The JAX package's states are immutable pytrees; here the state
holds ``nn.Module``s and a ``torch.optim`` optimizer, and ``update`` steps
them in place and returns the same state object, so call sites read as in
the JAX package: ``state, metrics, td = agent.update(state, batch)``.

``update`` returns ``(state, metrics, td_errors)``; ``td_errors`` (or None)
feeds prioritized-replay priority updates.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

AgentState = Any


class Agent:
    name: str = "Agent"

    def on_env_step(self, state: AgentState, n: int) -> AgentState:
        """Advance env-step-driven schedules (ε decay etc.); default no-op."""
        return state

    def init(self, seed_or_gen, obs_space, act_space, device=None) -> AgentState:
        raise NotImplementedError

    def select_action(
        self, state: AgentState, obs: Any, gen: torch.Generator
    ) -> torch.Tensor:
        """Batched action selection with exploration (train mode)."""
        raise NotImplementedError

    def select_action_eval(
        self, state: AgentState, obs: Any, gen: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Batched greedy action selection (eval mode)."""
        return self.select_action(state, obs, gen)

    def update(
        self, state: AgentState, batch: Any, gen: Optional[torch.Generator] = None
    ) -> Tuple[AgentState, Dict[str, torch.Tensor], Optional[torch.Tensor]]:
        """One optimization step; returns (state, metrics, td_errors|None)."""
        raise NotImplementedError

    def policy_params(self, state: AgentState) -> Any:
        """The parameters action selection needs."""
        raise NotImplementedError
