"""Agent contract (≙ border_tpu/core/agent.py).

An agent is a strategy object over an agent state (networks, optimizer,
counters).  The JAX package's states are immutable pytrees; here the state
holds ``nn.Module``s and a ``torch.optim`` optimizer, and ``update`` steps
them in place and returns the same state object, so call sites read as in
the JAX package: ``state, metrics, td = agent.update(state, batch)``.

``update`` returns ``(state, metrics, td_errors)``; ``td_errors`` (or None)
feeds prioritized-replay priority updates.

``save``/``load`` keep the JAX package's on-disk form: one flat ``.npz`` of
numpy arrays, readable without torch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.utils.checkpoint import pack_state, unpack_state

AgentState = Any


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Nested dicts of tensors and scalars → ``{"a/b/c": array}``.  bf16 has
    no numpy type and is stored as float32."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif torch.is_tensor(tree):
        t = tree.detach().cpu()
        out[prefix] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    elif tree is not None:
        out[prefix] = np.asarray(tree)


def _unflatten(arrays) -> Dict[Any, Any]:
    """The inverse of :func:`_flatten`; all-digit path parts (an
    optimizer's parameter numbers) become ints again."""
    tree: Dict[Any, Any] = {}
    for name in arrays.files:
        *parents, leaf = [int(k) if k.isdigit() else k for k in name.split("/")]
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(arrays[name])
    return tree


class Agent:
    name: str = "Agent"
    # ≙ the JAX agents' ``axis_name``: the process group over which
    # ``update`` averages its gradients, between the backward pass and the
    # optimizer step (set by the port's ShardedTrainer and GSPMDTrainer);
    # None: no reduction
    axis_group = None

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

    # -- model sync (≙ SyncModel, border-async-trainer/src/sync_model.rs) --
    def model_info(self, state: AgentState) -> Tuple[int, Any]:
        """(opt-step counter, inference-relevant params) for actor sync."""
        return state.n_opts, self.policy_params(state)

    # the state's field that holds the policy's module
    policy_field = "params"

    def policy_params(self, state: AgentState) -> Any:
        """The parameters action selection needs."""
        return getattr(state, self.policy_field)

    def sync_policy(self, state: AgentState, policy_params: Any,
                    into: Optional[AgentState] = None) -> AgentState:
        """A state that acts with ``policy_params`` (a module of the same
        structure as ``policy_params(state)``) and shares every other field
        with ``state``; its host-int counters are its own.  Neither the
        given module nor ``state`` is changed.  A new state object, or
        ``into`` with its fields set so: a state that persists (the async
        actor's, which CUDA graphs hold) refreshed from ``state``."""
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        fields[self.policy_field] = policy_params
        if into is None:
            return type(state)(**fields)
        for name, v in fields.items():
            setattr(into, name, v)
        return into

    # -- checkpointing (≙ Agent::save_params/load_params) ------------------
    def save(self, state: AgentState, path: str) -> None:
        """Save the whole agent state (networks, optimizer moments,
        counters) as ``<path>/<name>.npz``."""
        flat: Dict[str, np.ndarray] = {}
        _flatten(pack_state(state), "", flat)
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"{self.name}.npz"), **flat)

    def load(self, state: AgentState, path: str) -> AgentState:
        """Load into an existing (template) state, casting each array back
        to the template's dtype; returns the state."""
        with np.load(os.path.join(path, f"{self.name}.npz")) as arrays:
            return unpack_state(state, _unflatten(arrays))
