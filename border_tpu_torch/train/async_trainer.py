"""Decoupled actor-learner with periodic model sync
(≙ border_tpu/train/async_trainer.py).

The actor phase samples a chunk of env steps with *stale* policy
parameters, refreshed from the learner every ``sync_interval`` optimizer
steps; the learner phase runs the chunk's updates.  The update:sample ratio
is the Trainer's; what changes is which parameters act.

The JAX package's stale parameters are an immutable pytree.  Here the
learner's policy is a live ``nn.Module`` that every update changes in
place, so the actor holds its own copy (parameters and buffers) and a sync
copies the learner's tensors into it, in stream order on the device.  The
actor phase acts on a state that shares every field with the learner's but
the policy (``Agent.sync_policy``); the env-step counters it advances (the
ε schedule's ``n_samples``) are carried back onto the learner's state.

On a CUDA device both phases replay captured CUDA graphs, as the Trainer's
chunk does: the actor's env steps and the learner's updates.  A graph holds
the objects it was captured with, so the actor's state and its copy of the
policy persist across chunks: the state is refreshed in place from the
learner's (``sync_policy(..., into=)``), a sync and a checkpoint restore
load the learner's tensors into the same copy, and the learner's state
takes the actor's counters in place.

A :meth:`Trainer._dispatch` override: every cadence (evaluation and
best-model, saves, full-state checkpoints and bit-exact ``resume_from``,
compute-cost and param-stat records) is the Trainer's.  The actor's
parameters and the step of the last sync go into the checkpoint, so a
resumed run acts on the same stale parameters as the uninterrupted one.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from border_tpu_torch.train.trainer import Trainer


def _snapshot(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s parameters and buffers that no update reaches."""
    snap = copy.deepcopy(module)
    snap.requires_grad_(False)
    return snap


class AsyncTrainer(Trainer):
    """Alternates actor chunks (stale parameters) and learner chunks."""

    _actor_params: Optional[nn.Module] = None
    _actor_state = None  # the actor's persistent state (sync_policy)
    _actor_for = None  # the learner's state it was made from
    _last_sync: int = 0

    def _sync(self, policy: nn.Module, n_opts: int) -> None:
        if self._actor_params is None:
            self._actor_params = _snapshot(policy)
        else:
            self._actor_params.load_state_dict(policy.state_dict())
        self._last_sync = n_opts

    def _actor(self, agent_state):
        """The actor's state: the learner's fields but the policy, which is
        the stale copy; the same object from chunk to chunk while the
        learner's state and the copy are."""
        actor = self._actor_state
        if (actor is None or self._actor_for is not agent_state
                or self.agent.policy_params(actor) is not self._actor_params):
            actor = self._actor_state = self.agent.sync_policy(
                agent_state, self._actor_params)
            self._actor_for = agent_state
        return self.agent.sync_policy(agent_state, self._actor_params, into=actor)

    def _dispatch(self, agent_state, vec_state, buffer_state,
                  gen: torch.Generator, warmed: bool):
        policy = self.agent.policy_params(agent_state)
        # the initial model sync; also the first after a resume that
        # restored no actor parameters
        if self._actor_params is None:
            self._sync(policy, agent_state.n_opts)

        # actor phase: stale policy, no updates
        actor_state, vec_state, buffer_state, _, ep_ret, ep_cnt = self._chunk(
            self._actor(agent_state), vec_state, buffer_state, gen, False, True)
        # the learner's own policy, with the advanced env counters
        learner_state = self.agent.sync_policy(actor_state, policy, into=agent_state)

        metrics = {}
        if warmed:
            learner_state, vec_state, buffer_state, metrics, _, _ = self._chunk(
                learner_state, vec_state, buffer_state, gen, True, False)
            if learner_state.n_opts - self._last_sync >= self.config.sync_interval:
                self._sync(policy, learner_state.n_opts)
        return learner_state, vec_state, buffer_state, metrics, ep_ret, ep_cnt

    def _checkpoint_extra(self, agent_state) -> dict:
        params = (self._actor_params if self._actor_params is not None
                  else self.agent.policy_params(agent_state))
        return {"actor_params": params, "last_sync": self._last_sync}

    def _restore_checkpoint_extra(self, ex: dict, agent_state) -> None:
        """Into the existing copy, in place, where there is one: a graph
        of an earlier chunk never holds a copy that is no longer the
        actor's."""
        if self._actor_params is None:
            self._actor_params = _snapshot(self.agent.policy_params(agent_state))
        self._actor_params.load_state_dict(ex["actor_params"])
        self._last_sync = int(ex["last_sync"])
