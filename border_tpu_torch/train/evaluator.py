"""Policy evaluation (≙ border_tpu/train/evaluator.py).

≙ border-core DefaultEvaluator (evaluator/default_evaluator.rs:40-116):
n episodes with deterministic seeded resets (``reset_with_index``), mean
return as the model-selection score.

All n episodes run at once as one batched rollout: rewards accumulate only
until each instance's first episode boundary, so the result equals n
sequential episodes.  The rollout exits once every instance has finished,
and any instance still running at ``max_steps`` is counted in the
``Episodes truncated`` record.

The JAX rollout is a ``lax.while_loop`` that tests ``any(running)`` on the
device every step.  Here that test is a device→host sync, so it is made
every ``_CHECK_EVERY`` = 8 steps: at most 7 steps run after the last episode
ends, and they change nothing, because ``running`` masks every sum.  Eight
keeps the syncs to an eighth of the steps while the extra steps stay a few
percent of an episode of hundreds of steps.

One env step (act, step, the masked sums) is the body of a loop
(:mod:`border_tpu_torch.train.graphs`) run in those blocks of 8, or fewer
where ``max_steps`` ends the rollout: on a CUDA device as replays of its
captured CUDA graph, with ``cuda_graphs=False`` eagerly.  The rollout
writes fixed tensors that every evaluation reuses: the env state (each
evaluation's reset copied in), the sums, and the action and reset
generators, re-seeded in place.  The loop is made (and its graph captured)
again only when the agent, its state or its policy module is another
object than the last evaluation's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, VecEnv, index_seed
from border_tpu_torch.record.record import Record
from border_tpu_torch.train.graphs import (
    LoopGraph,
    bound_loop,
    copy_into,
    resolve_cuda_graphs,
)
from border_tpu_torch.utils.device import DeviceLike

_CHECK_EVERY = 8


class Evaluator:
    def __init__(
        self,
        env: Environment,
        n_episodes: int = 5,
        max_steps: int = 1_000,
        base_seed: int = 424242,
        device: DeviceLike = None,
        cuda_graphs: Optional[bool] = None,
    ):
        """``cuda_graphs``: replay a captured env step (None: on a CUDA
        device; False: eagerly; True on the CPU raises ``ConfigError``)."""
        self.vec = VecEnv(env, n_episodes, device=device)
        self.n_episodes = n_episodes
        self.max_steps = max_steps
        self.base_seed = base_seed
        self.cuda_graphs = resolve_cuda_graphs(cuda_graphs, self.vec.device,
                                               owner="Evaluator")
        dev = self.vec.device
        # the action and env generators, re-seeded in place every
        # evaluation (a graph holds them)
        self._act_gen = torch.Generator(device=dev)
        self._env_gen = torch.Generator(device=dev)
        self._returns = torch.zeros((n_episodes,), dtype=torch.float32, device=dev)
        self._lengths = torch.zeros((n_episodes,), dtype=torch.int32, device=dev)
        self._running = torch.ones((n_episodes,), dtype=torch.bool, device=dev)
        self._vec_state = None  # the loop's env state
        self._graphs: Dict[str, LoopGraph] = {}

    def _step(self, agent: Agent, agent_state, vec_state):
        """One step of every instance: act, step, and the sums masked by
        ``running``, in place.  Returns the next env state."""
        action = agent.select_action_eval(agent_state, vec_state.obs, self._act_gen)
        ts, vec_state = self.vec.step(vec_state, action)
        self._returns.add_(ts.reward * self._running)
        self._lengths.add_(self._running)
        self._running.logical_and_(~ts.done)
        return vec_state

    @torch.no_grad()
    def _rollout(self, agent: Agent, agent_state, eval_index: int):
        """(returns [n], lengths [n], count of instances still running)."""
        vec_state = self.vec.reset_with_index(self.base_seed, eval_index,
                                              gen=self._env_gen)
        if self._vec_state is None:
            self._vec_state = vec_state
        else:
            copy_into(self._vec_state, vec_state)
        fixed = self._vec_state

        def step(loop):
            copy_into(fixed, self._step(agent, agent_state, fixed))

        loop = bound_loop(self._graphs, "evaluation step",
                          (agent, agent_state, agent.policy_params(agent_state)),
                          step, [self._act_gen, fixed.gen], self.cuda_graphs)
        self._act_gen.manual_seed(index_seed(self.base_seed, eval_index + 1))
        self._returns.zero_()
        self._lengths.zero_()
        self._running.fill_(True)
        done = 0
        while done < self.max_steps:
            n = min(_CHECK_EVERY, self.max_steps - done)
            loop.run(n)
            done += n
            if done < self.max_steps and not bool(self._running.any()):
                break
        # instances still running after max_steps were horizon-truncated;
        # copies: the next evaluation writes the sums again
        return (self._returns.clone(), self._lengths.clone(),
                self._running.sum())

    def evaluate(self, agent: Agent, agent_state,
                 eval_index: int = 0) -> Tuple[float, Record]:
        """Returns (model-selection score, record) ≙ Evaluator::evaluate
        (border-core/src/evaluator.rs:46-83)."""
        returns, lengths, n_trunc = self._rollout(agent, agent_state, eval_index)
        score, r_min, r_max, length, trunc = torch.stack([
            returns.mean(), returns.min(), returns.max(),
            lengths.float().mean(), n_trunc.float(),
        ]).tolist()
        record = Record(
            {
                "Episode return": score,
                "Episode return min": r_min,
                "Episode return max": r_max,
                "Episode length": length,
                "Episodes truncated": trunc,
            }
        )
        return score, record
