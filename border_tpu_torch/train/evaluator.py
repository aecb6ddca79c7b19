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
"""

from __future__ import annotations

from typing import Tuple

import torch

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, VecEnv, index_seed
from border_tpu_torch.record.record import Record
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
    ):
        self.vec = VecEnv(env, n_episodes, device=device)
        self.n_episodes = n_episodes
        self.max_steps = max_steps
        self.base_seed = base_seed

    @torch.no_grad()
    def _rollout(self, agent: Agent, agent_state, eval_index: int):
        """(returns [n], lengths [n], count of instances still running)."""
        dev = self.vec.device
        vec_state = self.vec.reset_with_index(self.base_seed, eval_index)
        act_gen = torch.Generator(device=dev).manual_seed(
            index_seed(self.base_seed, eval_index + 1)
        )
        returns = torch.zeros((self.n_episodes,), dtype=torch.float32, device=dev)
        lengths = torch.zeros((self.n_episodes,), dtype=torch.int32, device=dev)
        running = torch.ones((self.n_episodes,), dtype=torch.bool, device=dev)
        for step in range(1, self.max_steps + 1):
            action = agent.select_action_eval(agent_state, vec_state.obs, act_gen)
            ts, vec_state = self.vec.step(vec_state, action)
            returns = returns + ts.reward * running
            lengths = lengths + running
            running = running & ~ts.done
            if step % _CHECK_EVERY == 0 and not bool(running.any()):
                break
        # instances still running after max_steps were horizon-truncated
        return returns, lengths, running.sum()

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
