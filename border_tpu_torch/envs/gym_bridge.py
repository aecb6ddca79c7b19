"""Host-side Gymnasium bridge for evaluation (≙ border_tpu/envs/gym_bridge.py).

Exposes Gymnasium envs through a VecEnv-shaped stepping API so trained
policies can be scored against the canonical implementations.  Host Python
per step, on the CPU, and only where ``gymnasium`` is installed (it is
imported when a bridge is built).  Observations come back as float32, with
seeded resets and the terminated/truncated split.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np


class GymVecBridge:
    """N host Gymnasium envs stepped in lockstep with auto-reset:
    ``reset(seed) -> obs [N, ...]``, ``step(actions) -> (obs, reward,
    terminated, truncated, final_obs)``."""

    def __init__(self, env_id: str, num_envs: int = 1, **kwargs):
        import gymnasium as gym

        self.envs: List[Any] = [gym.make(env_id, **kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.env_id = env_id

    def reset(self, seed: int = 0) -> np.ndarray:
        obs = [e.reset(seed=seed + i)[0] for i, e in enumerate(self.envs)]
        self._ep_seed = seed + self.num_envs
        return np.asarray(obs, np.float32)

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
        obs, rew, term, trunc, final = [], [], [], [], []
        for e, a in zip(self.envs, np.asarray(actions)):
            o, r, t, tr, _ = e.step(a)
            final.append(np.asarray(o, np.float32))
            if t or tr:
                o = e.reset(seed=self._ep_seed)[0]
                self._ep_seed += 1
            obs.append(np.asarray(o, np.float32))
            rew.append(r)
            term.append(t)
            trunc.append(tr)
        return (
            np.asarray(obs, np.float32),
            np.asarray(rew, np.float32),
            np.asarray(term, bool),
            np.asarray(trunc, bool),
            np.asarray(final, np.float32),
        )

    def close(self):
        for e in self.envs:
            e.close()


def evaluate_policy_on_gym(
    env_id: str,
    policy_fn,
    n_episodes: int = 5,
    max_steps: int = 1_000,
    seed: int = 0,
    discrete: bool = True,
) -> float:
    """Mean return of ``policy_fn`` (numpy obs batch → actions) over
    ``n_episodes`` Gymnasium episodes, each counted to its first end."""
    bridge = GymVecBridge(env_id, n_episodes)
    obs = bridge.reset(seed)
    returns = np.zeros(n_episodes)
    running = np.ones(n_episodes, bool)
    for _ in range(max_steps):
        act = np.asarray(policy_fn(obs))
        if discrete:
            act = act.astype(np.int64)
        obs, rew, term, trunc, _ = bridge.step(act)
        returns += rew * running
        running &= ~(term | trunc)
        if not running.any():
            break
    bridge.close()
    return float(returns.mean())
