"""Offline datasets → replay buffers (≙ border_tpu/data/datasets.py).

≙ border-minari: MinariDataset::create_replay_buffer flattens episodes into
transition pushes (border-minari/src/dataset.rs:64-100);
``get_num_transitions`` (:40-55); MinariEvaluator's D4RL-convention
normalized score (border-minari/src/evaluator.rs:26-63).

Sources:
- in-memory episode arrays (``OfflineDataset.from_episodes``),
- ``.npz`` archives (``from_npz`` / ``save_npz``), the committed corpora's
  format; dict observations are stored under ``obs.<key>`` /
  ``next_obs.<key>``,
- the Minari python package when it imports (``from_minari``),
- on-policy collection from any agent and env (``collect_dataset``).

A dataset stays numpy on the host until ``to_replay_buffer`` copies it into
a buffer on the buffer's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.core.agent import Agent
from border_tpu_torch.core.env import Environment, VecEnv
from border_tpu_torch.record.record import Record
from border_tpu_torch.replay.buffer import (
    ReplayBuffer,
    ReplayBufferState,
    Transition,
    map_obs,
)
from border_tpu_torch.train.evaluator import Evaluator
from border_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass
class OfflineDataset:
    """Flat transition arrays (numpy, host-side until ingested); ``obs`` and
    ``next_obs`` may be dicts of arrays."""

    obs: Any
    act: np.ndarray
    next_obs: Any
    reward: np.ndarray
    terminated: np.ndarray
    truncated: np.ndarray

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_episodes(cls, episodes: List[Dict[str, np.ndarray]]) -> "OfflineDataset":
        """Episodes with keys obs [T+1, ...], act [T, ...], reward [T],
        terminated (bool, of the final step): the last step of each is
        terminated or, if not, truncated."""
        obs, act, nobs, rew, term, trunc = [], [], [], [], [], []
        for ep in episodes:
            T = len(ep["act"])
            obs.append(ep["obs"][:T])
            nobs.append(ep["obs"][1 : T + 1])
            act.append(ep["act"])
            rew.append(ep["reward"])
            t = np.zeros(T, bool)
            tr = np.zeros(T, bool)
            if ep.get("terminated", False):
                t[-1] = True
            else:
                tr[-1] = True
            term.append(t)
            trunc.append(tr)
        return cls(
            obs=np.concatenate(obs),
            act=np.concatenate(act),
            next_obs=np.concatenate(nobs),
            reward=np.concatenate(rew).astype(np.float32),
            terminated=np.concatenate(term),
            truncated=np.concatenate(trunc),
        )

    @classmethod
    def from_npz(cls, path: str) -> "OfflineDataset":
        """Load a corpus archive.  Dict observations stored under prefixed
        keys (``obs.<key>`` / ``next_obs.<key>``) come back as dicts, their
        keys sorted."""
        with np.load(path) as d:
            def load_obs(prefix):
                keys = [k for k in d.files if k.startswith(prefix + ".")]
                if keys:
                    return {k[len(prefix) + 1:]: d[k] for k in sorted(keys)}
                return d[prefix]

            return cls(
                obs=load_obs("obs"),
                act=d["act"],
                next_obs=load_obs("next_obs"),
                reward=d["reward"],
                terminated=d["terminated"],
                truncated=d["truncated"],
            )

    def save_npz(self, path: str) -> None:
        flat = {}
        for name, val in (("obs", self.obs), ("next_obs", self.next_obs)):
            if isinstance(val, dict):
                for k, v in val.items():
                    flat[f"{name}.{k}"] = v
            else:
                flat[name] = val
        np.savez_compressed(
            path,
            act=self.act,
            reward=self.reward,
            terminated=self.terminated,
            truncated=self.truncated,
            **flat,
        )

    @classmethod
    def from_minari(cls, dataset_id: str) -> "OfflineDataset":
        """Load through the Minari python package when it is installed
        (≙ MinariDataset::load_dataset, dataset.rs:18-31)."""
        try:
            import minari  # type: ignore
        except ImportError as e:
            raise ImportError(
                "the 'minari' package is not available in this environment; "
                "use OfflineDataset.from_npz or collect_dataset instead"
            ) from e
        ds = minari.load_dataset(dataset_id)
        episodes = []
        for ep in ds.iterate_episodes():
            episodes.append(
                {
                    "obs": np.asarray(ep.observations),
                    "act": np.asarray(ep.actions),
                    "reward": np.asarray(ep.rewards),
                    "terminated": bool(np.asarray(ep.terminations)[-1]),
                }
            )
        return cls.from_episodes(episodes)

    def __len__(self) -> int:
        return len(self.reward)

    # -- ingestion (≙ create_replay_buffer, dataset.rs:64-100) -------------
    def to_replay_buffer(
        self, buffer: ReplayBuffer, limit: Optional[int] = None
    ) -> ReplayBufferState:
        """The first ``min(len, limit, capacity)`` transitions as one push
        into a fresh state of ``buffer``, on the buffer's device."""
        n = min(len(self), limit or len(self), buffer.capacity)

        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x[:n]), dtype=dtype,
                                   device=buffer.device)

        batch = Transition(
            obs=map_obs(dev, self.obs),
            act=dev(self.act),
            next_obs=map_obs(dev, self.next_obs),
            reward=dev(self.reward, torch.float32),
            terminated=dev(self.terminated, torch.bool),
            truncated=dev(self.truncated, torch.bool),
        )
        example = Transition(**{
            f.name: map_obs(lambda x: x[0], getattr(batch, f.name))
            for f in dataclasses.fields(Transition)})
        return buffer.push(buffer.init(example), batch)


def collect_dataset(
    env: Environment,
    agent: Agent,
    agent_state: Any,
    n_steps: int,
    num_envs: int = 32,
    seed: int = 0,
    explore: bool = True,
    device: DeviceLike = None,
) -> OfflineDataset:
    """Roll out a policy and return its transitions as a dataset, in step
    order (``n_steps // num_envs`` vectorised steps)."""
    vec = VecEnv(env, num_envs, device=device)
    vec_state = vec.reset(seed)
    gen = torch.Generator(device=vec.device).manual_seed(seed + 1)
    act_fn = agent.select_action if explore else agent.select_action_eval
    steps = []
    with torch.no_grad():
        for _ in range(n_steps // num_envs):
            action = act_fn(agent_state, vec_state.obs, gen)
            prev_obs = vec_state.obs
            ts, vec_state = vec.step(vec_state, action)
            steps.append((prev_obs, action, ts.final_obs, ts.reward,
                          ts.terminated, ts.truncated))

    def flat(xs):
        """[steps] of [num_envs, ...] → [steps·num_envs, ...] numpy."""
        if isinstance(xs[0], dict):
            return {k: flat([x[k] for x in xs]) for k in xs[0]}
        return torch.stack(xs).flatten(0, 1).cpu().numpy()

    return OfflineDataset(*(flat(list(col)) for col in zip(*steps)))


def normalized_score(score: float, ref_min: float, ref_max: float) -> float:
    """D4RL convention: 100·(score − ref_min)/(ref_max − ref_min)
    (≙ MinariEvaluator, border-minari/src/evaluator.rs:26-63)."""
    return 100.0 * (score - ref_min) / (ref_max - ref_min)


class NormalizedEvaluator(Evaluator):
    """Evaluator that also records the D4RL-normalized score."""

    def __init__(self, *args, ref_min: float, ref_max: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.ref_min = ref_min
        self.ref_max = ref_max

    def evaluate(self, agent, agent_state, eval_index: int = 0) -> Tuple[float, Record]:
        score, record = super().evaluate(agent, agent_state, eval_index)
        record["Normalized score"] = normalized_score(
            score, self.ref_min, self.ref_max
        )
        return score, record
