"""Batched environment contract (≙ border_tpu/core/env.py).

The JAX package writes single-instance dynamics and batches them with
``vmap``.  Here an :class:`Environment` steps a whole batch at once: its
state is a dataclass of ``[N, ...]`` tensors, and each function takes an
explicit ``torch.Generator`` in place of a JAX key.

- ``reset_env(gen, n, params, device) -> (obs, state)``
- ``step_env(gen, state, action, params) -> (obs, state, reward,
  terminated, truncated, info)``
- auto-reset is fused into :meth:`VecEnv.step`: where an episode ended, the
  returned ``obs`` is already the next episode's first observation and the
  true terminal observation is ``final_obs``.  The JAX version's
  per-instance ``lax.select`` is a ``torch.where`` over the batch.

``terminated`` ends the MDP (no bootstrap); ``truncated`` is a time-limit
cut that still bootstraps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.core import spaces
from border_tpu_torch.utils.device import DeviceLike, as_generator, resolve_device

EnvParams = Any
EnvState = Any


@dataclasses.dataclass
class Timestep:
    """One batched transition's worth of information.

    ``obs`` is what the policy acts on next (post auto-reset);
    ``final_obs`` is the observation that actually followed the action.
    """

    obs: Any
    final_obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, Any]

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


def index_seed(base_seed: int, index: int) -> int:
    """The seed of stream ``index`` under ``base_seed``:
    ``base_seed · 1_000_003 + index`` (the port's stand-in for
    ``jax.random.fold_in``).  The same pair gives the same seed on every
    call; indices below 1_000_003 never collide under one base seed."""
    return int(base_seed) * 1_000_003 + int(index)


def scale_uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map U[0,1) float32 draws onto ``[lo, hi)`` with the arithmetic of
    ``jax.random.uniform(minval=lo, maxval=hi)``: both bounds rounded to
    float32 first, ``u·(hi − lo) + lo``, then clamped from below."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return (u * float(hi32 - lo32) + float(lo32)).clamp_min(float(lo32))


def where_state(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-instance select over a (nested) dataclass or dict of ``[N, ...]``
    tensors: ``a`` where ``mask`` [N] is true, else ``b``."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{
            f.name: where_state(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    if isinstance(a, dict):
        return {k: where_state(mask, a[k], b[k]) for k in a}
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def first_leaf(obs: Any) -> torch.Tensor:
    """An observation's tensor, or the first entry of a dict observation
    (for its batch size and device)."""
    return next(iter(obs.values())) if isinstance(obs, dict) else obs


class Environment:
    """Base class for batched environments."""

    name: str = "Environment"

    @property
    def default_params(self) -> EnvParams:
        raise NotImplementedError

    def observation_space(self, params: EnvParams) -> spaces.Space:
        raise NotImplementedError

    def action_space(self, params: EnvParams) -> spaces.Space:
        raise NotImplementedError

    def reset_env(
        self, gen: torch.Generator, n: int, params: EnvParams,
        device: torch.device,
    ) -> Tuple[Any, EnvState]:
        raise NotImplementedError

    def step_env(
        self, gen: torch.Generator, state: EnvState, action: torch.Tensor,
        params: EnvParams,
    ) -> Tuple[Any, EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
               Dict[str, Any]]:
        raise NotImplementedError

    def post_done_state(
        self, gen: torch.Generator, state: EnvState, obs: Any,
        params: EnvParams,
    ) -> Tuple[Any, EnvState]:
        """State to continue from after a ``done`` flag: a fresh reset by
        default; pixel envs keep the game going after a life loss."""
        x = first_leaf(obs)
        return self.reset_env(gen, x.shape[0], params, x.device)


@dataclasses.dataclass
class VecEnvState:
    """Batched env state plus per-instance episode bookkeeping.

    ``episode_return``/``episode_length`` accumulate the running episode;
    ``last_return``/``last_length`` freeze at each boundary.  ``gen`` is
    the generator the env draws from (mutated in place by each step).
    """

    env_state: Any
    obs: Any
    episode_return: torch.Tensor
    episode_length: torch.Tensor
    last_return: torch.Tensor
    last_length: torch.Tensor
    gen: torch.Generator


class VecEnv:
    """N lockstep instances of an :class:`Environment` on one device."""

    def __init__(
        self, env: Environment, num_envs: int,
        params: Optional[EnvParams] = None, device: DeviceLike = None,
    ):
        self.env = env
        self.num_envs = num_envs
        self.params = env.default_params if params is None else params
        self.device = resolve_device(device)

    @property
    def observation_space(self) -> spaces.Space:
        return self.env.observation_space(self.params)

    @property
    def action_space(self) -> spaces.Space:
        return self.env.action_space(self.params)

    def reset(self, seed_or_gen) -> VecEnvState:
        gen = as_generator(seed_or_gen, self.device)
        obs, st = self.env.reset_env(gen, self.num_envs, self.params, self.device)
        zeros_f = torch.zeros((self.num_envs,), dtype=torch.float32,
                              device=self.device)
        zeros_i = torch.zeros((self.num_envs,), dtype=torch.int32,
                              device=self.device)
        return VecEnvState(
            env_state=st, obs=obs, episode_return=zeros_f,
            episode_length=zeros_i, last_return=zeros_f.clone(),
            last_length=zeros_i.clone(), gen=gen,
        )

    def reset_with_index(self, base_seed: int, index: int,
                         gen: Optional[torch.Generator] = None) -> VecEnvState:
        """Deterministic per-index reset for evaluation
        (≙ Env::reset_with_index, env.rs:162-180): a fresh generator seeded
        with :func:`index_seed`, or ``gen`` re-seeded with it in place (a
        CUDA graph of an evaluation's steps holds its generator, and replays
        the draws of a later evaluation only from that one)."""
        return self.reset(as_generator(index_seed(base_seed, index), self.device,
                                       into=gen))

    def step(
        self, state: VecEnvState, action: torch.Tensor
    ) -> Tuple[Timestep, VecEnvState]:
        obs_st, st, reward, term, trunc, info = self.env.step_env(
            state.gen, state.env_state, action, self.params
        )
        done = term | trunc
        # fused batched auto-reset: a candidate reset for every instance,
        # selected per instance on the done flag (no device→host sync)
        obs_re, st_re = self.env.post_done_state(state.gen, st, obs_st, self.params)
        new_state = where_state(done, st_re, st)
        obs = where_state(done, obs_re, obs_st)

        ep_ret = state.episode_return + reward
        ep_len = state.episode_length + 1
        new_vec = VecEnvState(
            env_state=new_state,
            obs=obs,
            episode_return=torch.where(done, 0.0, ep_ret),
            episode_length=torch.where(done, 0, ep_len).to(torch.int32),
            last_return=torch.where(done, ep_ret, state.last_return),
            last_length=torch.where(done, ep_len, state.last_length),
            gen=state.gen,
        )
        ts = Timestep(obs=obs, final_obs=obs_st, reward=reward,
                      terminated=term, truncated=trunc, info=info)
        return ts, new_vec
