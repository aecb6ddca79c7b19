"""PyVecEnv: train on external Python (Gymnasium-API) environments
(≙ border_tpu/envs/py_env.py).

N envs run in the host process behind the same host-env interface as the
C++ :class:`~border_tpu_torch.envs.native.NativeVecEnv` (``reset`` /
``step`` / ``step_final`` / spaces / ``close``), so
:class:`border_tpu_torch.train.HostEnvTrainer` trains a device agent on
them.  An env is anything with the Gymnasium API: ``reset(seed=)`` returning
``(obs, info)``, ``step(a)`` returning ``(obs, reward, terminated,
truncated, info)``, and spaces whose classes are named ``Box``,
``Discrete`` or ``Dict``.  ``gymnasium`` itself is imported only by
:meth:`PyVecEnv.gym` and by the canonical flatten of a Dict observation.

Threading: envs are partitioned over a small thread pool.  Pure-Python env
steps hold the interpreter lock, so the pool wins only where the envs
release it (numpy-heavy or native-backed envs).

Auto-reset: ``step_final`` returns the post-reset obs for acting and the
pre-reset final obs for the replay transition.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from border_tpu_torch.core import spaces


def _to_space(gym_space) -> spaces.Space:
    """A Gymnasium-API space → the port's space, read by the class name."""
    name = type(gym_space).__name__
    if name == "Discrete":
        return spaces.Discrete(int(gym_space.n))
    if name == "Box":
        dtype = torch.uint8 if np.dtype(gym_space.dtype) == np.uint8 else torch.float32
        return spaces.Box(
            float(np.min(gym_space.low)), float(np.max(gym_space.high)),
            tuple(gym_space.shape), dtype,
        )
    raise NotImplementedError(
        f"unsupported gymnasium space {name}; Dict obs are flattened "
        "built-in (flatten_dict=True) — wrap the env for anything else"
    )


class PyVecEnv:
    """N external Python envs stepped in lockstep with auto-reset.

    ``env_fns``: factories returning Gymnasium-API envs.  The convenience
    form ``PyVecEnv.gym(name, num_envs)`` builds them with
    ``gymnasium.make``.
    """

    def __init__(self, env_fns: Sequence[Callable[[], Any]], seed: int = 0,
                 n_threads: Optional[int] = None, flatten_dict: bool = True,
                 flatten_keys: Optional[Sequence[str]] = None):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self._seed = seed
        gs = self.envs[0].observation_space
        # Dict observations are flattened built-in.  ``flatten_keys``
        # selects which keys, in which order; None is gymnasium's canonical
        # flatten (all keys, alphabetical) except for a goal env below
        self._flatten_obs = flatten_dict and type(gs).__name__ == "Dict"
        self._flatten_keys = tuple(flatten_keys) if flatten_keys else None
        if (
            self._flatten_obs
            and self._flatten_keys is None
            and {"observation", "desired_goal", "achieved_goal"} <= set(gs.spaces)
        ):
            # a goal env (the gymnasium-robotics convention): the canonical
            # flatten is alphabetical and includes achieved_goal, a layout
            # other than the offline datasets' (observation ‖ desired_goal,
            # data/minari.py::GoalDictConverter).  Default to the datasets'
            # so a dataset-trained policy sees the same layout on the env
            self._flatten_keys = ("observation", "desired_goal")
        if self._flatten_obs:
            self._gym_obs_space = gs
            if self._flatten_keys is not None:
                missing = [k for k in self._flatten_keys if k not in gs.spaces]
                if missing:
                    raise KeyError(
                        f"flatten_keys {missing} not in the env's Dict obs "
                        f"space (has {sorted(gs.spaces)})"
                    )
                dim = sum(int(np.prod(gs.spaces[k].shape) or 1)
                          for k in self._flatten_keys)
                self.observation_space = spaces.Box(
                    -np.inf, np.inf, (dim,), torch.float32)
            else:
                import gymnasium

                self.observation_space = _to_space(
                    gymnasium.spaces.utils.flatten_space(gs))
        else:
            self.observation_space = _to_space(gs)
        self.action_space = _to_space(self.envs[0].action_space)
        self.obs_shape = self.observation_space.shape
        self.obs_dtype = np.dtype(
            np.uint8 if self.observation_space.dtype == torch.uint8 else np.float32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8, self.num_envs)
        self._pool = (concurrent.futures.ThreadPoolExecutor(n_threads)
                      if n_threads > 1 else None)
        self._n_threads = max(n_threads, 1)

    @classmethod
    def gym(cls, env_name: str, num_envs: int, seed: int = 0,
            n_threads: Optional[int] = None,
            flatten_keys: Optional[Sequence[str]] = None,
            **make_kwargs) -> "PyVecEnv":
        import gymnasium

        return cls(
            [lambda: gymnasium.make(env_name, **make_kwargs)
             for _ in range(num_envs)],
            seed=seed, n_threads=n_threads, flatten_keys=flatten_keys,
        )

    def _obs(self, o):
        """Per-env obs → flat array (Dict obs flattened in key order)."""
        if self._flatten_obs:
            if self._flatten_keys is not None:
                return np.concatenate([np.asarray(o[k], np.float32).ravel()
                                       for k in self._flatten_keys])
            import gymnasium

            return gymnasium.spaces.utils.flatten(self._gym_obs_space, o)
        return o

    # -- the interface shared with NativeVecEnv ----------------------------
    def _map(self, fn):
        if self._pool is None:
            for i in range(self.num_envs):
                fn(i)
            return
        n = self._n_threads

        def run(ixs):
            for i in ixs:
                fn(i)

        # reading each result re-raises what a worker raised
        list(self._pool.map(run, [range(w, self.num_envs, n) for w in range(n)]))

    def reset(self) -> np.ndarray:
        obs = np.zeros((self.num_envs,) + self.obs_shape, self.obs_dtype)

        def one(i):
            o, _ = self.envs[i].reset(seed=self._seed + i)
            obs[i] = self._obs(o)

        self._map(one)
        return obs

    def step(self, actions: np.ndarray):
        obs, _, rew, term, trunc = self.step_final(actions)
        return obs, rew, term, trunc

    def step_final(self, actions: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Step + auto-reset: (obs, final_obs, reward, terminated,
        truncated), ``final_obs`` the pre-reset observation."""
        actions = np.asarray(actions)
        obs = np.zeros((self.num_envs,) + self.obs_shape, self.obs_dtype)
        final = np.zeros_like(obs)
        rew = np.zeros((self.num_envs,), np.float32)
        term = np.zeros((self.num_envs,), bool)
        trunc = np.zeros((self.num_envs,), bool)

        def one(i):
            o, r, te, tr, _ = self.envs[i].step(actions[i])
            final[i] = self._obs(o)
            rew[i] = r
            term[i] = te
            trunc[i] = tr
            if te or tr:
                o, _ = self.envs[i].reset()
            obs[i] = self._obs(o)

        self._map(one)
        return obs, final, rew, term, trunc

    def close(self):
        for e in self.envs:
            e.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


# -- Gymnasium's Pendulum-v1 without gymnasium ---------------------------------
class Box:
    """A Gymnasium-API box space as PyVecEnv reads it: by its class name and
    its ``low``/``high``/``shape``/``dtype``."""

    def __init__(self, low, high, shape, dtype):
        self.low, self.high, self.shape, self.dtype = low, high, shape, dtype


class NumpyPendulum:
    """Gymnasium's ``Pendulum-v1`` (``classic_control/pendulum.py`` with the
    200-step ``TimeLimit`` that ``gymnasium.make`` adds), in plain numpy
    for a machine without gymnasium: ``reset(seed=)`` → ``(obs, info)``,
    ``step(u)`` → ``(obs, reward, terminated, truncated, info)``, the same
    float64 state and seeding (``PCG64(SeedSequence(seed))``), so the same
    seeds and actions give gymnasium's observations and rewards bitwise."""

    max_speed, max_torque, dt, g, m, l, horizon = 8, 2.0, 0.05, 10.0, 1.0, 1.0, 200

    def __init__(self):
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(low=-high, high=high, shape=(3,),
                                     dtype=np.dtype(np.float32))
        self.action_space = Box(low=np.full(1, -2.0, np.float32),
                                high=np.full(1, 2.0, np.float32), shape=(1,),
                                dtype=np.dtype(np.float32))
        self._rng = None

    def reset(self, seed=None, options=None):
        if seed is not None or self._rng is None:
            self._rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self.t = 0
        return self._obs(), {}

    def _obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = (((th + np.pi) % (2 * np.pi)) - np.pi) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self.t += 1
        return self._obs(), -costs, False, self.t >= self.horizon, {}

    def close(self):
        pass


def numpy_pendulum(n: int, seed: int) -> PyVecEnv:
    """``n`` :class:`NumpyPendulum` envs behind ``PyVecEnv``."""
    return PyVecEnv([NumpyPendulum] * n, seed=seed)
