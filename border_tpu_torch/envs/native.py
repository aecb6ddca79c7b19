"""Native (C++) vectorised host environments and the feeder thread that
steps them (≙ border_tpu/envs/native.py).

- :class:`NativeVecEnv` — a ``ctypes`` binding to the C++ env pool of
  ``cpp/envpool.cpp``: N env instances stepped by a C++ worker-thread pool,
  results written straight into numpy buffers.  The library is built from
  that source with the host compiler and ``cpp/Makefile``'s flags into the
  port's ``_build/`` at first use (:mod:`border_tpu_torch.ops._build`); the
  JAX package's committed ``cpp/libenvpool.so`` is left alone.
- :class:`AsyncEnvFeeder` — a worker thread that steps the host envs with
  the previous iteration's actions while the main thread queues the
  device's work.  A ``ctypes`` call releases the interpreter lock, so the
  C++ step runs beside the main thread's dispatch.

Observations are numpy arrays on the host; the trainer uploads them.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.core import spaces
from border_tpu_torch.ops import _build

# (name, train) → C++ env id.  Pong and Breakout are the 84×84 uint8 pixel
# games with the DQN preprocessing stack inline; their train/eval variants
# flip reward sign-clipping (and Breakout's episodic life)
ENV_IDS = {
    ("CartPole-v1", True): 0, ("CartPole-v1", False): 0,
    ("Pendulum-v1", True): 1, ("Pendulum-v1", False): 1,
    ("Pong-v0", True): 2, ("Pong-v0", False): 3,
    ("Breakout-v0", True): 4, ("Breakout-v0", False): 5,
}


def _lib() -> ctypes.CDLL:
    """The env pool's library, built and declared on first use.  Raises
    with the compiler's output if the build fails."""
    lib = _build.load("envpool")
    if not getattr(lib, "_declared", False):
        lib.envpool_create.restype = ctypes.c_void_p
        lib.envpool_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ]
        for fn in ("envpool_obs_dim", "envpool_obs_dtype", "envpool_num_actions"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.envpool_reset.restype = None
        lib.envpool_reset.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.envpool_step.restype = None
        lib.envpool_step.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.envpool_step2.restype = None
        lib.envpool_step2.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.envpool_destroy.restype = None
        lib.envpool_destroy.argtypes = [ctypes.c_void_p]
        lib._declared = True
    return lib


def native_available() -> bool:
    """True when the env pool builds and loads here."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


class NativeVecEnv:
    """N C++ envs stepped in lockstep with auto-reset (host side)."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 n_threads: Optional[int] = None, train: bool = True):
        if (env_name, train) not in ENV_IDS:
            names = sorted({k[0] for k in ENV_IDS})
            raise KeyError(f"native env {env_name!r} not in {names}")
        self._api = _lib()
        if n_threads is None:
            # one core is left to the thread that queues the device's work:
            # with every core stepping envs, the step that should hide
            # behind the update burst slows the burst's dispatch instead
            n_threads = max(1, min((os.cpu_count() or 2) - 1, 8))
        self._h = self._api.envpool_create(
            ENV_IDS[(env_name, train)], num_envs, seed, n_threads
        )
        if not self._h:
            raise RuntimeError("envpool_create failed")
        self.num_envs = num_envs
        self.obs_dim = self._api.envpool_obs_dim(self._h)
        self.num_actions = self._api.envpool_num_actions(self._h)
        # uint8 envs are 84×84 stack-4 pixel frames, channels-last (the
        # PixelEnv observation layout); f32 envs are flat feature vectors
        if self._api.envpool_obs_dtype(self._h) == 1:
            self.obs_shape = (84, 84, 4)
            self.obs_dtype = np.uint8
            if self.obs_dim != 84 * 84 * 4:
                raise RuntimeError(f"pixel env with obs_dim {self.obs_dim}")
        else:
            self.obs_shape = (self.obs_dim,)
            self.obs_dtype = np.float32
        shape = (num_envs,) + self.obs_shape
        self._obs = np.zeros(shape, self.obs_dtype)
        self._final_obs = np.zeros(shape, self.obs_dtype)
        self._rew = np.zeros((num_envs,), np.float32)
        self._term = np.zeros((num_envs,), np.uint8)
        self._trunc = np.zeros((num_envs,), np.uint8)

    @property
    def observation_space(self) -> spaces.Box:
        if self.obs_dtype == np.uint8:
            return spaces.Box(0, 255, self.obs_shape, torch.uint8)
        return spaces.Box(-np.inf, np.inf, self.obs_shape, torch.float32)

    @property
    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(self.num_actions)

    def _actions(self, actions) -> np.ndarray:
        actions = np.ascontiguousarray(actions, np.int32)
        if actions.shape != (self.num_envs,):
            raise ValueError(f"actions of shape {actions.shape} for "
                             f"{self.num_envs} envs")
        return actions

    def reset(self) -> np.ndarray:
        self._api.envpool_reset(self._h, self._obs.ctypes.data)
        return self._obs.copy()

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        actions = self._actions(actions)
        self._api.envpool_step(
            self._h, actions.ctypes.data, self._obs.ctypes.data,
            self._rew.ctypes.data, self._term.ctypes.data,
            self._trunc.ctypes.data,
        )
        return (self._obs.copy(), self._rew.copy(), self._term.astype(bool),
                self._trunc.astype(bool))

    def step_final(self, actions: np.ndarray):
        """Step returning (obs, final_obs, reward, terminated, truncated):
        ``final_obs`` is the pre-auto-reset observation, the correct
        ``next_obs`` of a replay transition at an episode boundary."""
        actions = self._actions(actions)
        self._api.envpool_step2(
            self._h, actions.ctypes.data, self._obs.ctypes.data,
            self._final_obs.ctypes.data, self._rew.ctypes.data,
            self._term.ctypes.data, self._trunc.ctypes.data,
        )
        return (self._obs.copy(), self._final_obs.copy(), self._rew.copy(),
                self._term.astype(bool), self._trunc.astype(bool))

    def close(self):
        if self._h:
            self._api.envpool_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class AsyncEnvFeeder:
    """Host env stepping overlapped with the device's work.

    ``submit(actions)`` hands the next actions to the worker and returns at
    once; ``collect()`` blocks for the oldest submitted step's results (and
    raises what the step raised).  With one step in flight the host env
    time overlaps the device's update burst.
    """

    def __init__(self, env, step_fn=None):
        self.env = env
        self._step = step_fn if step_fn is not None else env.step
        self._in: "queue.Queue" = queue.Queue(maxsize=2)
        self._out: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _loop(self):
        while True:
            actions = self._in.get()
            if actions is None:
                return
            try:
                self._out.put((True, self._step(actions)))
            except Exception as e:  # handed to the caller of collect()
                self._out.put((False, e))

    def submit(self, actions: np.ndarray) -> None:
        self._in.put(np.asarray(actions))

    def collect(self):
        ok, value = self._out.get()
        if not ok:
            raise value
        return value

    def close(self):
        """Stops the worker and closes the env."""
        self._in.put(None)
        self._worker.join(timeout=30)
        self.env.close()
