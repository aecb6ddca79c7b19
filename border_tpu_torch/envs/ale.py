"""Real-ALE adapter: the seam for ``gymnasium[atari]`` / ale-py
(≙ border_tpu/envs/ale.py).

:class:`AleVecEnv` exposes the :class:`NativeVecEnv` surface over ale-py, so
the same :class:`~border_tpu_torch.train.HostEnvTrainer` +
``FrameReplayBuffer`` pixel path that trains the C++ envpool games trains
real Atari where the package and its ROMs are installed: newest-frame
uploads, the device stack ring and the frame-dedup replay.

Preprocessing is ``gymnasium.wrappers.AtariPreprocessing`` (frame-skip 4
with a 2-frame max-pool, 84×84 grayscale, 30 no-op starts, episodic life in
train mode) plus an adapter-side stack ring of 4 channels-last uint8
frames; rewards are sign-clipped in train mode and raw in eval mode.

:func:`ale_available` checks for a ROM as well as for the imports: the JAX
package's only tries the imports, and an ale-py without ROMs passes that
check and then fails at the first ``gymnasium.make``.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from border_tpu_torch.core import spaces


def _rom_id(game: str) -> str:
    """``"ALE/SpaceInvaders-v5"`` or ``"SpaceInvadersNoFrameskip-v4"`` →
    ale-py's ROM id ``"space_invaders"``."""
    name = game.split("/")[-1].split("-")[0].replace("NoFrameskip", "")
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def ale_available(game: Optional[str] = None) -> bool:
    """True when gymnasium and ale-py import and a ROM resolves: the ROM of
    ``game`` (an env id such as ``"ALE/Pong-v5"``), or else any ROM."""
    try:
        import gymnasium  # noqa: F401
        from ale_py import roms
    except ImportError:
        return False
    if game is not None:
        ids = [_rom_id(game)]
    else:
        ids = list(roms.get_all_rom_ids())
    return any(roms.get_rom_path(i) is not None for i in ids)


class AleVecEnv:
    """N real-ALE envs in lockstep behind the ``NativeVecEnv`` interface:
    ``reset/step/step_final/close`` and ``[84, 84, stack]`` uint8
    channels-last observations, as the C++ envpool and ``PixelEnv``."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0,
                 n_threads: Optional[int] = None, train: bool = True,
                 stack: int = 4):
        import gymnasium
        from gymnasium.wrappers import AtariPreprocessing

        self.name = env_name
        self.num_envs = num_envs
        self.stack = stack
        self.train = train
        self.envs = []
        for i in range(num_envs):
            # frameskip=1 at the base env: AtariPreprocessing applies the
            # skip-4 + 2-frame max-pool itself
            e = gymnasium.make(env_name, frameskip=1)
            e = AtariPreprocessing(
                e, noop_max=30, frame_skip=4, screen_size=84,
                terminal_on_life_loss=train, grayscale_obs=True,
                scale_obs=False,
            )
            e.reset(seed=seed + i)
            self.envs.append(e)
        self._stacks = np.zeros((num_envs, 84, 84, stack), np.uint8)
        self.obs_shape = (84, 84, stack)
        self.obs_dtype = np.uint8
        self.num_actions = int(self.envs[0].action_space.n)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8, num_envs)
        self._pool = (concurrent.futures.ThreadPoolExecutor(n_threads)
                      if n_threads > 1 else None)

    @property
    def observation_space(self) -> spaces.Box:
        return spaces.Box(0, 255, self.obs_shape, torch.uint8)

    @property
    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(self.num_actions)

    def _map(self, fn):
        if self._pool is None:
            for i in range(self.num_envs):
                fn(i)
        else:
            list(self._pool.map(fn, range(self.num_envs)))

    def reset(self) -> np.ndarray:
        def one(i):
            frame, _ = self.envs[i].reset()
            # a fresh episode repeats its first frame through the stack
            self._stacks[i] = frame[..., None]

        self._map(one)
        return self._stacks.copy()

    def step(self, actions: np.ndarray):
        obs, _, rew, term, trunc = self.step_final(actions)
        return obs, rew, term, trunc

    def step_final(self, actions: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
        """(obs, final_obs, reward, terminated, truncated): ``final_obs``
        is the pre-auto-reset stack, the replay's ``next_obs``."""
        actions = np.asarray(actions)
        final = np.empty_like(self._stacks)
        rew = np.zeros((self.num_envs,), np.float32)
        term = np.zeros((self.num_envs,), bool)
        trunc = np.zeros((self.num_envs,), bool)

        def one(i):
            frame, r, te, tr, _ = self.envs[i].step(int(actions[i]))
            self._stacks[i] = np.concatenate(
                [self._stacks[i, ..., 1:], frame[..., None]], axis=-1)
            final[i] = self._stacks[i]
            rew[i] = np.sign(r) if self.train else r
            term[i], trunc[i] = te, tr
            if te or tr:
                f0, _ = self.envs[i].reset()
                self._stacks[i] = f0[..., None]

        self._map(one)
        return self._stacks.copy(), final, rew, term, trunc

    def close(self):
        for e in self.envs:
            e.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
