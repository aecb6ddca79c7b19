"""Pixel-environment machinery: DQN-paper preprocessing on the device
(≙ border_tpu/envs/pixel.py).

- 4-frame action repeat that renders only the last two substeps and
  max-pools them,
- a 4-frame stacking ring kept in the env state, ``[N, 84, 84, 4]`` uint8
  (channels last, as the JAX package's public observation),
- sign reward clipping and episodic life in train mode,
- ``truncated`` once ``max_frames`` emulator frames have run.

The game is any batched :class:`PixelGame`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

from border_tpu_torch.core import spaces
from border_tpu_torch.core.env import Environment, where_state

FRAME_H = FRAME_W = 84


@functools.lru_cache(maxsize=None)
def const_tensor(values: Tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A (nested) tuple of numbers as a tensor on ``device``, made once: a
    game's lookup tables must not cost a host→device copy a frame."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def pixel_grid(device: torch.device, denom: int = FRAME_H - 1):
    """Pixel-centre coordinates ``ys [1, 84, 1]`` and ``xs [1, 1, 84]``,
    ``index / denom`` in float32.  Divided on the host and made once: on a
    CUDA tensor a division by a Python number multiplies by its reciprocal,
    which rounds some coordinates another way than the division does."""
    ys = (torch.arange(FRAME_H, dtype=torch.float32) / denom).to(device)
    xs = (torch.arange(FRAME_W, dtype=torch.float32) / denom).to(device)
    return ys[None, :, None], xs[None, None, :]


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a correctly rounded float32 division on every device
    (see :func:`pixel_grid`): the divisor is a 0-dim tensor on ``x``'s
    device, so the quotient has ``x``'s shape."""
    return x / const_tensor(c, torch.float32, x.device)


def to_gray_84(rgb: torch.Tensor) -> torch.Tensor:
    """RGB ``[..., H, W, 3]`` uint8 → grayscale ``[..., 84, 84]`` uint8:
    luma weights in float32, then a bilinear resize that, like
    ``jax.image.resize``'s, widens its triangle kernel by the scale factor
    where it shrinks (antialiasing), clipped and truncated to uint8."""
    x = rgb.float()
    gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    lead, (h, w) = gray.shape[:-2], gray.shape[-2:]
    out = torch.nn.functional.interpolate(
        gray.reshape(-1, 1, h, w), size=(FRAME_H, FRAME_W), mode="bilinear",
        align_corners=False, antialias=True)
    return out.reshape(*lead, FRAME_H, FRAME_W).clamp(0, 255).to(torch.uint8)


def first_free(on: torch.Tensor) -> torch.Tensor:
    """One-hot ``[N, S]`` mask of each row's first false slot of ``on``
    (all false where the row has no free slot): the batched form of
    writing at ``argmin(on)``."""
    free = ~on
    return free & (free.cumsum(dim=1) == 1)


class PixelGame:
    """Batched single-frame game dynamics consumed by :class:`PixelEnv`.

    - ``init(gen, n, device) -> game_state``
    - ``frame_step(gen, game_state, action) -> (game_state, reward, done)``
      advances ONE emulator frame for every instance,
    - ``render(game_state) -> [N, 84, 84] uint8``,
    - ``lives(game_state) -> [N] int32``.
    """

    num_actions: int = 6
    name: str = "PixelGame"
    max_frames: int = 27_000

    def init(self, gen: torch.Generator, n: int, device: torch.device):
        raise NotImplementedError

    def frame_step(self, gen, state, action):
        raise NotImplementedError

    def render(self, state) -> torch.Tensor:
        raise NotImplementedError

    def lives(self, state) -> torch.Tensor:
        """Remaining lives (games without lives return 1)."""
        first = getattr(state, dataclasses.fields(state)[0].name)
        return torch.ones(first.shape[:1], dtype=torch.int32, device=first.device)


@dataclasses.dataclass
class PixelEnvState:
    game: Any
    frames: torch.Tensor  # [N, 84, 84, 4] uint8 stack ring (newest last)
    frame_count: torch.Tensor  # [N] int32
    t: torch.Tensor  # [N] int32 env steps (post frame-skip)
    lives: torch.Tensor  # [N] int32 lives at the previous step
    game_over: torch.Tensor  # [N] bool, the game's own terminal flag


@dataclasses.dataclass(frozen=True)
class PixelEnvParams:
    frame_skip: int = 4
    clip_reward: bool = True
    episodic_life: bool = True
    max_frames: int = 27_000


class PixelEnv(Environment):
    """Environment adapter: PixelGame → stacked-frame pixel MDP."""

    def __init__(self, game: PixelGame, train: bool = True):
        self.game = game
        self.train = train
        self.name = game.name

    @property
    def default_params(self) -> PixelEnvParams:
        return PixelEnvParams(
            clip_reward=self.train,
            episodic_life=self.train,
            max_frames=self.game.max_frames,
        )

    def observation_space(self, params) -> spaces.Box:
        return spaces.Box(0, 255, (FRAME_H, FRAME_W, 4), torch.uint8)

    def action_space(self, params) -> spaces.Discrete:
        return spaces.Discrete(self.game.num_actions)

    def reset_env(self, gen, n, params, device):
        game = self.game.init(gen, n, device)
        frame = self.game.render(game)
        frames = frame[..., None].expand(-1, -1, -1, 4).contiguous()
        zeros = torch.zeros((n,), dtype=torch.int32, device=device)
        state = PixelEnvState(
            game=game,
            frames=frames,
            frame_count=zeros,
            t=zeros.clone(),
            lives=self.game.lives(game),
            game_over=torch.zeros((n,), dtype=torch.bool, device=device),
        )
        return frames, state

    def step_env(self, gen, state, action, params):
        # unrolled frame-skip: only the LAST TWO substeps are rendered, the
        # max-pool consumes nothing else
        game = state.game
        n = state.frames.shape[0]
        reward = torch.zeros((n,), dtype=torch.float32, device=state.frames.device)
        done = torch.zeros((n,), dtype=torch.bool, device=state.frames.device)
        rendered = []
        for i in range(params.frame_skip):
            game2, r, d = self.game.frame_step(gen, game, action)
            # freeze dynamics once the point/episode ended mid-skip
            game = where_state(done, game, game2)
            reward = reward + torch.where(done, 0.0, r)
            done = done | d
            if i >= params.frame_skip - 2:
                rendered.append(self.game.render(game))
        frame = (
            rendered[-1] if len(rendered) == 1
            else torch.maximum(rendered[-1], rendered[-2])
        )
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        frame_count = state.frame_count + params.frame_skip
        new_lives = self.game.lives(game)
        life_lost = new_lives < state.lives
        new_state = PixelEnvState(
            game=game,
            frames=frames,
            frame_count=frame_count,
            t=state.t + 1,
            lives=new_lives,
            game_over=done,
        )
        if params.clip_reward:
            reward = torch.sign(reward)
        terminated = done
        if params.episodic_life:
            terminated = done | life_lost
        truncated = (frame_count >= params.max_frames) & ~terminated
        return frames, new_state, reward, terminated, truncated, {}

    def post_done_state(self, gen, state, obs, params):
        """Full reset only when the game is really over (or time-capped);
        after a mere life loss the game continues in place."""
        obs_re, st_re = self.reset_env(gen, obs.shape[0], params, obs.device)
        really_over = state.game_over | (state.frame_count >= params.max_frames)
        st = where_state(really_over, st_re, state)
        new_obs = where_state(really_over, obs_re, obs)
        return new_obs, st
