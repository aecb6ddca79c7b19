"""Plain reference of the pixel games the cells run, frozen here.

The benchmark judges the port's env step against these files.  Each game
is a file of its own, found by the configuration's ``env`` id
(``games/<env>.py``, its class as ``GAME``): a copy of the game's
published dynamics.  This module holds the arithmetic they share and the
Nature paper's preprocessing around them (4-frame action repeat, max over
the last two rendered frames, a stack of four 84×84 uint8 frames,
sign-clipped rewards, episodic life), written as plain float32 tensor
operations so that the same draws give the same frames bit for bit.
Every draw comes from the generator handed in, in this order per env
step: the frame steps' draws, then the candidate reset's.

It imports nothing of the program: a fault in the port's env step cannot
show up here too.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

H = W = 84
FRAME_SKIP = 4
MAX_FRAMES = 27_000


# -- shared arithmetic --------------------------------------------------------
_consts: Dict[Any, torch.Tensor] = {}


def _const(c: float, device) -> torch.Tensor:
    key = (c, str(device))
    if key not in _consts:
        _consts[key] = torch.tensor(c, dtype=torch.float32, device=device)
    return _consts[key]


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """A correctly rounded float32 division by a constant (a CUDA division
    by a Python number multiplies by its reciprocal instead)."""
    return x / _const(c, x.device)


def grid(device):
    """Pixel centres ``ys [1, 84, 1]``, ``xs [1, 1, 84]``: index / 83."""
    ys = (torch.arange(H, dtype=torch.float32) / (H - 1)).to(device)
    xs = (torch.arange(W, dtype=torch.float32) / (W - 1)).to(device)
    return ys[None, :, None], xs[None, None, :]


def select(mask: torch.Tensor, a, b):
    """Per-instance select over a dataclass of ``[N, ...]`` tensors."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: select(mask, getattr(a, f.name),
                                         getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def uniform_jax(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``[lo, hi)`` from U[0,1) draws with both bounds in float32 first."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return (u * float(hi32 - lo32) + float(lo32)).clamp_min(float(lo32))


# -- the games, found by env id ----------------------------------------------
_games: Dict[str, type] = {}


def find(env_id: str):
    """The game class of the env id (``games/<env_id>.py``'s ``GAME``)."""
    if env_id not in _games:
        path = Path(__file__).resolve().parent / f"{env_id}.py"
        spec = importlib.util.spec_from_file_location(f"{__name__}.{env_id}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _games[env_id] = mod.GAME
    return _games[env_id]


# -- the preprocessed, auto-resetting vector env ------------------------------
@dataclasses.dataclass
class EnvState:
    game: Any
    frames: torch.Tensor  # [N, 84, 84, 4] uint8, newest last
    frame_count: torch.Tensor
    lives: torch.Tensor
    game_over: torch.Tensor
    episode_length: torch.Tensor  # steps taken in the running episode


class VectorEnv:
    """``n`` instances of a game in lockstep, in training mode: frame
    skip 4 with max-pooling of the last two frames, sign-clipped rewards,
    a life lost ends the episode for the learner (the game goes on), the
    game restarts after game over or 27,000 frames."""

    def __init__(self, game_id: str, n: int, device):
        self.game = find(game_id)()
        self.n, self.device = n, torch.device(device)

    def _fresh(self, gen):
        g = self.game.init(gen, self.n, self.device)
        frames = self.game.render(g)[..., None].expand(-1, -1, -1, 4).contiguous()
        zeros = torch.zeros((self.n,), dtype=torch.int32, device=self.device)
        return EnvState(game=g, frames=frames, frame_count=zeros,
                        lives=self.game.lives(g),
                        game_over=torch.zeros((self.n,), dtype=torch.bool,
                                              device=self.device),
                        episode_length=zeros.clone())

    def reset(self, gen) -> EnvState:
        return self._fresh(gen)

    def step(self, gen, s: EnvState, action):
        """``(state, reward, terminated, truncated)`` of one agent step."""
        g, n = s.game, self.n
        reward = torch.zeros((n,), dtype=torch.float32, device=self.device)
        over = torch.zeros((n,), dtype=torch.bool, device=self.device)
        shown = []
        for i in range(FRAME_SKIP):
            g2, r, d = self.game.frame(gen, g, action)
            g = select(over, g, g2)
            reward = reward + torch.where(over, 0.0, r)
            over = over | d
            if i >= FRAME_SKIP - 2:
                shown.append(self.game.render(g))
        img = torch.maximum(shown[-1], shown[-2])
        frames = torch.cat([s.frames[..., 1:], img[..., None]], dim=-1)
        frame_count = s.frame_count + FRAME_SKIP
        lives = self.game.lives(g)
        terminated = over | (lives < s.lives)
        truncated = (frame_count >= MAX_FRAMES) & ~terminated
        done = terminated | truncated
        stepped = EnvState(game=g, frames=frames, frame_count=frame_count,
                           lives=lives, game_over=over,
                           episode_length=s.episode_length + 1)
        # the candidate restart is drawn every step, used where the game is over
        fresh = self._fresh(gen)
        restart = over | (frame_count >= MAX_FRAMES)
        after = select(restart, fresh, stepped)
        after.episode_length = torch.where(done, 0, after.episode_length
                                           ).to(torch.int32)
        # after a mere life loss the game goes on with a new learner episode
        return after, torch.sign(reward), terminated, truncated
