"""Freeway: a batched on-device ALE-Freeway-equivalent stepper
(≙ border_tpu/envs/freeway.py).

3 actions NOOP/UP/DOWN, +1 reward each time the chicken crosses all ten
traffic lanes, a collision knocks it back down, a fixed timer ends the
episode: the score is crossings per episode.  Start-state variety comes
from randomized car phases; a frame draws nothing.

The chicken crosses about 2.5× faster relative to the timer than ALE's, so
scores compare across runs of THIS game only, never to ALE numbers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from border_tpu_torch.envs.pixel import (
    FRAME_H,
    PixelEnv,
    PixelGame,
    const_tensor,
    pixel_grid,
)

N_LANES = 10
# lane centers from top (y=0) to bottom (y=1)
LANE_Y = np.linspace(0.14, 0.82, N_LANES, dtype=np.float32)
# per-lane speed (fraction of screen width per emulator frame); the middle
# lanes are fastest, as in the original game
LANE_SPEED = np.asarray(
    [0.004, 0.006, 0.008, 0.010, 0.012, 0.012, 0.010, 0.008, 0.006, 0.004],
    np.float32,
)
# top half drives left, bottom half right
LANE_DIR = np.asarray([-1, -1, -1, -1, -1, 1, 1, 1, 1, 1], np.float32)

CHICKEN_X = 0.5
CHICKEN_SPEED = 0.008  # vertical speed per emulator frame
START_Y = 0.92
GOAL_Y = 0.06
CAR_HALF_W = 0.045
CAR_HALF_H = 0.028
HIT_KNOCKBACK = 0.09  # ≈ knocked back one lane
EPISODE_FRAMES = 8_160  # ≙ the 2:16 ALE game timer at 60 fps


def _f32(values: np.ndarray, device) -> torch.Tensor:
    return const_tensor(tuple(float(v) for v in values), torch.float32, device)


@functools.lru_cache(maxsize=None)
def _background(device: torch.device):
    """What ``render`` draws whatever the state: the road, the grass banks
    and the lane markers ``[1, 84, 84]`` uint8, and the cars' row test
    ``[1, L, 84, 1]``."""
    ys, xs = pixel_grid(device, FRAME_H)
    img = torch.full((1, FRAME_H, FRAME_H), 60, dtype=torch.uint8, device=device)
    img.masked_fill_((ys < GOAL_Y) | (ys > START_Y + 0.02), 110)
    lanes = _f32(LANE_Y + 0.042, device)[:, None, None]
    marker = (torch.abs(ys - lanes) < 0.005).any(dim=0, keepdim=True)
    img.masked_fill_(marker & (torch.floor(xs * 12) % 2 == 0), 90)
    car_rows = torch.abs(
        ys[:, None] - _f32(LANE_Y, device)[None, :, None, None]) <= CAR_HALF_H
    return img, car_rows


@dataclasses.dataclass
class FreewayState:
    chicken_y: torch.Tensor  # [N] f32, 1=bottom 0=top
    car_x: torch.Tensor  # [N, N_LANES] f32 in [0, 1)
    score: torch.Tensor  # [N] i32 crossings
    frame: torch.Tensor  # [N] i32 emulator frames elapsed


class Freeway(PixelGame):
    num_actions = 3  # NOOP UP DOWN (ALE minimal set)
    name = "Freeway-v0"
    max_frames = 2 * EPISODE_FRAMES  # timer terminates first

    def init(self, gen, n, device):
        # one draw call: the cars' positions
        u = torch.rand((n, N_LANES), generator=gen, device=device)
        zeros = torch.zeros((n,), dtype=torch.int32, device=device)
        return FreewayState(
            chicken_y=torch.full((n,), START_Y, dtype=torch.float32,
                                 device=device),
            car_x=u,
            score=zeros,
            frame=zeros.clone(),
        )

    def frame_step(self, gen, state: FreewayState, action, u=None):
        a = action.to(torch.int32)
        dev = a.device
        move = torch.where(a == 1, -1.0, 0.0) + torch.where(a == 2, 1.0, 0.0)
        y = torch.clamp(state.chicken_y + move * CHICKEN_SPEED, 0.0, START_Y)

        car_x = (state.car_x + _f32(LANE_SPEED * LANE_DIR, dev)) % 1.0

        # collision: any car overlapping the chicken's fixed x column
        dx = torch.abs(car_x - CHICKEN_X)
        dy = torch.abs(_f32(LANE_Y, dev) - y[:, None])
        hit = ((dx <= CAR_HALF_W) & (dy <= CAR_HALF_H + 0.012)).any(dim=1)
        y = torch.where(hit, torch.clamp(y + HIT_KNOCKBACK, max=START_Y), y)

        # crossing: reached the top bank → +1, restart at the bottom
        crossed = y <= GOAL_Y
        reward = torch.where(crossed, 1.0, 0.0)
        y = torch.where(crossed, START_Y, y)

        frame = state.frame + 1
        done = frame >= EPISODE_FRAMES
        new_state = FreewayState(
            chicken_y=y,
            car_x=car_x,
            score=state.score + crossed.to(torch.int32),
            frame=frame,
        )
        return new_state, reward, done

    def render(self, state: FreewayState) -> torch.Tensor:
        dev = state.chicken_y.device
        ys, xs = pixel_grid(dev, FRAME_H)
        background, car_rows = _background(dev)
        img = background.repeat(state.chicken_y.shape[0], 1, 1)

        # cars: bright rectangles (wrap-aware in x); [N, L, 1, 84] columns
        # against the [1, L, 84, 1] rows
        car_x = state.car_x[:, :, None, None]
        dxs = torch.abs(((xs[:, None] - car_x) + 0.5) % 1.0 - 0.5)
        cars = ((dxs <= CAR_HALF_W) & car_rows).any(dim=1)
        img.masked_fill_(cars, 200)

        # chicken: white blob at the fixed column
        chick = (torch.abs(xs - CHICKEN_X) <= 0.02) & (
            torch.abs(ys - state.chicken_y[:, None, None]) <= 0.022
        )
        img.masked_fill_(chick, 255)
        return img


def make_freeway(train: bool = True) -> PixelEnv:
    return PixelEnv(Freeway(), train=train)
