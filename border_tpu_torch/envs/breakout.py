"""Breakout: a batched on-device ALE-Breakout-equivalent stepper
(≙ border_tpu/envs/breakout.py).

4-action minimal set (NOOP FIRE RIGHT LEFT), 6×18 brick wall with ALE-style
row scores (7/7/4/4/1/1 top→bottom), 5 lives with the episodic-life
training semantics supplied by PixelEnv, FIRE-to-serve with auto-serve
fallback.  Same preprocessing contract as Pong.

A frame draws one uniform per instance, the launch angle: it is drawn every
frame and used only on the frame the ball is launched.
"""

from __future__ import annotations

import dataclasses

import torch

from border_tpu_torch.core.env import scale_uniform
from border_tpu_torch.envs.pixel import (
    PixelEnv,
    PixelGame,
    const_tensor,
    pixel_grid,
    true_div,
)

ROWS, COLS = 6, 18
BAND_TOP = 0.20
BRICK_H = 0.03
BAND_BOT = BAND_TOP + ROWS * BRICK_H
ROW_SCORE = (7.0, 7.0, 4.0, 4.0, 1.0, 1.0)  # top→bottom

PADDLE_Y = 0.93
PADDLE_HALF = 0.055
PADDLE_SPEED = 0.03
BALL_R = 0.012
BALL_SPEED = 0.017
LIVES = 5
AUTO_SERVE = 45  # frames before auto-FIRE


@dataclasses.dataclass
class BreakoutState:
    bricks: torch.Tensor  # [N, ROWS, COLS] bool
    ball_x: torch.Tensor  # [N]
    ball_y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    paddle_x: torch.Tensor
    lives: torch.Tensor
    launched: torch.Tensor
    idle_frames: torch.Tensor


def _cell(ys: torch.Tensor, xs: torch.Tensor):
    """The brick cell (row, col) under field coordinates."""
    row = torch.clamp(true_div(ys - BAND_TOP, BRICK_H).to(torch.int32), 0, ROWS - 1)
    col = torch.clamp((xs * COLS).to(torch.int32), 0, COLS - 1)
    return row.long(), col.long()


class Breakout(PixelGame):
    num_actions = 4
    name = "Breakout-v0"
    max_frames = 27_000

    def init(self, gen, n, device):
        # one draw call: ball x, paddle x
        u = torch.rand((n, 2), generator=gen, device=device)
        zeros = torch.zeros((n,), dtype=torch.float32, device=device)
        return BreakoutState(
            bricks=torch.ones((n, ROWS, COLS), dtype=torch.bool, device=device),
            ball_x=scale_uniform(u[:, 0], 0.3, 0.7),
            ball_y=torch.full_like(zeros, PADDLE_Y - 0.05),
            vx=zeros,
            vy=zeros.clone(),
            paddle_x=scale_uniform(u[:, 1], 0.3, 0.7),
            lives=torch.full((n,), LIVES, dtype=torch.int32, device=device),
            launched=torch.zeros((n,), dtype=torch.bool, device=device),
            idle_frames=torch.zeros((n,), dtype=torch.int32, device=device),
        )

    def lives(self, state) -> torch.Tensor:
        return state.lives

    def frame_step(self, gen, state, action, u=None):
        """``u``: [N, 1] uniform draws (the launch angle)."""
        a = action.to(torch.int32)
        n = a.shape[0]
        if u is None:
            u = torch.rand((n, 1), generator=gen, device=a.device)
        move = torch.where(a == 2, 1.0, 0.0) + torch.where(a == 3, -1.0, 0.0)
        paddle_x = torch.clamp(
            state.paddle_x + move * PADDLE_SPEED, PADDLE_HALF, 1.0 - PADDLE_HALF
        )

        # serve: FIRE or auto after AUTO_SERVE idle frames
        fire = (a == 1) | (state.idle_frames >= AUTO_SERVE)
        ang = scale_uniform(u[:, 0], -0.7, 0.7)
        launch = ~state.launched & fire
        vx = torch.where(launch, BALL_SPEED * torch.sin(ang), state.vx)
        vy = torch.where(launch, -BALL_SPEED * torch.cos(ang), state.vy)
        launched = state.launched | launch
        idle_frames = torch.where(launched, 0, state.idle_frames + 1)

        # ball rides the paddle until launched
        bx = torch.where(launched, state.ball_x + vx, paddle_x)
        by = torch.where(launched, state.ball_y + vy, PADDLE_Y - 0.03)

        # wall bounces
        vx = torch.where((bx < BALL_R) | (bx > 1.0 - BALL_R), -vx, vx)
        bx = torch.clamp(bx, BALL_R, 1.0 - BALL_R)
        vy = torch.where(by < BALL_R, -vy, vy)
        by = torch.clamp(by, min=BALL_R)

        # paddle bounce with offset-angle control
        hit_paddle = (
            launched
            & (vy > 0)
            & (by >= PADDLE_Y - BALL_R)
            & (by <= PADDLE_Y + 0.02)
            & (torch.abs(bx - paddle_x) <= PADDLE_HALF + BALL_R)
        )
        offset = torch.clamp(true_div(bx - paddle_x, PADDLE_HALF), -1.0, 1.0)
        vx = torch.where(hit_paddle, BALL_SPEED * offset * 0.9, vx)
        vy = torch.where(hit_paddle, -torch.abs(vy), vy)

        # brick collision: cell under the ball, if alive → clear + bounce
        in_band = launched & (by >= BAND_TOP) & (by < BAND_BOT)
        row, col = _cell(by, bx)
        ar = torch.arange(n, device=a.device)
        under = state.bricks[ar, row, col]
        brick_alive = under & in_band
        bricks = state.bricks.clone()
        bricks[ar, row, col] = under & ~brick_alive
        scores = const_tensor(ROW_SCORE, torch.float32, a.device)
        reward = torch.where(brick_alive, scores[row], 0.0)
        vy = torch.where(brick_alive, -vy, vy)

        # life loss
        lost = launched & (by > 1.0 - BALL_R)
        lives = state.lives - lost.to(torch.int32)
        launched = launched & ~lost
        bx = torch.where(lost, paddle_x, bx)
        by = torch.where(lost, PADDLE_Y - 0.03, by)
        vx = torch.where(lost, 0.0, vx)
        vy = torch.where(lost, 0.0, vy)

        cleared = ~bricks.flatten(1).any(dim=1)
        done = (lives <= 0) | cleared
        new = BreakoutState(
            bricks=bricks,
            ball_x=bx,
            ball_y=by,
            vx=vx,
            vy=vy,
            paddle_x=paddle_x,
            lives=lives,
            launched=launched,
            idle_frames=idle_frames,
        )
        return new, reward, done

    def render(self, state) -> torch.Tensor:
        ys, xs = pixel_grid(state.ball_x.device)
        in_band = (ys >= BAND_TOP) & (ys < BAND_BOT)
        row, col = _cell(ys[0], xs[0])  # [84, 1], [1, 84]
        bricks_px = state.bricks[:, row, col] & in_band

        px, bx, by = (t[:, None, None] for t in (
            state.paddle_x, state.ball_x, state.ball_y))
        paddle = (torch.abs(ys - PADDLE_Y) <= 0.012) & (
            torch.abs(xs - px) <= PADDLE_HALF)
        ball = (torch.abs(xs - bx) <= BALL_R) & (torch.abs(ys - by) <= BALL_R)
        frame = (
            bricks_px.to(torch.int16) * 110
            + paddle.to(torch.int16) * 147
            + ball.to(torch.int16) * 236
        )
        return torch.clamp(frame, 0, 255).to(torch.uint8)


def make_breakout(train: bool = True) -> PixelEnv:
    return PixelEnv(Breakout(), train=train)
