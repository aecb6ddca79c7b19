"""Pong: a batched on-device ALE-Pong-equivalent stepper
(≙ border_tpu/envs/pong.py).

Same contract as the JAX game: 6-action minimal set, ±1 reward per point,
first to 21 ends the episode, grayscale 84×84 frames, randomized serves.
Every instance of the batch steps at once; the arithmetic is float32 and
follows the JAX version operation for operation, so ``render`` and
``frame_step`` (when no serve is drawn) agree with it bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from border_tpu_torch.core.env import where_state
from border_tpu_torch.envs.pixel import PixelEnv, PixelGame, pixel_grid, true_div

# geometry (normalized field; x: 0=left/opponent, 1=right/agent)
PADDLE_HALF = 0.075
AGENT_X = 0.92
OPP_X = 0.08
PADDLE_W = 0.02
BALL_R = 0.012
BALL_SPEED_X = 0.0175
BALL_VY_MAX = 0.024
PADDLE_SPEED = 0.022
OPP_SPEED = 0.0145
WIN_SCORE = 21
SERVE_FRAMES = 20  # ball invisible between points


@dataclasses.dataclass
class PongState:
    """Batched game state: every field is ``[N]``."""

    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    agent_y: torch.Tensor
    opp_y: torch.Tensor
    score_agent: torch.Tensor
    score_opp: torch.Tensor
    serve_timer: torch.Tensor  # >0: ball held for serve


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map U[0,1) float32 draws onto [lo, hi)."""
    return u * (hi - lo) + lo


class Pong(PixelGame):
    num_actions = 6  # NOOP FIRE UP DOWN UPFIRE DOWNFIRE (ALE minimal set)
    name = "Pong-v0"
    max_frames = 27_000

    def _serve(self, u: torch.Tensor, state: PongState, toward_agent) -> PongState:
        """``u``: [N, 2] uniform draws (vy, y)."""
        full = torch.full_like(state.ball_x, 0.5)
        return dataclasses.replace(
            state,
            ball_x=full,
            ball_y=_uniform(u[:, 1], 0.3, 0.7),
            vx=torch.where(toward_agent, BALL_SPEED_X, -BALL_SPEED_X).to(torch.float32),
            vy=_uniform(u[:, 0], -BALL_VY_MAX, BALL_VY_MAX),
            serve_timer=torch.full_like(state.serve_timer, SERVE_FRAMES),
        )

    def init(self, gen, n, device):
        u = torch.rand((n, 4), generator=gen, device=device)
        f = torch.ones((n,), dtype=torch.float32, device=device)
        i = torch.zeros((n,), dtype=torch.int32, device=device)
        state = PongState(
            ball_x=0.5 * f,
            ball_y=0.5 * f,
            vx=BALL_SPEED_X * f,
            vy=0.0 * f,
            agent_y=_uniform(u[:, 0], 0.35, 0.65),
            opp_y=0.5 * f,
            score_agent=i,
            score_opp=i.clone(),
            serve_timer=i.clone(),
        )
        return self._serve(u[:, 2:], state, u[:, 1] < 0.5)

    def frame_step(self, gen, state: PongState, action):
        a = action.to(torch.int32)
        # UP on actions 2/4, DOWN on 3/5 (ALE RIGHT=up for the right paddle)
        up = (a == 2) | (a == 4)
        down = (a == 3) | (a == 5)
        move = torch.where(up, -1.0, 0.0) + torch.where(down, 1.0, 0.0)
        agent_y = torch.clamp(
            state.agent_y + move * PADDLE_SPEED, PADDLE_HALF, 1.0 - PADDLE_HALF
        )

        # opponent: track the ball when it approaches, drift to center otherwise
        approaching = state.vx < 0
        target = torch.where(approaching, state.ball_y, 0.5)
        delta = target - state.opp_y
        opp_y = state.opp_y + torch.clamp(delta, -OPP_SPEED, OPP_SPEED)
        opp_y = torch.clamp(opp_y, PADDLE_HALF, 1.0 - PADDLE_HALF)

        serving = state.serve_timer > 0

        # ball advance (frozen while serving)
        bx = state.ball_x + torch.where(serving, 0.0, state.vx)
        by = state.ball_y + torch.where(serving, 0.0, state.vy)
        # wall bounce
        vy = torch.where((by < BALL_R) | (by > 1.0 - BALL_R), -state.vy, state.vy)
        by = torch.clamp(by, BALL_R, 1.0 - BALL_R)

        # paddle collisions: reflect + set outgoing angle by hit offset,
        # slight speed-up per exchange
        speed = torch.clamp(torch.abs(state.vx) * 1.03, max=0.03)

        def hit(paddle_y, crossing, vx_sign):
            offset = true_div(by - paddle_y, PADDLE_HALF)
            contact = crossing & (torch.abs(by - paddle_y) <= PADDLE_HALF + BALL_R)
            return contact, vx_sign * speed, offset * BALL_VY_MAX

        cross_agent = (state.vx > 0) & (bx >= AGENT_X - PADDLE_W) & ~serving
        c_a, vx_a, vy_a = hit(agent_y, cross_agent, -1.0)
        cross_opp = (state.vx < 0) & (bx <= OPP_X + PADDLE_W) & ~serving
        c_o, vx_o, vy_o = hit(opp_y, cross_opp, 1.0)

        vx = torch.where(c_a, vx_a, torch.where(c_o, vx_o, state.vx))
        vy = torch.where(c_a, vy_a, torch.where(c_o, vy_o, vy))
        bx = torch.where(c_a, AGENT_X - PADDLE_W - BALL_R,
                         torch.where(c_o, OPP_X + PADDLE_W + BALL_R, bx))

        # scoring
        agent_point = (bx < 0.0) & ~serving
        opp_point = (bx > 1.0) & ~serving
        reward = agent_point.to(torch.float32) - opp_point.to(torch.float32)
        score_agent = state.score_agent + agent_point.to(torch.int32)
        score_opp = state.score_opp + opp_point.to(torch.int32)

        state2 = PongState(
            ball_x=bx,
            ball_y=by,
            vx=vx,
            vy=vy,
            agent_y=agent_y,
            opp_y=opp_y,
            score_agent=score_agent,
            score_opp=score_opp,
            serve_timer=torch.clamp(state.serve_timer - 1, min=0),
        )
        u = torch.rand((a.shape[0], 2), generator=gen, device=a.device)
        served = self._serve(u, state2, toward_agent=opp_point)
        state3 = where_state(agent_point | opp_point, served, state2)
        done = (score_agent >= WIN_SCORE) | (score_opp >= WIN_SCORE)
        return state3, reward, done

    def render(self, state: PongState) -> torch.Tensor:
        """[N, 84, 84] uint8.  The masks are separable (a row test and a
        column test), so they are built as [N, 84, 1] & [N, 1, 84] products;
        each comparison is the same float32 arithmetic as the JAX version."""
        ys, xs = pixel_grid(state.ball_x.device)

        def paddle_mask(px, py):
            cols = torch.abs(xs - px) <= PADDLE_W / 2 + 0.006
            rows = torch.abs(ys - py[:, None, None]) <= PADDLE_HALF
            return rows & cols

        ball_visible = (state.serve_timer <= 0)[:, None, None]
        ball = (
            (torch.abs(xs - state.ball_x[:, None, None]) <= BALL_R)
            & (torch.abs(ys - state.ball_y[:, None, None]) <= BALL_R)
            & ball_visible
        )
        frame = (
            paddle_mask(AGENT_X, state.agent_y).to(torch.int16) * 147
            + paddle_mask(OPP_X, state.opp_y).to(torch.int16) * 147
            + ball.to(torch.int16) * 236
        )
        return torch.clamp(frame, 0, 255).to(torch.uint8)


def make_pong(train: bool = True) -> PixelEnv:
    return PixelEnv(Pong(), train=train)
