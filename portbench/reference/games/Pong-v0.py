"""Pong (``Pong-v0``): 6 actions, first to 21."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.games import div, grid, select


@dataclasses.dataclass
class PongState:
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    agent_y: torch.Tensor
    opp_y: torch.Tensor
    score_agent: torch.Tensor
    score_opp: torch.Tensor
    serve_timer: torch.Tensor


class Pong:
    """Right paddle is the agent's; a point is ±1; 21 ends the game; the
    ball is held for 20 frames after each point and served from the
    centre at a random height and slope."""

    n_actions = 6
    PADDLE_HALF, AGENT_X, OPP_X, PADDLE_W = 0.075, 0.92, 0.08, 0.02
    BALL_R, BALL_SPEED_X, BALL_VY_MAX = 0.012, 0.0175, 0.024
    PADDLE_SPEED, OPP_SPEED, WIN, SERVE = 0.022, 0.0145, 21, 20

    @staticmethod
    def _lin(u, lo, hi):
        return u * (hi - lo) + lo

    def _serve(self, u, s: PongState, toward_agent) -> PongState:
        return dataclasses.replace(
            s, ball_x=torch.full_like(s.ball_x, 0.5),
            ball_y=self._lin(u[:, 1], 0.3, 0.7),
            vx=torch.where(toward_agent, self.BALL_SPEED_X,
                           -self.BALL_SPEED_X).to(torch.float32),
            vy=self._lin(u[:, 0], -self.BALL_VY_MAX, self.BALL_VY_MAX),
            serve_timer=torch.full_like(s.serve_timer, self.SERVE))

    def init(self, gen, n, device) -> PongState:
        u = torch.rand((n, 4), generator=gen, device=device)
        f = torch.ones((n,), dtype=torch.float32, device=device)
        i = torch.zeros((n,), dtype=torch.int32, device=device)
        s = PongState(ball_x=0.5 * f, ball_y=0.5 * f,
                      vx=self.BALL_SPEED_X * f, vy=0.0 * f,
                      agent_y=self._lin(u[:, 0], 0.35, 0.65), opp_y=0.5 * f,
                      score_agent=i, score_opp=i.clone(), serve_timer=i.clone())
        return self._serve(u[:, 2:], s, u[:, 1] < 0.5)

    def lives(self, s):
        return torch.ones_like(s.score_agent)

    def frame(self, gen, s: PongState, action):
        a = action.to(torch.int32)
        up, down = (a == 2) | (a == 4), (a == 3) | (a == 5)
        move = torch.where(up, -1.0, 0.0) + torch.where(down, 1.0, 0.0)
        ph = self.PADDLE_HALF
        agent_y = torch.clamp(s.agent_y + move * self.PADDLE_SPEED, ph, 1.0 - ph)
        target = torch.where(s.vx < 0, s.ball_y, 0.5)
        opp_y = s.opp_y + torch.clamp(target - s.opp_y, -self.OPP_SPEED,
                                      self.OPP_SPEED)
        opp_y = torch.clamp(opp_y, ph, 1.0 - ph)
        serving = s.serve_timer > 0
        bx = s.ball_x + torch.where(serving, 0.0, s.vx)
        by = s.ball_y + torch.where(serving, 0.0, s.vy)
        r = self.BALL_R
        vy = torch.where((by < r) | (by > 1.0 - r), -s.vy, s.vy)
        by = torch.clamp(by, r, 1.0 - r)
        speed = torch.clamp(torch.abs(s.vx) * 1.03, max=0.03)

        def hit(paddle_y, crossing, sign):
            contact = crossing & (torch.abs(by - paddle_y) <= ph + r)
            return contact, sign * speed, div(by - paddle_y, ph) * self.BALL_VY_MAX

        c_a, vx_a, vy_a = hit(agent_y, (s.vx > 0) & (
            bx >= self.AGENT_X - self.PADDLE_W) & ~serving, -1.0)
        c_o, vx_o, vy_o = hit(opp_y, (s.vx < 0) & (
            bx <= self.OPP_X + self.PADDLE_W) & ~serving, 1.0)
        vx = torch.where(c_a, vx_a, torch.where(c_o, vx_o, s.vx))
        vy = torch.where(c_a, vy_a, torch.where(c_o, vy_o, vy))
        bx = torch.where(c_a, self.AGENT_X - self.PADDLE_W - r,
                         torch.where(c_o, self.OPP_X + self.PADDLE_W + r, bx))
        agent_pt, opp_pt = (bx < 0.0) & ~serving, (bx > 1.0) & ~serving
        reward = agent_pt.to(torch.float32) - opp_pt.to(torch.float32)
        sa = s.score_agent + agent_pt.to(torch.int32)
        so = s.score_opp + opp_pt.to(torch.int32)
        s2 = PongState(ball_x=bx, ball_y=by, vx=vx, vy=vy, agent_y=agent_y,
                       opp_y=opp_y, score_agent=sa, score_opp=so,
                       serve_timer=torch.clamp(s.serve_timer - 1, min=0))
        u = torch.rand((a.shape[0], 2), generator=gen, device=a.device)
        s3 = select(agent_pt | opp_pt, self._serve(u, s2, opp_pt), s2)
        return s3, reward, (sa >= self.WIN) | (so >= self.WIN)

    def render(self, s: PongState) -> torch.Tensor:
        ys, xs = grid(s.ball_x.device)

        def paddle(px, py):
            return ((torch.abs(ys - py[:, None, None]) <= self.PADDLE_HALF)
                    & (torch.abs(xs - px) <= self.PADDLE_W / 2 + 0.006))

        r = self.BALL_R
        ball = ((torch.abs(xs - s.ball_x[:, None, None]) <= r)
                & (torch.abs(ys - s.ball_y[:, None, None]) <= r)
                & (s.serve_timer <= 0)[:, None, None])
        img = (paddle(self.AGENT_X, s.agent_y).to(torch.int16) * 147
               + paddle(self.OPP_X, s.opp_y).to(torch.int16) * 147
               + ball.to(torch.int16) * 236)
        return torch.clamp(img, 0, 255).to(torch.uint8)


GAME = Pong
