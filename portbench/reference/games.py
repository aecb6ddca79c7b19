"""Plain reference of the two games the cells run, frozen here.

The benchmark judges the port's env step against this file.  It is a
copy of the games' published dynamics (Pong: 6 actions, first to 21;
Seaquest: 3 lives, oxygen, divers) and of the DQN-paper preprocessing
(4-frame action repeat, max over the last two rendered frames, a stack of
four 84×84 uint8 frames, sign-clipped rewards, episodic life), written as
plain float32 tensor operations so that the same draws give the same
frames bit for bit.  Every draw comes from the generator handed in, in
this order per env step: the frame steps' draws, then the candidate
reset's.

It imports nothing of the program: a fault in the port's env step cannot
show up here too.
"""

from __future__ import annotations

import dataclasses
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


# -- Pong ---------------------------------------------------------------------
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


# -- Seaquest -----------------------------------------------------------------
@dataclasses.dataclass
class SeaquestState:
    sub_x: torch.Tensor
    sub_y: torch.Tensor
    facing: torch.Tensor
    oxygen: torch.Tensor
    lives: torch.Tensor
    divers_held: torch.Tensor
    enemy_on: torch.Tensor
    enemy_x: torch.Tensor
    enemy_y: torch.Tensor
    enemy_dir: torch.Tensor
    diver_on: torch.Tensor
    diver_x: torch.Tensor
    diver_y: torch.Tensor
    diver_dir: torch.Tensor
    torp_on: torch.Tensor
    torp_x: torch.Tensor
    torp_y: torch.Tensor
    torp_dir: torch.Tensor


def _first_free(on):
    free = ~on
    return free & (free.cumsum(dim=1) == 1)


class Seaquest:
    """6 actions (NOOP FIRE UP RIGHT LEFT DOWN), 8 enemy, 4 diver and 2
    torpedo slots; +20 a kill, +50 a diver surfaced; a collision or empty
    oxygen costs one of 3 lives.  Six draws an instance a frame."""

    n_actions = 6
    NE, ND, NT = 8, 4, 2
    SURF, SUB_V, EN_V, TORP_V = 0.12, 0.012, 0.008, 0.035
    O2_DRAIN, O2_FILL = 1.0 / 2400.0, 1.0 / 60.0
    P_ENEMY, P_DIVER, HIT_R, LIVES = 0.02, 0.008, 0.035, 3

    def init(self, gen, n, device) -> SeaquestState:
        u = torch.rand((n, 1), generator=gen, device=device)

        def f(v, *shape):
            return torch.full((n, *shape), v, dtype=torch.float32, device=device)

        def off(k):
            return torch.zeros((n, k), dtype=torch.bool, device=device)

        return SeaquestState(
            sub_x=uniform_jax(u[:, 0], 0.3, 0.7), sub_y=f(self.SURF),
            facing=f(1.0), oxygen=f(1.0),
            lives=torch.full((n,), self.LIVES, dtype=torch.int32, device=device),
            divers_held=torch.zeros((n,), dtype=torch.int32, device=device),
            enemy_on=off(self.NE), enemy_x=f(0.0, self.NE),
            enemy_y=f(0.0, self.NE), enemy_dir=f(1.0, self.NE),
            diver_on=off(self.ND), diver_x=f(0.0, self.ND),
            diver_y=f(0.0, self.ND), diver_dir=f(1.0, self.ND),
            torp_on=off(self.NT), torp_x=f(0.0, self.NT),
            torp_y=f(0.0, self.NT), torp_dir=f(1.0, self.NT))

    def lives(self, s):
        return s.lives

    @staticmethod
    def _spawn(u, on, x, y, dirs, p):
        w = _first_free(on) & ((u[:, 0] < p) & ~on.all(dim=1))[:, None]
        left = (u[:, 1] < 0.5)[:, None]
        row = uniform_jax(u[:, 2], 0.25, 0.9)[:, None]
        return (on | w, torch.where(w, torch.where(left, 0.0, 1.0), x),
                torch.where(w, row, y),
                torch.where(w, torch.where(left, 1.0, -1.0), dirs))

    def frame(self, gen, s: SeaquestState, action):
        a = action.to(torch.int32)
        u = torch.rand((a.shape[0], 6), generator=gen, device=a.device)
        dx = torch.where(a == 3, 1.0, 0.0) - torch.where(a == 4, 1.0, 0.0)
        dy = torch.where(a == 5, 1.0, 0.0) - torch.where(a == 2, 1.0, 0.0)
        facing = torch.where(dx > 0, 1.0, torch.where(dx < 0, -1.0, s.facing))
        sub_x = torch.clamp(s.sub_x + dx * self.SUB_V, 0.03, 0.97)
        sub_y = torch.clamp(s.sub_y + dy * self.SUB_V, self.SURF, 0.92)
        at_surface = sub_y <= self.SURF + 0.005
        oxygen = torch.where(at_surface,
                             torch.clamp(s.oxygen + self.O2_FILL, max=1.0),
                             s.oxygen - self.O2_DRAIN)
        surfaced = at_surface & (s.sub_y > self.SURF + 0.005)
        bonus = torch.where(surfaced, 50.0 * s.divers_held.float(), 0.0)
        held = torch.where(surfaced, 0, s.divers_held)

        fire = (a == 1) & ~s.torp_on.all(dim=1)
        w = _first_free(s.torp_on) & fire[:, None]
        torp_on = s.torp_on | w
        torp_x = torch.where(w, sub_x[:, None], s.torp_x)
        torp_y = torch.where(w, sub_y[:, None], s.torp_y)
        torp_dir = torch.where(w, facing[:, None], s.torp_dir)
        torp_x = torp_x + torp_dir * self.TORP_V * torp_on
        torp_on = torp_on & (torp_x > 0.0) & (torp_x < 1.0)

        enemy_x = s.enemy_x + s.enemy_dir * self.EN_V * s.enemy_on
        enemy_on = s.enemy_on & (enemy_x > -0.02) & (enemy_x < 1.02)
        enemy_on, enemy_x, enemy_y, enemy_dir = self._spawn(
            u[:, :3], enemy_on, enemy_x, s.enemy_y, s.enemy_dir, self.P_ENEMY)
        diver_x = s.diver_x + s.diver_dir * 0.5 * self.EN_V * s.diver_on
        diver_on = s.diver_on & (diver_x > -0.02) & (diver_x < 1.02)
        diver_on, diver_x, diver_y, diver_dir = self._spawn(
            u[:, 3:], diver_on, diver_x, s.diver_y, s.diver_dir, self.P_DIVER)

        r = self.HIT_R
        hits = ((torch.abs(torp_x[:, :, None] - enemy_x[:, None, :]) < r)
                & (torch.abs(torp_y[:, :, None] - enemy_y[:, None, :]) < r)
                & torp_on[:, :, None] & enemy_on[:, None, :])
        killed = hits.any(dim=1)
        reward = 20.0 * killed.sum(dim=1) + bonus
        enemy_on = enemy_on & ~killed
        torp_on = torp_on & ~hits.any(dim=2)

        near = ((torch.abs(diver_x - sub_x[:, None]) < r)
                & (torch.abs(diver_y - sub_y[:, None]) < r) & diver_on)
        picked = near & (held[:, None] + near.cumsum(dim=1) <= 6)
        held = held + picked.sum(dim=1).to(torch.int32)
        diver_on = diver_on & ~picked

        hit_sub = ((torch.abs(enemy_x - sub_x[:, None]) < r)
                   & (torch.abs(enemy_y - sub_y[:, None]) < r)
                   & enemy_on).any(dim=1)
        died = hit_sub | (oxygen <= 0.0)
        lives = s.lives - died.to(torch.int32)
        new = SeaquestState(
            sub_x=torch.where(died, 0.5, sub_x),
            sub_y=torch.where(died, self.SURF, sub_y), facing=facing,
            oxygen=torch.where(died, 1.0, oxygen), lives=lives,
            divers_held=torch.where(died, 0, held),
            enemy_on=enemy_on & ~died[:, None], enemy_x=enemy_x,
            enemy_y=enemy_y, enemy_dir=enemy_dir, diver_on=diver_on,
            diver_x=diver_x, diver_y=diver_y, diver_dir=diver_dir,
            torp_on=torp_on, torp_x=torp_x, torp_y=torp_y, torp_dir=torp_dir)
        return new, reward, lives <= 0

    def render(self, s: SeaquestState) -> torch.Tensor:
        ys, xs = grid(s.sub_x.device)

        def blob(px, py, on, rx, ry):
            cols = torch.abs(xs[..., None] - px[:, None, None, :]) <= rx
            rows = ((torch.abs(ys[..., None] - py[:, None, None, :]) <= ry)
                    & on[:, None, None, :])
            return (cols & rows).any(dim=3)

        sx, sy = s.sub_x[:, None, None], s.sub_y[:, None, None]
        layers = (
            (torch.abs(ys - self.SURF) <= 0.006, 60),
            (blob(s.enemy_x, s.enemy_y, s.enemy_on, 0.02, 0.012), 120),
            (blob(s.diver_x, s.diver_y, s.diver_on, 0.012, 0.012), 90),
            (blob(s.torp_x, s.torp_y, s.torp_on, 0.012, 0.005), 200),
            ((torch.abs(xs - sx) <= 0.035) & (torch.abs(ys - sy) <= 0.018), 180),
            ((ys > 0.97) & (xs < s.oxygen[:, None, None]), 255),
        )
        img = torch.zeros((s.sub_x.shape[0], H, W), dtype=torch.uint8,
                          device=s.sub_x.device)
        for mask, value in layers:
            img.masked_fill_(mask, value)
        return img


GAMES = {"Pong-v0": Pong, "Seaquest-v0": Seaquest}


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
        self.game = GAMES[game_id]()
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
