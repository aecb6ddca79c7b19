"""Seaquest (``Seaquest-v0``): 3 lives, oxygen, divers."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.games import H, W, grid, uniform_jax


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


GAME = Seaquest
