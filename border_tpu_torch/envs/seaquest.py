"""Seaquest: a batched on-device Seaquest-class stepper
(≙ border_tpu/envs/seaquest.py).

Submarine with 3 lives, horizontal enemy fish to shoot (+20), divers to
rescue and surface with (+50 each), a depleting oxygen supply refilled at
the surface (oxygen-out costs a life).  Entities live in fixed-size slot
axes (8 enemies, 4 divers, 2 torpedoes): every state field is ``[N]`` or
``[N, slots]``, and a write into "the first free slot" is a one-hot mask
over the slot axis.

Action set: 6 (NOOP FIRE UP RIGHT LEFT DOWN); fire direction follows the
last horizontal facing.

A frame draws six uniforms per instance in one call, three per spawn
(enemy, then diver): the Bernoulli test, the side, the row.
"""

from __future__ import annotations

import dataclasses

import torch

from border_tpu_torch.core.env import scale_uniform
from border_tpu_torch.envs.pixel import (
    FRAME_H,
    FRAME_W,
    PixelEnv,
    PixelGame,
    first_free,
    pixel_grid,
)

N_ENEMIES = 8
N_DIVERS = 4
N_TORPS = 2
SURFACE_Y = 0.12
SUB_SPEED = 0.012
ENEMY_SPEED = 0.008
TORP_SPEED = 0.035
O2_DRAIN = 1.0 / 2400.0
O2_FILL = 1.0 / 60.0
SPAWN_P_ENEMY = 0.02
SPAWN_P_DIVER = 0.008
HIT_R = 0.035
LIVES = 3


@dataclasses.dataclass
class SeaquestState:
    sub_x: torch.Tensor  # [N]
    sub_y: torch.Tensor
    facing: torch.Tensor  # +1 right, -1 left
    oxygen: torch.Tensor
    lives: torch.Tensor
    divers_held: torch.Tensor
    enemy_on: torch.Tensor  # [N, N_ENEMIES] bool
    enemy_x: torch.Tensor
    enemy_y: torch.Tensor
    enemy_dir: torch.Tensor
    diver_on: torch.Tensor  # [N, N_DIVERS]
    diver_x: torch.Tensor
    diver_y: torch.Tensor
    diver_dir: torch.Tensor
    torp_on: torch.Tensor  # [N, N_TORPS]
    torp_x: torch.Tensor
    torp_y: torch.Tensor
    torp_dir: torch.Tensor


class Seaquest(PixelGame):
    num_actions = 6
    name = "Seaquest-v0"
    max_frames = 27_000

    def init(self, gen, n, device):
        # one draw call: the submarine's x
        u = torch.rand((n, 1), generator=gen, device=device)
        f = lambda v, *s: torch.full((n, *s), v, dtype=torch.float32,  # noqa: E731
                                     device=device)
        off = lambda s: torch.zeros((n, s), dtype=torch.bool, device=device)  # noqa: E731
        return SeaquestState(
            sub_x=scale_uniform(u[:, 0], 0.3, 0.7),
            sub_y=f(SURFACE_Y),
            facing=f(1.0),
            oxygen=f(1.0),
            lives=torch.full((n,), LIVES, dtype=torch.int32, device=device),
            divers_held=torch.zeros((n,), dtype=torch.int32, device=device),
            enemy_on=off(N_ENEMIES),
            enemy_x=f(0.0, N_ENEMIES),
            enemy_y=f(0.0, N_ENEMIES),
            enemy_dir=f(1.0, N_ENEMIES),
            diver_on=off(N_DIVERS),
            diver_x=f(0.0, N_DIVERS),
            diver_y=f(0.0, N_DIVERS),
            diver_dir=f(1.0, N_DIVERS),
            torp_on=off(N_TORPS),
            torp_x=f(0.0, N_TORPS),
            torp_y=f(0.0, N_TORPS),
            torp_dir=f(1.0, N_TORPS),
        )

    def lives(self, state) -> torch.Tensor:
        return state.lives

    def _spawn(self, u, on, x, y, dirs, p):
        """Bernoulli spawn into the first free slot, random side and row.
        ``u``: [N, 3] uniform draws (test, side, row)."""
        do = (u[:, 0] < p) & ~on.all(dim=1)
        w = first_free(on) & do[:, None]
        from_left = (u[:, 1] < 0.5)[:, None]
        row = scale_uniform(u[:, 2], 0.25, 0.9)[:, None]
        return (
            on | w,
            torch.where(w, torch.where(from_left, 0.0, 1.0), x),
            torch.where(w, row, y),
            torch.where(w, torch.where(from_left, 1.0, -1.0), dirs),
        )

    def frame_step(self, gen, state, action, u=None):
        """``u``: [N, 6] uniform draws, the enemy spawn's three then the
        diver spawn's."""
        a = action.to(torch.int32)
        if u is None:
            u = torch.rand((a.shape[0], 6), generator=gen, device=a.device)
        dx = torch.where(a == 3, 1.0, 0.0) - torch.where(a == 4, 1.0, 0.0)
        dy = torch.where(a == 5, 1.0, 0.0) - torch.where(a == 2, 1.0, 0.0)
        facing = torch.where(dx > 0, 1.0, torch.where(dx < 0, -1.0, state.facing))
        sub_x = torch.clamp(state.sub_x + dx * SUB_SPEED, 0.03, 0.97)
        sub_y = torch.clamp(state.sub_y + dy * SUB_SPEED, SURFACE_Y, 0.92)

        # oxygen
        at_surface = sub_y <= SURFACE_Y + 0.005
        oxygen = torch.where(
            at_surface,
            torch.clamp(state.oxygen + O2_FILL, max=1.0),
            state.oxygen - O2_DRAIN,
        )
        # surfacing with divers scores +50 each
        surfaced_now = at_surface & (state.sub_y > SURFACE_Y + 0.005)
        diver_bonus = torch.where(
            surfaced_now, 50.0 * state.divers_held.float(), 0.0
        )
        divers_held = torch.where(surfaced_now, 0, state.divers_held)

        # fire a torpedo into the first free tube
        can_fire = (a == 1) & ~state.torp_on.all(dim=1)
        w = first_free(state.torp_on) & can_fire[:, None]
        torp_on = state.torp_on | w
        torp_x = torch.where(w, sub_x[:, None], state.torp_x)
        torp_y = torch.where(w, sub_y[:, None], state.torp_y)
        torp_dir = torch.where(w, facing[:, None], state.torp_dir)
        # advance torpedoes
        torp_x = torp_x + torp_dir * TORP_SPEED * torp_on
        torp_on = torp_on & (torp_x > 0.0) & (torp_x < 1.0)

        # advance + spawn enemies and divers
        enemy_x = state.enemy_x + state.enemy_dir * ENEMY_SPEED * state.enemy_on
        enemy_on = state.enemy_on & (enemy_x > -0.02) & (enemy_x < 1.02)
        enemy_on, enemy_x, enemy_y, enemy_dir = self._spawn(
            u[:, :3], enemy_on, enemy_x, state.enemy_y, state.enemy_dir,
            SPAWN_P_ENEMY
        )
        diver_x = state.diver_x + state.diver_dir * 0.5 * ENEMY_SPEED * state.diver_on
        diver_on = state.diver_on & (diver_x > -0.02) & (diver_x < 1.02)
        diver_on, diver_x, diver_y, diver_dir = self._spawn(
            u[:, 3:], diver_on, diver_x, state.diver_y, state.diver_dir,
            SPAWN_P_DIVER
        )

        # torpedo × enemy hits (+20 each): an [N, T, E] mask
        dx_te = torch.abs(torp_x[:, :, None] - enemy_x[:, None, :])
        dy_te = torch.abs(torp_y[:, :, None] - enemy_y[:, None, :])
        hits = (
            (dx_te < HIT_R)
            & (dy_te < HIT_R)
            & torp_on[:, :, None]
            & enemy_on[:, None, :]
        )
        enemy_killed = hits.any(dim=1)
        torp_spent = hits.any(dim=2)
        reward = 20.0 * enemy_killed.sum(dim=1) + diver_bonus
        enemy_on = enemy_on & ~enemy_killed
        torp_on = torp_on & ~torp_spent

        # diver pickup (max 6 held, like the real game)
        near_diver = (
            (torch.abs(diver_x - sub_x[:, None]) < HIT_R)
            & (torch.abs(diver_y - sub_y[:, None]) < HIT_R)
            & diver_on
        )
        picked = near_diver & (
            divers_held[:, None] + near_diver.cumsum(dim=1) <= 6)
        divers_held = divers_held + picked.sum(dim=1).to(torch.int32)
        diver_on = diver_on & ~picked

        # sub × enemy collision or oxygen out → life lost, respawn at surface
        hit_sub = (
            (torch.abs(enemy_x - sub_x[:, None]) < HIT_R)
            & (torch.abs(enemy_y - sub_y[:, None]) < HIT_R)
            & enemy_on
        ).any(dim=1)
        died = hit_sub | (oxygen <= 0.0)
        lives = state.lives - died.to(torch.int32)
        sub_x = torch.where(died, 0.5, sub_x)
        sub_y = torch.where(died, SURFACE_Y, sub_y)
        oxygen = torch.where(died, 1.0, oxygen)
        divers_held = torch.where(died, 0, divers_held)
        enemy_on = enemy_on & ~died[:, None]  # clear field on respawn

        done = lives <= 0
        new = SeaquestState(
            sub_x=sub_x, sub_y=sub_y, facing=facing, oxygen=oxygen,
            lives=lives, divers_held=divers_held,
            enemy_on=enemy_on, enemy_x=enemy_x, enemy_y=enemy_y, enemy_dir=enemy_dir,
            diver_on=diver_on, diver_x=diver_x, diver_y=diver_y, diver_dir=diver_dir,
            torp_on=torp_on, torp_x=torp_x, torp_y=torp_y, torp_dir=torp_dir,
        )
        return new, reward, done

    def render(self, state) -> torch.Tensor:
        """[N, 84, 84] uint8; later fills overwrite earlier ones, in the JAX
        version's order."""
        ys, xs = pixel_grid(state.sub_x.device)

        def blob(px, py, on, rx, ry):
            # any over entity slots of an on-masked rectangle, built from a
            # column test [N, 1, 84, S] and a row test [N, 84, 1, S]
            cols = torch.abs(xs[..., None] - px[:, None, None, :]) <= rx
            rows = (torch.abs(ys[..., None] - py[:, None, None, :]) <= ry) \
                & on[:, None, None, :]
            return (cols & rows).any(dim=3)

        sx, sy = state.sub_x[:, None, None], state.sub_y[:, None, None]
        surface = torch.abs(ys - SURFACE_Y) <= 0.006
        sub = (torch.abs(xs - sx) <= 0.035) & (torch.abs(ys - sy) <= 0.018)
        enemies = blob(state.enemy_x, state.enemy_y, state.enemy_on, 0.02, 0.012)
        divers = blob(state.diver_x, state.diver_y, state.diver_on, 0.012, 0.012)
        torps = blob(state.torp_x, state.torp_y, state.torp_on, 0.012, 0.005)
        o2_bar = (ys > 0.97) & (xs < state.oxygen[:, None, None])

        frame = torch.zeros((state.sub_x.shape[0], FRAME_H, FRAME_W),
                            dtype=torch.uint8, device=state.sub_x.device)
        for mask, value in ((surface, 60), (enemies, 120), (divers, 90),
                            (torps, 200), (sub, 180), (o2_bar, 255)):
            frame.masked_fill_(mask, value)
        return frame


def make_seaquest(train: bool = True) -> PixelEnv:
    return PixelEnv(Seaquest(), train=train)
