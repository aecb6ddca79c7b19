"""Space Invaders: a batched on-device ALE-SpaceInvaders-equivalent stepper
(≙ border_tpu/envs/space_invaders.py).

ALE-style mechanics on the minimal 6-action set (NOOP FIRE RIGHT LEFT
RIGHTFIRE LEFTFIRE):

- a 6×6 alien grid marches horizontally, drops a row and reverses at the
  screen edge, and accelerates as aliens die (speed ∝ 1/remaining),
- one player shot at a time, alien bombs from the lowest living alien of
  random columns,
- three erodible shields between the cannon and the grid,
- ALE scoring: an alien in row r (top→bottom) is worth 30/25/20/15/10/5;
  waves respawn with a one-row-lower start,
- a mystery saucer crosses the top of the screen periodically, worth 100,
- 3 lives; the game also ends if the grid reaches the cannon row.

A frame draws one uniform per bomb slot per instance in one call, the
column a bomb would fall from; it is used only when that slot is due.
Shield erosion adds into ``shields[instance, shield, cell]`` with
accumulation, so two bombs on one cell in one frame both count.
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

ROWS, COLS = 6, 6
ROW_SCORE = (30.0, 25.0, 20.0, 15.0, 10.0, 5.0)  # top→bottom

# normalized [0,1] playfield geometry
GRID_W = 0.58            # width of the alien grid block
CELL_W = GRID_W / COLS
CELL_H = 0.055
ALIEN_HALF_W = 0.032
ALIEN_HALF_H = 0.018
GRID_TOP0 = 0.08         # initial y of the top row
DROP = 0.04              # descent per edge hit
MARCH_BASE = 0.0012      # grid speed with a full wave (per frame)
MARCH_MAX = 0.009        # grid speed with one alien left

CANNON_Y = 0.92
CANNON_HALF = 0.035
CANNON_SPEED = 0.012

SHOT_SPEED = 0.035       # player shot (fast, one at a time)
BOMB_SPEED = 0.011       # alien bombs
N_BOMBS = 3
BOMB_PERIOD = 35         # frames between bomb drops (per slot, staggered)

N_SHIELDS = 3
SHIELD_Y = 0.80
SHIELD_CELLS = 4         # health cells per shield
SHIELD_HALF = 0.045
SHIELD_HP = 4            # hits a cell absorbs

LIVES = 3
RESPAWN_FRAMES = 30      # cannon invulnerable/frozen after a hit

SAUCER_Y = 0.045         # mystery ship track (above the grid)
SAUCER_SPEED = 0.004
SAUCER_PERIOD = 600      # frames between saucer passes
SAUCER_HALF_W = 0.03
SAUCER_SCORE = 100.0


@dataclasses.dataclass
class SpaceInvadersState:
    aliens: torch.Tensor      # [N, ROWS, COLS] bool
    grid_x: torch.Tensor      # [N] left edge of the grid block
    grid_y: torch.Tensor      # top edge of the grid block
    grid_dir: torch.Tensor    # +1 | -1 march direction
    cannon_x: torch.Tensor
    shot_x: torch.Tensor
    shot_y: torch.Tensor
    shot_live: torch.Tensor
    bomb_x: torch.Tensor      # [N, N_BOMBS]
    bomb_y: torch.Tensor      # [N, N_BOMBS]
    bomb_live: torch.Tensor   # [N, N_BOMBS] bool
    shields: torch.Tensor     # [N, N_SHIELDS, SHIELD_CELLS] int32 hp
    saucer_x: torch.Tensor
    saucer_live: torch.Tensor
    lives: torch.Tensor
    respawn: torch.Tensor     # frames of post-hit freeze left
    frame: torch.Tensor       # frame counter (bomb cadence)
    wave: torch.Tensor        # completed waves (start row lowers)


def _aranges(device):
    """float32 ``arange(COLS)``, ``arange(ROWS)`` and the shield centers."""
    colf = torch.arange(COLS, dtype=torch.float32, device=device)
    rowf = torch.arange(ROWS, dtype=torch.float32, device=device)
    centers = 0.2 + 0.3 * torch.arange(N_SHIELDS, dtype=torch.float32,
                                       device=device)
    return colf, rowf, centers


def _alien_centers(grid_x, grid_y, colf, rowf):
    """x centers ``[N, 1, COLS]`` and y centers ``[N, ROWS, 1]`` of every
    grid cell."""
    cx = (grid_x[:, None] + (colf + 0.5) * CELL_W)[:, None, :]
    cy = (grid_y[:, None] + (rowf + 0.5) * CELL_H)[:, :, None]
    return cx, cy


def _shield_cell(x, centers):
    """Nearest shield, the health cell under ``x`` and whether ``x`` is
    over that shield at all; elementwise over ``x``."""
    s_idx = torch.argmin(torch.abs(x[..., None] - centers), dim=-1)
    c = centers[s_idx]
    cell = torch.clamp(
        true_div(x - (c - SHIELD_HALF), 2 * SHIELD_HALF / SHIELD_CELLS)
        .to(torch.int32), 0, SHIELD_CELLS - 1).long()
    return s_idx, cell, torch.abs(x - c) <= SHIELD_HALF


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last true entry along dim 1 (``size − 1`` where there is
    none, as ``size − 1 − argmax(reversed)`` gives)."""
    return mask.shape[1] - 1 - mask.flip(1).to(torch.uint8).argmax(dim=1)


class SpaceInvaders(PixelGame):
    num_actions = 6
    name = "SpaceInvaders-v0"
    max_frames = 27_000

    def init(self, gen, n, device):
        # one draw call: the grid's x
        u = torch.rand((n, 1), generator=gen, device=device)
        f = lambda v, *s: torch.full((n, *s), v, dtype=torch.float32,  # noqa: E731
                                     device=device)
        i = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)  # noqa: E731
        off = lambda *s: torch.zeros((n, *s), dtype=torch.bool, device=device)  # noqa: E731
        return SpaceInvadersState(
            aliens=torch.ones((n, ROWS, COLS), dtype=torch.bool, device=device),
            grid_x=scale_uniform(u[:, 0], 0.05, 0.25),
            grid_y=f(GRID_TOP0),
            grid_dir=f(1.0),
            cannon_x=f(0.5),
            shot_x=f(0.0),
            shot_y=f(0.0),
            shot_live=off(),
            bomb_x=f(0.0, N_BOMBS),
            bomb_y=f(0.0, N_BOMBS),
            bomb_live=off(N_BOMBS),
            shields=torch.full((n, N_SHIELDS, SHIELD_CELLS), SHIELD_HP,
                               dtype=torch.int32, device=device),
            saucer_x=f(0.0),
            saucer_live=off(),
            lives=i(LIVES),
            respawn=i(0),
            frame=i(0),
            wave=i(0),
        )

    def lives(self, state) -> torch.Tensor:
        return state.lives

    # -- dynamics ----------------------------------------------------------
    def frame_step(self, gen, state, action, u=None):
        """``u``: [N, N_BOMBS] uniform draws (each bomb slot's column)."""
        a = action.to(torch.int32)
        n, dev = a.shape[0], a.device
        if u is None:
            u = torch.rand((n, N_BOMBS), generator=gen, device=dev)
        colf, rowf, shield_centers = _aranges(dev)
        ar = torch.arange(n, device=dev)
        frozen = state.respawn > 0

        # cannon motion (RIGHT/RIGHTFIRE → +, LEFT/LEFTFIRE → −)
        move = (
            torch.where((a == 2) | (a == 4), 1.0, 0.0)
            + torch.where((a == 3) | (a == 5), -1.0, 0.0)
        )
        cannon_x = torch.clamp(
            state.cannon_x + torch.where(frozen, 0.0, move) * CANNON_SPEED,
            CANNON_HALF, 1.0 - CANNON_HALF,
        )

        # player shot: FIRE-class action launches if no shot in flight
        fire = ((a == 1) | (a == 4) | (a == 5)) & ~state.shot_live & ~frozen
        shot_x = torch.where(fire, cannon_x, state.shot_x)
        shot_y = torch.where(fire, CANNON_Y - 0.03, state.shot_y - SHOT_SPEED)
        shot_live = (state.shot_live | fire) & (shot_y > 0.0)

        # grid march: speed scales with 1/remaining (classic accel)
        n_alive = state.aliens.sum(dim=(1, 2)).float()
        speed = MARCH_BASE + (MARCH_MAX - MARCH_BASE) * (
            1.0 - true_div(n_alive - 1.0, ROWS * COLS - 1.0)
        )
        gx = state.grid_x + state.grid_dir * speed
        # live-column extent: edge bounce uses the outermost LIVING columns
        col_alive = state.aliens.any(dim=1)  # [N, COLS]
        left_pad = torch.where(col_alive, colf, float(COLS)).amin(dim=1) * CELL_W
        right_ext = (torch.where(col_alive, colf, -1.0).amax(dim=1) + 1.0) * CELL_W
        hit_edge = ((gx + left_pad < 0.01) & (state.grid_dir < 0)) | (
            (gx + right_ext > 0.99) & (state.grid_dir > 0)
        )
        grid_dir = torch.where(hit_edge, -state.grid_dir, state.grid_dir)
        grid_x = torch.where(hit_edge, state.grid_x, gx)
        grid_y = state.grid_y + torch.where(hit_edge, DROP, 0.0)

        ax, ay = _alien_centers(grid_x, grid_y, colf, rowf)

        # shot↔alien collision: kill exactly one alien, the BOTTOM-most
        # in-band candidate — an upward shot meets the lowest alien first
        in_x = torch.abs(ax - shot_x[:, None, None]) <= ALIEN_HALF_W
        in_y = torch.abs(ay - shot_y[:, None, None]) <= ALIEN_HALF_H + 0.012
        hit_mask = state.aliens & in_x & in_y & shot_live[:, None, None]
        hit_flat = hit_mask.flatten(1)
        any_hit = hit_flat.any(dim=1)
        first = _last_true(hit_flat)
        kill = hit_flat & (
            torch.arange(ROWS * COLS, device=dev)[None, :] == first[:, None])
        aliens = (state.aliens.flatten(1) & ~kill).view(n, ROWS, COLS)
        row_of_kill = first // COLS
        scores = const_tensor(ROW_SCORE, torch.float32, dev)
        reward = torch.where(any_hit, scores[row_of_kill], 0.0)
        shot_live = shot_live & ~any_hit

        # mystery saucer: spawns every SAUCER_PERIOD frames at the left
        # edge, crosses the top track, dies at the right edge or to a
        # player shot (worth SAUCER_SCORE)
        frame = state.frame + 1
        spawn_saucer = ((frame % SAUCER_PERIOD) == 0) & ~state.saucer_live
        saucer_x = torch.where(spawn_saucer, 0.02,
                               state.saucer_x + SAUCER_SPEED)
        saucer_live = (state.saucer_live | spawn_saucer) & (saucer_x < 0.98)
        saucer_hit = (
            saucer_live
            & shot_live
            & (torch.abs(saucer_x - shot_x) <= SAUCER_HALF_W)
            & (shot_y <= SAUCER_Y + 0.02)
        )
        reward = reward + torch.where(saucer_hit, SAUCER_SCORE, 0.0)
        saucer_live = saucer_live & ~saucer_hit
        shot_live = shot_live & ~saucer_hit

        # shot↔shield erosion: the shield is selected by NEAREST center
        s_idx, cell, over_shield = _shield_cell(shot_x, shield_centers)
        shot_on_shield = (
            shot_live
            & over_shield
            & (torch.abs(shot_y - SHIELD_Y) <= 0.015)
            & (state.shields[ar, s_idx, cell] > 0)
        )
        shields = state.shields.index_put(
            (ar, s_idx, cell), -shot_on_shield.to(torch.int32), accumulate=True)
        shot_live = shot_live & ~shot_on_shield

        # alien bombs: slot i drops every BOMB_PERIOD frames (staggered) from
        # the lowest living alien of a random column; all slots at once
        offsets = torch.arange(N_BOMBS, device=dev) * (BOMB_PERIOD // N_BOMBS)
        due = (frame % BOMB_PERIOD)[:, None] == offsets[None, :]  # [N, B]
        col = (u * COLS).long().clamp_max(COLS - 1)  # [N, B]
        column = aliens[ar[:, None], :, col]  # [N, B, ROWS]
        col_has = column.any(dim=2)
        # lowest living row in that column
        low_row = ROWS - 1 - column.flip(2).to(torch.uint8).argmax(dim=2)
        spawn = due & col_has & ~state.bomb_live
        bomb_x = torch.where(spawn, ax[ar[:, None], 0, col], state.bomb_x)
        bomb_y = torch.where(
            spawn, ay[ar[:, None], low_row, 0] + CELL_H,
            state.bomb_y + BOMB_SPEED
        )
        bomb_live = (state.bomb_live | spawn) & (bomb_y < 1.0)

        # bomb↔shield erosion
        b_idx, b_cell, b_over = _shield_cell(bomb_x, shield_centers)
        b_on_shield = (
            bomb_live
            & b_over
            & (torch.abs(bomb_y - SHIELD_Y) <= 0.015)
            & (shields[ar[:, None], b_idx, b_cell] > 0)
        )
        shields = shields.index_put(
            (ar[:, None].expand(-1, N_BOMBS), b_idx, b_cell),
            -b_on_shield.to(torch.int32), accumulate=True)
        bomb_live = bomb_live & ~b_on_shield

        # bomb↔cannon hit
        at_cannon = (
            (torch.abs(bomb_x - cannon_x[:, None]) <= CANNON_HALF + 0.008)
            & (bomb_y >= CANNON_Y - 0.02)
        )
        cannon_hit = (bomb_live & at_cannon & ~frozen[:, None]).any(dim=1)
        bomb_live = bomb_live & ~at_cannon
        lives = state.lives - cannon_hit.to(torch.int32)
        respawn = torch.where(
            cannon_hit, RESPAWN_FRAMES, torch.clamp(state.respawn - 1, min=0)
        )

        # wave cleared → respawn grid one row lower (score keeps running)
        cleared = ~aliens.flatten(1).any(dim=1)
        wave = state.wave + cleared.to(torch.int32)
        aliens = aliens | cleared[:, None, None]
        grid_y = torch.where(
            cleared,
            GRID_TOP0 + DROP * torch.clamp(wave, max=4).float(),
            grid_y,
        )
        grid_x = torch.where(cleared, 0.15, grid_x)

        # terminal: out of lives, or the LOWEST LIVING row reaches the
        # cannon line
        row_alive = aliens.any(dim=2)
        low = torch.where(row_alive, rowf, -1.0).amax(dim=1)
        lowest = grid_y + (low + 1.0) * CELL_H
        invaded = state.aliens.flatten(1).any(dim=1) & (lowest >= CANNON_Y - 0.02)
        done = (lives <= 0) | invaded

        new = SpaceInvadersState(
            aliens=aliens,
            grid_x=grid_x,
            grid_y=grid_y,
            grid_dir=grid_dir,
            cannon_x=cannon_x,
            shot_x=shot_x,
            shot_y=shot_y,
            shot_live=shot_live,
            bomb_x=bomb_x,
            bomb_y=bomb_y,
            bomb_live=bomb_live,
            shields=shields,
            saucer_x=saucer_x,
            saucer_live=saucer_live,
            lives=lives,
            respawn=respawn,
            frame=frame,
            wave=wave,
        )
        return new, reward, done

    # -- rendering ---------------------------------------------------------
    def render(self, state) -> torch.Tensor:
        dev = state.grid_x.device
        n = state.grid_x.shape[0]
        ys, xs = pixel_grid(dev)
        _, _, shield_centers = _aranges(dev)
        v = lambda t: t[:, None, None]  # noqa: E731  [N] → [N, 1, 1]

        # aliens: map each pixel column and row to its grid cell, test the
        # live mask; the column tests are [N, 1, 84], the row tests [N, 84, 1]
        rel_x = xs - v(state.grid_x)
        rel_y = ys - v(state.grid_y)
        col = torch.clamp(true_div(rel_x, CELL_W).to(torch.int32), 0, COLS - 1)
        row = torch.clamp(true_div(rel_y, CELL_H).to(torch.int32), 0, ROWS - 1)
        in_grid = (
            (rel_x >= 0)
            & (rel_x < GRID_W)
            & (rel_y >= 0)
            & (rel_y < ROWS * CELL_H)
        )
        cx = v(state.grid_x) + (col.float() + 0.5) * CELL_W
        cy = v(state.grid_y) + (row.float() + 0.5) * CELL_H
        in_body = (torch.abs(xs - cx) <= ALIEN_HALF_W) & (
            torch.abs(ys - cy) <= ALIEN_HALF_H
        )
        ar = torch.arange(n, device=dev)[:, None, None]
        alien_px = in_grid & in_body & state.aliens[ar, row.long(), col.long()]

        # shields: hp-weighted brightness; which shield and cell a pixel
        # column falls on does not depend on the state
        s_idx, s_cell, s_over = _shield_cell(xs[0, 0], shield_centers)  # [84]
        hp = state.shields[:, s_idx, s_cell][:, None, :]  # [N, 1, 84]
        shield_px = s_over & (torch.abs(ys - SHIELD_Y) <= 0.012) & (hp > 0)
        shield_val = 40 + 25 * hp

        cannon = (torch.abs(xs - v(state.cannon_x)) <= CANNON_HALF) & (
            torch.abs(ys - CANNON_Y) <= 0.015
        )
        shot = (
            v(state.shot_live)
            & (torch.abs(xs - v(state.shot_x)) <= 0.006)
            & (torch.abs(ys - v(state.shot_y)) <= 0.018)
        )
        bombs = (
            state.bomb_live[:, None, None, :]
            & (torch.abs(xs[..., None] - state.bomb_x[:, None, None, :]) <= 0.006)
            & (torch.abs(ys[..., None] - state.bomb_y[:, None, None, :]) <= 0.014)
        ).any(dim=-1)

        saucer = (
            v(state.saucer_live)
            & (torch.abs(xs - v(state.saucer_x)) <= SAUCER_HALF_W)
            & (torch.abs(ys - SAUCER_Y) <= 0.012)
        )
        frame = (
            alien_px.to(torch.int32) * 132
            + saucer.to(torch.int32) * 170
            + shield_px.to(torch.int32) * shield_val
            + cannon.to(torch.int32) * 196
            + shot.to(torch.int32) * 255
            + bombs.to(torch.int32) * 88
        )
        return torch.clamp(frame, 0, 255).to(torch.uint8)


def make_space_invaders(train: bool = True) -> PixelEnv:
    return PixelEnv(SpaceInvaders(), train=train)
