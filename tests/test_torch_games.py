"""Port's Breakout, Seaquest, Freeway and Space Invaders vs the JAX package.

JAX's threefry streams cannot be matched by a torch generator, so parity
feeds identical states, identical actions and the JAX side's own draws
(recomputed from its key, as raw uniforms) into the port:

- ``render`` is compared bitwise on every state a rollout visits,
- ``frame_step`` is compared frame by frame over a rollout long enough to
  reach a spawn, a brick hit, a shield hit and a life loss: integer and
  boolean fields bitwise, floats to 1e-6,
- constructed states cover what a rollout reaches rarely: two bombs eroding
  one shield cell in the same frame, a full slot axis, a cleared wave.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.envs import breakout as jbreakout
from border_tpu.envs import freeway as jfreeway
from border_tpu.envs import make as jax_make
from border_tpu.envs import seaquest as jseaquest
from border_tpu.envs import space_invaders as jsi
from border_tpu.envs.pixel import PixelEnvState as JaxPixelEnvState
from border_tpu_torch import convert
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.envs import breakout, freeway, make, seaquest, space_invaders

N = 8
FLOAT_ATOL = 1e-6


# -- the JAX side's draws, as the raw uniforms the port maps itself --------

def _seaquest_draws(key):
    k_sp1, k_sp2, _ = jax.random.split(key, 3)
    return jnp.stack([jax.random.uniform(k, ())
                      for k_sp in (k_sp1, k_sp2)
                      for k in jax.random.split(k_sp, 3)])


def _breakout_draws(key):
    return jax.random.uniform(jax.random.fold_in(key, 0), ())[None]


def _si_draws(key):
    cols = jnp.stack([jax.random.randint(k, (), 0, jsi.COLS)
                      for k in jax.random.split(key, jsi.N_BOMBS)])
    return (cols.astype(jnp.float32) + 0.5) / jsi.COLS  # floor(u·COLS) = col


def _no_draws(key):
    return jnp.zeros((0,), jnp.float32)


@dataclasses.dataclass
class Game:
    jgame: object
    tgame: object
    draws: object
    to_torch: object
    bias: tuple  # action probabilities of the rollout's policy


GAMES = {
    "breakout": Game(jbreakout.Breakout(), breakout.Breakout(), _breakout_draws,
                     convert.breakout_state, (0.3, 0.2, 0.25, 0.25)),
    "seaquest": Game(jseaquest.Seaquest(), seaquest.Seaquest(), _seaquest_draws,
                     convert.seaquest_state, (0.1, 0.3, 0.1, 0.15, 0.15, 0.2)),
    "freeway": Game(jfreeway.Freeway(), freeway.Freeway(), _no_draws,
                    convert.freeway_state, (0.1, 0.8, 0.1)),
    "spaceinvaders": Game(jsi.SpaceInvaders(), space_invaders.SpaceInvaders(),
                          _si_draws, convert.space_invaders_state,
                          (0.1, 0.3, 0.1, 0.1, 0.2, 0.2)),
}


def _start(name, seed):
    """The JAX game's own initial states, some moved next to an event."""
    g = GAMES[name]
    st = jax.vmap(g.jgame.init)(jax.random.split(jax.random.PRNGKey(seed), N))
    if name == "seaquest":
        # two submarines deep down and almost out of oxygen
        st = st.replace(sub_y=st.sub_y.at[:2].set(0.5),
                        oxygen=st.oxygen.at[:2].set(0.004))
    if name == "freeway":
        # two chickens a few steps short of the far bank
        st = st.replace(chicken_y=st.chicken_y.at[:2].set(0.08))
    if name == "spaceinvaders":
        # a bomb above the cannon, and two bombs about to land on one cell
        # of the middle shield in the same frame
        y = jsi.SHIELD_Y - jsi.BOMB_SPEED
        st = st.replace(
            bomb_x=st.bomb_x.at[0].set(jnp.array([0.5, 0.9, 0.9]))
                            .at[1].set(jnp.array([0.51, 0.51, 0.1])),
            bomb_y=st.bomb_y.at[0].set(jnp.array([0.85, 0.2, 0.3]))
                            .at[1].set(jnp.array([y, y, 0.5])),
            bomb_live=st.bomb_live.at[:2].set(True),
        )
    return st


def _rollout(name, seed, frames):
    """The JAX trajectory: states[t], actions[t], draws[t], (reward, done)[t]
    with ``states[t+1] = frame_step(states[t], actions[t])``."""
    g = GAMES[name]
    step = jax.jit(jax.vmap(g.jgame.frame_step))
    draws = jax.jit(jax.vmap(g.draws))
    rng = np.random.default_rng(seed)
    st = _start(name, seed)
    out = []
    for t in range(frames):
        keys = jax.random.split(jax.random.PRNGKey(1000 * seed + t), N)
        act = rng.choice(len(g.bias), size=N, p=g.bias).astype(np.int32)
        nxt, reward, done = step(keys, st, jnp.asarray(act))
        out.append((st, act, np.array(draws(keys)), np.asarray(reward),
                    np.asarray(done)))
        st = nxt
    return out, st


def _assert_state_equal(got, want, where=""):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.shape == w.shape and g.dtype == w.dtype, (f.name, g.dtype, w.dtype)
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f"{f.name} {where}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{f.name} {where}")


FRAMES = {"breakout": 260, "seaquest": 160, "freeway": 140, "spaceinvaders": 150}


@pytest.mark.parametrize("name", sorted(GAMES))
def test_frame_step_and_render_match_jax_over_a_rollout(name):
    g = GAMES[name]
    traj, last = _rollout(name, 0, FRAMES[name])
    # op by op, not jitted: each float32 operation is then rounded as
    # written (a fused XLA program may rewrite a division by a constant)
    render = jax.vmap(g.jgame.render)
    nonzero = 0
    for t, (jst, act, u, reward, done) in enumerate(traj):
        tst = g.to_torch(jst, device="cpu")
        want_next = traj[t + 1][0] if t + 1 < len(traj) else last
        got_next, got_r, got_d = g.tgame.frame_step(
            None, tst, torch.from_numpy(act), u=torch.from_numpy(u))
        _assert_state_equal(got_next, want_next, where=f"frame {t}")
        np.testing.assert_array_equal(got_r.numpy(), reward, err_msg=f"frame {t}")
        np.testing.assert_array_equal(got_d.numpy(), done, err_msg=f"frame {t}")
        assert got_r.dtype == torch.float32 and got_d.dtype == torch.bool
        if t % 4 == 0:  # render, bitwise
            frame = g.tgame.render(tst)
            assert frame.dtype == torch.uint8 and tuple(frame.shape) == (N, 84, 84)
            np.testing.assert_array_equal(frame.numpy(), np.asarray(render(jst)),
                                          err_msg=f"render at frame {t}")
            nonzero += int((frame > 0).sum())
        np.testing.assert_array_equal(g.tgame.lives(tst).numpy(),
                                      np.asarray(jax.vmap(g.jgame.lives)(jst)))
    assert nonzero > 0

    # the rollout reached the events the parity is about
    states = [s for s, *_ in traj] + [last]
    rewards = np.stack([r for *_, r, _ in traj])
    assert (rewards > 0).any()
    if name == "breakout":
        bricks = np.stack([np.asarray(s.bricks) for s in states])
        assert bricks[-1].sum() < bricks[0].sum()  # a brick hit
        assert np.asarray(last.lives).min() < jbreakout.LIVES  # a life loss
        assert np.asarray(last.launched).any()
    if name == "seaquest":
        on = np.stack([np.asarray(s.enemy_on) for s in states])
        assert on.any() and np.stack(
            [np.asarray(s.diver_on) for s in states]).any()  # both spawns
        assert np.stack([np.asarray(s.torp_on) for s in states]).any()
        assert np.asarray(last.lives).min() < jseaquest.LIVES  # a life loss
    if name == "freeway":
        ys = np.stack([np.asarray(s.chicken_y) for s in states])
        assert (np.diff(ys, axis=0) > 0.05).any()  # a knock-back or a crossing
        assert np.asarray(last.score).max() >= 1
    if name == "spaceinvaders":
        assert np.asarray(last.aliens).sum() < N * 36  # a shot killed an alien
        assert np.asarray(last.lives).min() < jsi.LIVES  # a bomb hit the cannon
        shields = np.stack([np.asarray(s.shields) for s in states])
        # two bombs on one cell in one frame: the cell lost 2 at once
        assert (np.diff(shields, axis=0) == -2).any()
        assert np.stack([np.asarray(s.bomb_live) for s in states])[5:].any()


def _step_both(name, jst, act, seed=5):
    g = GAMES[name]
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    want, wr, wd = jax.vmap(g.jgame.frame_step)(keys, jst, jnp.asarray(act))
    u = np.array(jax.vmap(g.draws)(keys))
    got, gr, gd = g.tgame.frame_step(None, g.to_torch(jst, device="cpu"), torch.from_numpy(act),
                                     u=torch.from_numpy(u))
    _assert_state_equal(got, want)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(
        g.tgame.render(got).numpy(), np.asarray(jax.vmap(g.jgame.render)(want)))
    return want, np.asarray(wr), np.asarray(wd)


def test_space_invaders_constructed_states():
    """A shot and two bombs on one shield, three bombs on one cell with
    1 hp left, a cleared wave, the grid at the cannon line, a saucer hit."""
    st = _start("spaceinvaders", 1)
    y = jsi.SHIELD_Y - jsi.BOMB_SPEED
    st = st.replace(
        # 0: a live shot and two bombs meet on shield 0
        shot_live=st.shot_live.at[0].set(True).at[4].set(True),
        shot_x=st.shot_x.at[0].set(0.21).at[4].set(0.3),
        shot_y=st.shot_y.at[0].set(jsi.SHIELD_Y + jsi.SHOT_SPEED).at[4].set(0.09),
        bomb_x=st.bomb_x.at[0].set(jnp.array([0.21, 0.215, 0.8]))
                        .at[1].set(jnp.array([0.8, 0.8, 0.8])),
        bomb_y=st.bomb_y.at[0].set(jnp.array([y, y, 0.1]))
                        .at[1].set(jnp.array([y, y, y])),
        bomb_live=st.bomb_live.at[:2].set(True),
        shields=st.shields.at[1, 2].set(1),
        # 2: one alien left, about to be shot: the wave respawns
        # 3: the grid has reached the cannon line
        grid_y=st.grid_y.at[3].set(jsi.CANNON_Y - 0.02 - 6 * jsi.CELL_H + 0.001),
        # 4: a saucer over the shot
        saucer_live=st.saucer_live.at[4].set(True),
        saucer_x=st.saucer_x.at[4].set(0.3),
        frame=st.frame.at[5].set(jsi.SAUCER_PERIOD - 1).at[6].set(34),
    )
    one = jnp.zeros((6, 6), bool).at[2, 3].set(True)
    cx = st.grid_x[2] + 3.5 * jsi.CELL_W
    cy = st.grid_y[2] + 2.5 * jsi.CELL_H
    st = st.replace(
        aliens=st.aliens.at[2].set(one),
        shot_live=st.shot_live.at[2].set(True),
        shot_x=st.shot_x.at[2].set(cx),
        shot_y=st.shot_y.at[2].set(cy + jsi.SHOT_SPEED),
    )
    act = np.zeros(N, np.int32)
    want, reward, done = _step_both("spaceinvaders", st, act)
    shields = np.asarray(want.shields)
    assert shields[0].sum() == 3 * 4 * 4 - 3  # the shot and both bombs counted
    # three bombs on one cell with 1 hp left: all three are absorbed, as in
    # the JAX game, and the cell ends at -2
    assert shields[1, 2].min() == -2 and shields[1, 2].sum() == 4 - 3
    assert reward[2] == 20.0 and int(want.wave[2]) == 1 and np.asarray(want.aliens)[2].all()
    assert done[3] and reward[4] == jsi.SAUCER_SCORE
    assert bool(want.saucer_live[5])  # the saucer spawned on its period


def test_seaquest_constructed_states():
    """All enemy slots taken (a due spawn is dropped), both tubes loaded, a
    torpedo on an enemy, seven divers in reach of a submarine holding 4."""
    st = _start("seaquest", 2)
    st = st.replace(
        enemy_on=st.enemy_on.at[0].set(True).at[1, :3].set(True),
        enemy_x=st.enemy_x.at[0].set(jnp.linspace(0.1, 0.9, 8))
                          .at[1, :3].set(jnp.array([0.5, 0.6, 0.7])),
        enemy_y=st.enemy_y.at[0].set(0.6).at[1, :3].set(0.4),
        torp_on=st.torp_on.at[0].set(True).at[1, 1].set(True),
        torp_x=st.torp_x.at[0].set(jnp.array([0.2, 0.3])).at[1, 1].set(0.47),
        torp_y=st.torp_y.at[0].set(0.3).at[1, 1].set(0.4),
        sub_y=st.sub_y.at[2].set(0.5).at[3].set(0.5),
        sub_x=st.sub_x.at[2].set(0.5).at[3].set(0.5),
        divers_held=st.divers_held.at[2].set(4),
        diver_on=st.diver_on.at[2].set(True),
        diver_x=st.diver_x.at[2].set(0.5),
        diver_y=st.diver_y.at[2].set(0.5),
        # 3: an enemy on the submarine
        oxygen=st.oxygen.at[4].set(0.0002),
    )
    st = st.replace(
        enemy_on=st.enemy_on.at[3, 5].set(True),
        enemy_x=st.enemy_x.at[3, 5].set(0.51),
        enemy_y=st.enemy_y.at[3, 5].set(0.5),
        sub_y=st.sub_y.at[4].set(0.6),
    )
    act = np.ones(N, np.int32)  # FIRE, but where the enemy must reach the sub
    act[3] = 0
    want, reward, _ = _step_both("seaquest", st, act)
    assert reward[1] == 20.0  # the torpedo's enemy
    assert int(want.divers_held[2]) == 6 and int(np.asarray(want.diver_on)[2].sum()) == 2
    lives = np.asarray(want.lives)
    assert lives[3] == 2 and lives[4] == 2 and lives[0] == 3
    assert not np.asarray(want.enemy_on)[3].any()  # the field is cleared


def test_breakout_constructed_states():
    """A ball inside the brick band, one on the paddle, one past it, the last
    brick, an auto-serve."""
    st = _start("breakout", 3)
    last = jnp.zeros((6, 18), bool).at[4, 9].set(True)
    st = st.replace(
        launched=st.launched.at[:5].set(True),
        ball_x=st.ball_x.at[0].set(0.52).at[1].set(0.5).at[2].set(0.5)
                        .at[3].set(0.52).at[4].set(0.003),
        ball_y=st.ball_y.at[0].set(0.30).at[1].set(jbreakout.PADDLE_Y - 0.02)
                        .at[2].set(0.985).at[3].set(0.335).at[4].set(0.5),
        vx=st.vx.at[:5].set(jnp.array([0.005, 0.004, 0.0, 0.0, -0.01])),
        vy=st.vy.at[:5].set(jnp.array([-0.015, 0.015, 0.016, -0.01, 0.01])),
        paddle_x=st.paddle_x.at[1].set(0.48).at[2].set(0.2),
        bricks=st.bricks.at[3].set(last),
        idle_frames=st.idle_frames.at[5].set(jbreakout.AUTO_SERVE),
    )
    want, reward, done = _step_both("breakout", st, np.zeros(N, np.int32))
    assert reward[0] == 4.0 and not bool(want.bricks[0, 2, 9])
    assert float(want.vy[1]) < 0  # bounced off the paddle
    assert int(want.lives[2]) == jbreakout.LIVES - 1 and not bool(want.launched[2])
    assert reward[3] == 1.0 and done[3]  # the wall is cleared
    assert float(want.vx[4]) > 0  # bounced off the side wall
    assert bool(want.launched[5]) and float(want.vy[5]) < 0  # auto-serve


def test_init_draws_in_range_and_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    n = 2048
    for name, g in GAMES.items():
        got = g.tgame.init(gen, n, cpu)
        want = jax.vmap(g.jgame.init)(jax.random.split(jax.random.PRNGKey(0), n))
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
            assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype, (name, f.name)
            lo, hi = float(b.min()), float(b.max())
            span = hi - lo
            assert a.float().min().item() >= lo - 0.02 * span - 1e-6, (name, f.name)
            assert a.float().max().item() <= hi + 0.02 * span + 1e-6, (name, f.name)
            np.testing.assert_allclose(a.float().std().item(), b.astype(np.float32).std(),
                                       rtol=0.1, atol=1e-6, err_msg=f"{name}.{f.name}")
        assert g.tgame.num_actions == g.jgame.num_actions
        assert g.tgame.max_frames == g.jgame.max_frames and g.tgame.name == g.jgame.name
    # the generator's own frame draws: spawns happen at the JAX rates
    st = GAMES["seaquest"].tgame.init(gen, n, cpu)
    st, _, _ = GAMES["seaquest"].tgame.frame_step(gen, st, torch.zeros(n, dtype=torch.int32))
    assert st.enemy_on.sum().item() == pytest.approx(0.02 * n, abs=25)
    assert ((st.enemy_y[st.enemy_on] >= 0.25) & (st.enemy_y[st.enemy_on] < 0.9)).all()


def test_freeway_pixel_env_step_is_bit_exact():
    """Freeway draws nothing in a frame, so the whole PixelEnv step (frame
    skip, max-pool, stack, clip, timer) is compared bitwise."""
    rng = np.random.default_rng(6)
    jenv, env = jax_make("Freeway-v0"), make("Freeway-v0")
    game = _start("freeway", 6)
    game = game.replace(frame=game.frame.at[3].set(jfreeway.EPISODE_FRAMES - 2))
    jst = JaxPixelEnvState(
        game=game,
        frames=jnp.asarray(rng.integers(0, 256, (N, 84, 84, 4), dtype=np.uint8)),
        frame_count=jnp.asarray(rng.integers(0, 1000, N, dtype=np.int32)),
        t=jnp.asarray(rng.integers(0, 250, N, dtype=np.int32)),
        lives=jnp.ones((N,), jnp.int32),
        game_over=jnp.zeros((N,), bool),
    )
    act = rng.integers(0, 3, N, dtype=np.int32)
    act[:2] = 1
    keys = jax.random.split(jax.random.PRNGKey(6), N)
    wobs, wst, wr, wterm, wtrunc, _ = jax.vmap(
        jenv.step_env, in_axes=(0, 0, 0, None)
    )(keys, jst, jnp.asarray(act), jenv.default_params)
    gobs, gst, gr, gterm, gtrunc, _ = env.step_env(
        None, convert.pixel_env_state(jst, device="cpu"), torch.from_numpy(act),
        env.default_params)
    np.testing.assert_array_equal(gobs.numpy(), np.asarray(wobs))
    _assert_state_equal(gst.game, wst.game)
    for g, w in ((gr, wr), (gterm, wterm), (gtrunc, wtrunc),
                 (gst.game_over, wst.game_over), (gst.lives, wst.lives)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(wr)[:2].all() and np.asarray(wterm)[3]


@pytest.mark.parametrize("env_id", ["Breakout-v0", "Seaquest-v0", "Freeway-v0",
                                    "SpaceInvaders-v0"])
def test_vec_env_runs_each_game_with_its_own_generator(env_id):
    """A VecEnv of each game steps from a seed: observations are stacks of
    uint8 frames, two runs from one seed agree bitwise, and train mode clips
    rewards to signs."""
    def run():
        vec = VecEnv(make(env_id), 6, device="cpu")
        st = vec.reset(3)
        rng = torch.Generator().manual_seed(4)
        total = torch.zeros(6)
        for _ in range(12):
            a = torch.randint(0, vec.action_space.n, (6,), generator=rng,
                              dtype=torch.int32)
            ts, st = vec.step(st, a)
            total += ts.reward.abs()
            assert ((ts.reward == 0) | (ts.reward.abs() == 1)).all()
        return st.obs, total

    obs, _ = run()
    obs2, _ = run()
    assert obs.dtype == torch.uint8 and tuple(obs.shape) == (6, 84, 84, 4)
    assert torch.equal(obs, obs2) and (obs > 0).any()
    jenv = jax_make(env_id)
    assert make(env_id).action_space(None).n == jenv.action_space(None).n
