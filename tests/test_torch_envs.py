"""Port's Pong, PixelEnv and VecEnv vs the JAX package.

Identical states, made with numpy from a seed, go through both sides.  The
game arithmetic is float32 on both and done in the same order, so render,
frame_step and the pixel step are compared bitwise.  The random draws
(serves, resets) cannot match between JAX's threefry and torch's
generators, so they are checked against their ranges, and the parity cases
are built so that no point is scored.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.core.env import VecEnv as JaxVecEnv
from border_tpu.envs import make as jax_make
from border_tpu.envs import pong as jpong
from border_tpu.envs.pixel import PixelEnvState as JaxPixelEnvState
from border_tpu_torch import convert
from border_tpu_torch.core.env import VecEnv
from border_tpu_torch.envs import make, pong

N = 16


def _rally_states(seed, n=N):
    """Pong states mid-rally, away from both goals: the ball cannot leave
    the field within 4 frames, so no serve is drawn."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    return jpong.PongState(
        ball_x=jnp.asarray(f(0.1, 0.9)),
        ball_y=jnp.asarray(f(0.0, 1.0)),
        vx=jnp.asarray(rng.choice([-1, 1], n).astype(np.float32) * f(0.015, 0.02)),
        vy=jnp.asarray(f(-0.024, 0.024)),
        agent_y=jnp.asarray(f(0.075, 0.925)),
        opp_y=jnp.asarray(f(0.075, 0.925)),
        score_agent=jnp.asarray(rng.integers(0, 20, n, dtype=np.int32)),
        score_opp=jnp.asarray(rng.integers(0, 20, n, dtype=np.int32)),
        serve_timer=jnp.asarray(rng.integers(0, 3, n, dtype=np.int32)),
    )


def _assert_pong_equal(got, want):
    for f in dataclasses.fields(pong.PongState):
        np.testing.assert_array_equal(
            getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
            err_msg=f.name,
        )


def test_render_bit_exact():
    js = _rally_states(0)
    # plus frames with the ball hidden for a serve and paddles at the walls
    js = js.replace(
        serve_timer=js.serve_timer.at[:3].set(5),
        agent_y=js.agent_y.at[3].set(jpong.PADDLE_HALF),
        opp_y=js.opp_y.at[4].set(1.0 - jpong.PADDLE_HALF),
    )
    want = np.asarray(jax.vmap(jpong.Pong().render)(js))
    got = pong.Pong().render(convert.pong_state(js, device="cpu"))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (N, 84, 84)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any()


@pytest.mark.parametrize("seed", [1, 2])
def test_frame_step_bit_exact_without_points(seed):
    js = _rally_states(seed)
    act = np.random.default_rng(seed).integers(0, 6, N, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    want, wr, wd = jax.vmap(jpong.Pong().frame_step)(keys, js, jnp.asarray(act))
    gen = torch.Generator().manual_seed(seed)
    got, gr, gd = pong.Pong().frame_step(
        gen, convert.pong_state(js, device="cpu"), torch.from_numpy(act)
    )
    assert not np.asarray(wr).any()  # no point: the parity case holds
    _assert_pong_equal(got, want)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def _pixel_states(seed):
    """Batched PixelEnvStates on both sides around identical rally states."""
    rng = np.random.default_rng(seed)
    jenv = jax_make("Pong-v0")
    game = _rally_states(seed)
    jst = JaxPixelEnvState(
        game=game,
        frames=jnp.asarray(rng.integers(0, 256, (N, 84, 84, 4), dtype=np.uint8)),
        frame_count=jnp.asarray(rng.integers(0, 1000, N, dtype=np.int32)),
        t=jnp.asarray(rng.integers(0, 250, N, dtype=np.int32)),
        lives=jnp.ones((N,), jnp.int32),
        game_over=jnp.zeros((N,), bool),
    )
    return jenv, jst, convert.pixel_env_state(jst, device="cpu")


def test_pixel_step_env_bit_exact_without_points():
    jenv, jst, tst = _pixel_states(3)
    act = np.random.default_rng(3).integers(0, 6, N, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    wobs, wst, wr, wterm, wtrunc, _ = jax.vmap(
        jenv.step_env, in_axes=(0, 0, 0, None)
    )(keys, jst, jnp.asarray(act), jenv.default_params)
    env = make("Pong-v0")
    gobs, gst, gr, gterm, gtrunc, _ = env.step_env(
        torch.Generator().manual_seed(3), tst, torch.from_numpy(act),
        env.default_params,
    )
    np.testing.assert_array_equal(gobs.numpy(), np.asarray(wobs))
    _assert_pong_equal(gst.game, wst.game)
    for name in ("frames", "frame_count", "t", "lives", "game_over"):
        np.testing.assert_array_equal(
            getattr(gst, name).numpy(), np.asarray(getattr(wst, name)),
            err_msg=name,
        )
    for g, w in ((gr, wr), (gterm, wterm), (gtrunc, wtrunc)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the newest frame is the max-pool of the last two renders
    assert not np.array_equal(np.asarray(wobs)[..., -1],
                              np.asarray(jst.frames)[..., -1])


def test_vec_env_auto_reset_bookkeeping_on_forced_done():
    """Half the envs hit the frame cap this step (truncated → full reset);
    episode_length/return freeze into last_* exactly as in JAX."""
    jenv, jst, _ = _pixel_states(4)
    cap = jenv.default_params.max_frames
    forced = np.arange(N) % 2 == 0
    jst = jst.replace(frame_count=jnp.where(
        jnp.asarray(forced), cap - 4, jst.frame_count))
    rng = np.random.default_rng(4)
    jvs_fields = dict(
        episode_return=jnp.asarray(rng.integers(-5, 5, N).astype(np.float32)),
        episode_length=jnp.asarray(rng.integers(0, 999, N, dtype=np.int32)),
        last_return=jnp.asarray(rng.integers(-21, 21, N).astype(np.float32)),
        last_length=jnp.asarray(rng.integers(0, 999, N, dtype=np.int32)),
    )
    jvec = JaxVecEnv(jenv, N)
    jvs = jvec.reset(jax.random.PRNGKey(0)).replace(
        env_state=jst, obs=jst.frames, **jvs_fields)
    act = jnp.asarray(rng.integers(0, 6, N, dtype=np.int32))
    wts, wvs = jvec.step(jvs, act)

    vec = VecEnv(make("Pong-v0"), N, device="cpu")
    tvs = convert.vec_env_state(jvs, seed_or_gen=0, device="cpu")
    gts, gvs = vec.step(tvs, torch.from_numpy(np.array(act)))

    np.testing.assert_array_equal(np.asarray(wts.truncated), forced)
    for name in ("episode_return", "episode_length", "last_return",
                 "last_length"):
        np.testing.assert_array_equal(
            getattr(gvs, name).numpy(), np.asarray(getattr(wvs, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(gts.done.numpy(), np.asarray(wts.done))
    np.testing.assert_array_equal(gts.final_obs.numpy(),
                                  np.asarray(wts.final_obs))
    # envs that went on: the whole state agrees; reset envs: a fresh game
    keep = ~forced
    np.testing.assert_array_equal(gvs.obs.numpy()[keep],
                                  np.asarray(wvs.obs)[keep])
    ges = gvs.env_state
    assert (ges.frame_count.numpy()[forced] == 0).all()
    assert (ges.game.serve_timer.numpy()[forced] == pong.SERVE_FRAMES).all()
    frames = ges.frames.numpy()[forced]
    assert (frames == frames[..., :1]).all()  # reset stack repeats frame 0


def test_serve_draws_in_range():
    """Initial serves and serves after a point land in the ranges of
    ``pong.py``'s serve: vy ∈ [−0.024, 0.024), y ∈ [0.3, 0.7),
    agent_y ∈ [0.35, 0.65), both directions drawn."""
    game = pong.Pong()
    n = 4096
    st = game.init(torch.Generator().manual_seed(0), n, torch.device("cpu"))
    assert ((st.vy >= -pong.BALL_VY_MAX) & (st.vy < pong.BALL_VY_MAX)).all()
    assert ((st.ball_y >= 0.3) & (st.ball_y < 0.7)).all()
    assert ((st.agent_y >= 0.35) & (st.agent_y < 0.65)).all()
    assert (st.ball_x == 0.5).all() and (st.serve_timer == pong.SERVE_FRAMES).all()
    toward = (st.vx > 0).float().mean().item()
    assert 0.45 < toward < 0.55
    assert st.vy.std().item() == pytest.approx(0.048 / 12 ** 0.5, rel=0.05)
    # a point scored by the opponent serves toward the agent
    st = dataclasses.replace(
        st, ball_x=torch.full((n,), 0.999), vx=torch.full((n,), 0.02),
        ball_y=torch.full((n,), 0.02), agent_y=torch.full((n,), 0.9),
        serve_timer=torch.zeros((n,), dtype=torch.int32),
    )
    st2, reward, _ = game.frame_step(
        torch.Generator().manual_seed(1), st, torch.zeros(n, dtype=torch.int32)
    )
    assert (reward == -1).all() and (st2.score_opp == 1).all()
    assert (st2.vx == pong.BALL_SPEED_X).all()
    assert ((st2.ball_y >= 0.3) & (st2.ball_y < 0.7)).all()
    assert ((st2.vy >= -pong.BALL_VY_MAX) & (st2.vy < pong.BALL_VY_MAX)).all()


def test_registry_raises_on_unported_env():
    with pytest.raises(KeyError) as jerr:
        jax_make("NoSuchEnv-v0")
    with pytest.raises(KeyError) as terr:
        make("NoSuchEnv-v0")
    assert "Unknown env 'NoSuchEnv-v0'" in str(jerr.value)
    assert "Unknown env 'NoSuchEnv-v0'" in str(terr.value)
    # every id of the JAX registry is registered here, the Reacher family too
    for name in ("Reacher-v0", "ReacherFlat-v0", "ReacherGoal-v0"):
        assert make(name).name == jax_make(name).name
    env = make("Pong-v0")
    assert env.observation_space(env.default_params).shape == (84, 84, 4)


def test_registry_holds_every_ported_id_of_the_jax_registry():
    from border_tpu.envs.registry import registry as jax_registry
    from border_tpu_torch.envs.registry import registry

    # the flattened Reacher views are named after the env they wrap
    wrapped = {"ReacherFlat-v0": "Reacher-v0-flat", "ReacherGoal-v0": "Reacher-v0-flat"}
    assert set(registry) == set(jax_registry)
    for name in sorted(registry):
        env, jenv = make(name), jax_make(name)
        assert env.name == jenv.name == wrapped.get(name, name)
        space = env.observation_space(env.default_params)
        jspace = jenv.observation_space(jenv.default_params)
        if isinstance(jspace.shape, dict):  # the Dict space of Reacher-v0
            assert space.shape == jspace.shape, name
        else:
            assert tuple(space.shape) == tuple(jspace.shape), name
    for name in ("Breakout-v0", "Seaquest-v0", "Freeway-v0", "SpaceInvaders-v0"):
        assert make(name, train=False).default_params.clip_reward is False
