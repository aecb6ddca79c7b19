"""Public names of the JAX package that the port carries too, held against
the JAX ones on the CPU: ``Space.sample`` of Discrete, Box and Dict,
``envs.pixel.to_gray_84``, ``Agent.model_info``,
``errors.EnvironmentError_``, ``agents.common.gamma_not_done`` (bitwise,
float32, for boolean and float flags) and ``FrameReplayBuffer.size_attr``.

Tolerances: the samples come from different generators (a JAX key, a
``torch.Generator``), so what is compared is what a caller relies on:
dtype, shape, range, and a Dict's key order, all exactly.  ``to_gray_84``
is compared with the JAX function on seeded RGB frames of three sizes
(Atari's 210×160, 250×300, and 64×48, which is enlarged): at most one grey
level apart, as found (the two resizes weigh the same pixels with the same
antialiased triangle kernel and may round a sum that lies on a level's
edge to either side), and equal on at least 99.9% of the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu import errors as jerrors
from border_tpu.agents.common import gamma_not_done as jax_gamma_not_done
from border_tpu.core import spaces as jspaces
from border_tpu.envs.pixel import to_gray_84 as jax_to_gray_84
from border_tpu.replay.frame_buffer import FrameReplayBuffer as JFrameReplayBuffer
from border_tpu_torch import errors
from border_tpu_torch.agents.common import gamma_not_done
from border_tpu_torch.core import spaces
from border_tpu_torch.envs.pixel import to_gray_84
from border_tpu_torch.replay import FrameReplayBuffer

N = 2000


def _space_pairs():
    return {
        "discrete": (jspaces.Discrete(7), spaces.Discrete(7)),
        "box": (jspaces.Box(-2.0, 3.0, (3, 2)), spaces.Box(-2.0, 3.0, (3, 2))),
        "box_unbounded": (
            jspaces.Box(np.array([-1.0, -np.inf]), np.array([1.0, np.inf])),
            spaces.Box(np.array([-1.0, -np.inf]), np.array([1.0, np.inf]))),
        "dict": (
            jspaces.Dict({"z": jspaces.Box(0.0, 1.0, (2,)),
                          "a": jspaces.Discrete(3)}),
            spaces.Dict({"z": spaces.Box(0.0, 1.0, (2,)),
                         "a": spaces.Discrete(3)})),
    }


@pytest.mark.parametrize("name", sorted(_space_pairs()))
def test_space_sample_matches_jax_dtype_shape_range_and_keys(name):
    jsp, tsp = _space_pairs()[name]
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jx = jax.vmap(jsp.sample)(keys)
    gen = torch.Generator().manual_seed(0)
    tx = [tsp.sample(gen) for _ in range(N)]
    if isinstance(jx, dict):
        assert list(tx[0]) == list(jax.jit(jsp.sample)(keys[0])) == ["a", "z"]
        pairs = [(np.asarray(jx[k]), torch.stack([t[k] for t in tx]).numpy(),
                  dict(jsp.spaces)[k]) for k in jx]
    else:
        pairs = [(np.asarray(jx), torch.stack(tx).numpy(), jsp)]
    for j, t, sp in pairs:
        assert t.shape == j.shape and t.dtype == j.dtype
        if isinstance(sp, jspaces.Discrete):
            assert set(np.unique(t)) == set(np.unique(j)) == set(range(sp.n))
            continue
        low = np.broadcast_to(np.asarray(sp.low, np.float32), sp.shape)
        high = np.broadcast_to(np.asarray(sp.high, np.float32), sp.shape)
        finite = np.isfinite(low) & np.isfinite(high)
        for x in (t, j):
            assert (x[:, finite] >= low[finite]).all()
            assert (x[:, finite] < high[finite]).all()
            # unbounded entries draw N(0, 1)
            assert np.isfinite(x).all()
            if (~finite).any():
                z = x[:, ~finite]
                assert abs(z.mean()) < 0.1 and abs(z.std() - 1) < 0.1


@pytest.mark.parametrize("hw", [(210, 160), (250, 300), (64, 48)])
def test_to_gray_84_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    frames = rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8)
    want = np.stack([np.asarray(jax_to_gray_84(jnp.asarray(f))) for f in frames])
    got = to_gray_84(torch.from_numpy(frames))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, 84, 84)
    single = to_gray_84(torch.from_numpy(frames[0]))
    assert torch.equal(single, got[0])
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_model_info_matches_jax():
    """(opt-step counter, the policy's parameters), as the JAX agents'."""
    from border_tpu.agents import DQN as JaxDQN
    from border_tpu_torch import convert
    from border_tpu_torch.agents import DQN

    jagent, tagent = JaxDQN(), DQN()
    jst = jagent.init(jax.random.PRNGKey(0), jspaces.Box(-1.0, 1.0, (4,)),
                      jspaces.Discrete(2))
    jst = jst.replace(n_opts=jnp.int32(17))
    tst = convert.dqn_state(tagent, jst, spaces.Box(-1.0, 1.0, (4,)),
                            spaces.Discrete(2), device="cpu")
    jn, jparams = jagent.model_info(jst)
    tn, tparams = tagent.model_info(tst)
    assert tn == int(jn) == 17
    assert tparams is tagent.policy_params(tst) is tst.params
    want = convert.net_state_dict(tparams, jparams)
    for k, v in tparams.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy())


def test_environment_error_matches_jax():
    assert errors.EnvironmentError_.__name__ == jerrors.EnvironmentError_.__name__
    assert [c.__name__ for c in errors.EnvironmentError_.__mro__] == [
        c.__name__ for c in jerrors.EnvironmentError_.__mro__]
    assert issubclass(errors.EnvironmentError_, errors.BorderTpuError)
    assert issubclass(errors.EnvironmentError_, RuntimeError)
    with pytest.raises(errors.BorderTpuError, match="pool died"):
        raise errors.EnvironmentError_("pool died")


@pytest.mark.parametrize("gamma", [0.99, 0.5, 1.0])
@pytest.mark.parametrize("dtype", [np.bool_, np.float32])
def test_gamma_not_done_matches_jax(gamma, dtype):
    term = (np.random.default_rng(0).random(64) < 0.3).astype(dtype)
    want = np.asarray(jax_gamma_not_done(gamma, jnp.asarray(term)))
    got = gamma_not_done(gamma, torch.from_numpy(term))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_buffer_size_attr_matches_jax():
    port = FrameReplayBuffer(capacity=8, num_envs=2, device="cpu")
    assert port.size_attr == JFrameReplayBuffer(capacity=8, num_envs=2).size_attr
    assert isinstance(getattr(port.init(), port.size_attr), int)
