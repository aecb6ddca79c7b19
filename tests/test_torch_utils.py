"""The port's utilities against the JAX package's: profiling, the build
cache, policy export, and ``convert.load_jax_policy``.

- ``export_policy`` of parameters carried over from the JAX side writes the
  JAX package's artifact: the same ``policy.npz`` keys and arrays, bitwise
  (a transpose and a permutation are exact), and the same ``policy.json``;
  either package's ``NumpyMLPPolicy`` reads either artifact to the same
  actions, and the port's float32 ``select_action_eval`` gives the numpy
  policy's action (discrete: wherever the top-2 margin of the numpy
  policy's values exceeds 1e-4 of their scale; continuous: to 1e-5);
- the committed JAX-trained Pong model through ``load_jax_policy`` and
  through the JAX package's ``Agent.load``: float32 Q-values on 64
  observations of a Pong rollout agree to rtol 1e-4 / atol 1e-5, and the
  greedy actions are equal wherever JAX's top-2 margin exceeds 1e-4; at
  both packages' bf16 default the Q-values agree to 0.05 absolute.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from border_tpu.agents import (AWAC as JAWAC, AWACConfig as JAWACConfig,
                               BC as JBC, BCConfig as JBCConfig,
                               DQN as JDQN, DQNConfig as JDQNConfig,
                               IQL as JIQL, IQLConfig as JIQLConfig,
                               IQN as JIQN, IQNConfig as JIQNConfig,
                               SAC as JSAC, SACConfig as JSACConfig)
from border_tpu.core import spaces as jspaces
from border_tpu.core.env import VecEnv as JVecEnv
from border_tpu.envs import make as jmake
from border_tpu.models import AtariCNN as JAtariCNN
from border_tpu.utils import NumpyMLPPolicy as JNumpyMLPPolicy
from border_tpu.utils import export_policy as jexport_policy
from border_tpu_torch import convert
from border_tpu_torch.agents import (AWAC, AWACConfig, BC, BCConfig, DQN,
                                     DQNConfig, IQL, IQLConfig, IQN, IQNConfig,
                                     SAC, SACConfig)
from border_tpu_torch.core import spaces
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.ops import _build
from border_tpu_torch.utils import (NumpyMLPPolicy, enable_compilation_cache,
                                    export_policy, profile_trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PONG_MODEL = os.path.join(ROOT, "artifacts", "pong_model", "best")
MARGIN = 1e-4


# -- profiling, build cache ----------------------------------------------------

def test_profile_trace_writes_a_trace_and_is_a_noop_without_dir(tmp_path):
    with profile_trace(""):
        torch.ones(4).sum()
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (f,) = (tmp_path / "trace").iterdir()
    names = {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_build_cache_follows_the_cache_dir_variable(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    monkeypatch.delenv("BORDER_TPU_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == str(default)  # changes nothing
    assert _build.BUILD_DIR == default
    monkeypatch.setenv("BORDER_TPU_CACHE_DIR", str(tmp_path))
    path = enable_compilation_cache()
    assert path == str(tmp_path / "border_tpu_torch" / "_build")
    assert os.path.isdir(path)
    for name in ("frame_gather", "envpool"):
        assert _build.library_path(name).parent == tmp_path / "border_tpu_torch" / "_build"


# -- export ---------------------------------------------------------------------

OBS = 4
PIX = (84, 84, 4)


def _spaces(kind):
    if kind == "pixel":
        return (jspaces.Box(0, 255, PIX, jnp.uint8), jspaces.Discrete(6),
                spaces.Box(0, 255, PIX, torch.uint8), spaces.Discrete(6))
    obs = (jspaces.Box(-1.0, 1.0, (OBS,), jnp.float32),
           spaces.Box(-1.0, 1.0, (OBS,), torch.float32))
    if kind == "discrete":
        return obs[0], jspaces.Discrete(3), obs[1], spaces.Discrete(3)
    low, high = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0], np.float32)
    return (obs[0], jspaces.Box(low, high, (2,), jnp.float32),
            obs[1], spaces.Box(low, high, (2,), torch.float32))


def _agents(name):
    """(JAX agent, port agent, spaces kind, state converter), float32."""
    jcnn = functools.partial(JAtariCNN, dtype=jnp.float32)
    tcnn = functools.partial(AtariCNN, dtype=torch.float32)
    return {
        "dqn_mlp": (JDQN(JDQNConfig(hidden=(16, 16))),
                    DQN(DQNConfig(hidden=(16, 16))), "discrete", convert.dqn_state),
        "dqn_cnn": (JDQN(JDQNConfig(model=lambda n: jcnn(out_dim=n))),
                    DQN(DQNConfig(model=lambda n: tcnn(out_dim=n))), "pixel",
                    convert.dqn_state),
        "iqn_mlp": (JIQN(JIQNConfig(hidden=(16,), feature_dim=16, n_cos=8)),
                    IQN(IQNConfig(hidden=(16,), feature_dim=16, n_cos=8)),
                    "discrete", convert.iqn_state),
        "iqn_cnn": (JIQN(JIQNConfig(psi_fn=functools.partial(
                        jcnn, out_dim=0, skip_linear=True), feature_dim=64,
                        n_cos=16, hidden=(32,))),
                    IQN(IQNConfig(psi_fn=functools.partial(
                        tcnn, out_dim=0, skip_linear=True), feature_dim=64,
                        n_cos=16, hidden=(32,))), "pixel", convert.iqn_state),
        "sac": (JSAC(JSACConfig(actor_hidden=(16,), critic_hidden=(8,))),
                SAC(SACConfig(actor_hidden=(16,), critic_hidden=(8,))),
                "continuous", convert.sac_state),
        "awac": (JAWAC(JAWACConfig(actor_hidden=(16,), critic_hidden=(8,))),
                 AWAC(AWACConfig(actor_hidden=(16,), critic_hidden=(8,))),
                 "continuous", convert.awac_state),
        "iql": (JIQL(JIQLConfig(actor_hidden=(16,), critic_hidden=(8,),
                                value_hidden=(8,))),
                IQL(IQLConfig(actor_hidden=(16,), critic_hidden=(8,),
                              value_hidden=(8,))),
                "continuous", convert.iql_state),
        "bc": (JBC(JBCConfig(hidden=(16, 16))), BC(BCConfig(hidden=(16, 16))),
               "continuous", convert.bc_state),
        "bc_discrete": (JBC(JBCConfig(hidden=(16,), action_mode="discrete")),
                        BC(BCConfig(hidden=(16,), action_mode="discrete")),
                        "discrete", convert.bc_state),
    }[name]


def _obs(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "pixel":
        return rng.integers(0, 256, (n, *PIX), dtype=np.uint8)
    return rng.normal(size=(n, OBS)).astype(np.float32)


def _values(pol, obs):
    """The numpy policy's per-action values (for the tie margin)."""
    m = pol.meta
    if m["kind"] == "iqn_argmax":
        return pol._iqn_q(np.asarray(obs, np.float32))
    x = np.asarray(obs, np.float32)
    if m["kind"] == "cnn_argmax":
        x = pol._cnn(x, "", m["conv_strides"], m["scale"])
    return pol._dense_stack(x, pol.layers)


@pytest.mark.parametrize("name", ["dqn_mlp", "dqn_cnn", "iqn_mlp", "iqn_cnn",
                                  "sac", "awac", "iql", "bc", "bc_discrete"])
def test_export_is_the_jax_artifact_and_acts_like_the_port(name, tmp_path):
    jagent, tagent, kind, to_port = _agents(name)
    jos, jas, tos, tas = _spaces(kind)
    jst = jagent.init(jax.random.PRNGKey(0), jos, jas)
    tst = to_port(tagent, jst, tos, tas, device="cpu")
    jdir = jexport_policy(jagent, jst, str(tmp_path / "jax"))
    tdir = export_policy(tagent, tst, str(tmp_path / "port"))

    with np.load(os.path.join(jdir, "policy.npz")) as j, \
            np.load(os.path.join(tdir, "policy.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype == np.float32, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    with open(os.path.join(jdir, "policy.json")) as fj, \
            open(os.path.join(tdir, "policy.json")) as ft:
        assert json.load(ft) == json.load(fj)

    obs = _obs(kind, 16, 1)
    pols = [NumpyMLPPolicy(tdir), JNumpyMLPPolicy(tdir),
            NumpyMLPPolicy(jdir), JNumpyMLPPolicy(jdir)]
    acts = [p(obs) for p in pols]
    for a in acts[1:]:
        np.testing.assert_array_equal(a, acts[0])
    np.testing.assert_array_equal(pols[0](obs[0]), acts[0][0])

    got = tagent.select_action_eval(tst, torch.from_numpy(obs)).numpy()
    if kind == "continuous":
        np.testing.assert_allclose(got, acts[0], atol=1e-5)
    else:
        v = np.sort(_values(pols[0], obs), axis=-1)
        clear = v[:, -1] - v[:, -2] > MARGIN * max(np.abs(v).max(), 1.0)
        assert clear.sum() >= len(obs) // 2
        np.testing.assert_array_equal(got[clear], acts[0][clear])


def test_export_refuses_an_unknown_policy_module(tmp_path):
    from border_tpu_torch.models import EnsembleMLP

    class Critic(DQN):
        def policy_params(self, state):
            return EnsembleMLP(2, 4, 1, hidden=(8,))

    agent = Critic(DQNConfig(hidden=(8,)))
    st = agent.init(0, *_spaces("discrete")[2:], device="cpu")
    with pytest.raises(ValueError, match="EnsembleMLP"):
        export_policy(agent, st, str(tmp_path))


# -- the committed JAX-trained Pong policy ---------------------------------------

@pytest.fixture(scope="module")
def pong_obs():
    """64 observations of a greedy Pong rollout of the committed policy
    (8 envs, every 5th step from step 10), on the JAX package's env."""
    env = jmake("Pong-v0", train=False)
    vec = JVecEnv(env, 8)
    agent = JDQN(JDQNConfig(model=lambda n: JAtariCNN(out_dim=n)))
    key = jax.random.PRNGKey(0)
    st = agent.load(agent.init(key, vec.observation_space, vec.action_space),
                    PONG_MODEL)
    step = jax.jit(vec.step)
    act = jax.jit(agent.select_action_eval)
    vs = vec.reset(jax.random.PRNGKey(1))
    out = []
    for t in range(50):
        if t >= 10 and t % 5 == 0:
            out.append(np.asarray(vs.obs))
        _, vs = step(vs, act(st, vs.obs, key))
    return np.concatenate(out)


def _pong_q_both(obs, dtype_jax, dtype_port):
    jagent = JDQN(JDQNConfig(model=lambda n: JAtariCNN(out_dim=n, dtype=dtype_jax)))
    jos, jas = jspaces.Box(0, 255, PIX, jnp.uint8), jspaces.Discrete(6)
    jst = jagent.load(jagent.init(jax.random.PRNGKey(0), jos, jas), PONG_MODEL)
    want = np.asarray(jagent.net.apply(jst.params, jnp.asarray(obs)))
    tagent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=dtype_port)))
    _, _, tos, tas = _spaces("pixel")
    tst = convert.load_jax_policy(tagent, PONG_MODEL, tos, tas, device="cpu")
    assert (tst.n_opts, tst.n_samples) == (int(jst.n_opts), int(jst.n_samples))
    for a, b in zip(tst.params.parameters(), tst.target_params.parameters()):
        assert a.shape == b.shape
    with torch.no_grad():
        got = tst.params(torch.from_numpy(obs)).numpy()
    return got, want, tagent, tst


def test_load_jax_policy_q_values_match_jax_float32(pong_obs):
    assert pong_obs.shape == (64, *PIX)
    got, want, tagent, tst = _pong_q_both(pong_obs, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    s = np.sort(want, axis=-1)
    clear = s[:, -1] - s[:, -2] > MARGIN
    assert clear.sum() >= 48
    acts = tagent.select_action_eval(tst, torch.from_numpy(pong_obs)).numpy()
    np.testing.assert_array_equal(acts[clear], want.argmax(-1)[clear])


def test_load_jax_policy_q_values_match_jax_bf16(pong_obs):
    """Both packages' default: bf16 compute, float32 parameters."""
    got, want, _, _ = _pong_q_both(pong_obs, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


def test_load_jax_policy_refuses_what_it_does_not_know(tmp_path):
    _, _, tos, tas = _spaces("pixel")
    with pytest.raises(ValueError, match="no JAX layout"):
        convert.load_jax_policy(SAC(), PONG_MODEL, tos, tas, device="cpu")
    # the Pong model into an MLP: the saved params lack the MLP's layout
    with pytest.raises(ValueError, match="Dense_2|holds|shape"):
        convert.load_jax_policy(DQN(DQNConfig(hidden=(64, 64))), PONG_MODEL,
                                spaces.Box(0, 255, (28224,), torch.uint8), tas,
                                device="cpu")
    # a saved state of another class
    text = open(os.path.join(PONG_MODEL, "dqn.treedef.txt")).read()
    os.makedirs(tmp_path / "iqn")
    (tmp_path / "iqn" / "iqn.treedef.txt").write_text(text)
    with pytest.raises(ValueError, match="IQNState"):
        convert.load_jax_policy(IQN(), str(tmp_path / "iqn"), tos, tas,
                                device="cpu")
    # a leaf count that is not the archive's
    (tmp_path / "short").mkdir()
    (tmp_path / "short" / "dqn.treedef.txt").write_text(text)
    with np.load(os.path.join(PONG_MODEL, "dqn.npz")) as d:
        np.savez(tmp_path / "short" / "dqn.npz",
                 *[d[f"arr_{i}"] for i in range(42)])
    with pytest.raises(ValueError, match="42 arrays for 43 leaves"):
        convert.load_jax_policy(DQN(DQNConfig(model=AtariCNN)),
                                str(tmp_path / "short"), tos, tas, device="cpu")


def test_load_jax_policy_carries_a_jax_saved_iqn(tmp_path):
    """IQN with an MLP ψ: saved by the JAX package, loaded here, the same
    quantile values at the acting τ grid."""
    jagent, tagent, kind, _ = _agents("iqn_mlp")
    jos, jas, tos, tas = _spaces(kind)
    jst = jagent.init(jax.random.PRNGKey(3), jos, jas)
    jagent.save(jst, str(tmp_path))
    tst = convert.load_jax_policy(tagent, str(tmp_path), tos, tas, device="cpu")
    obs = _obs(kind, 8, 2)
    taus = (np.arange(32, dtype=np.float32) + 0.5) / 32
    taus = np.broadcast_to(taus, (8, 32)).copy()
    want = np.asarray(jagent.net.apply(jst.params, jnp.asarray(obs),
                                       jnp.asarray(taus)))
    with torch.no_grad():
        got = tst.params(torch.from_numpy(obs), torch.from_numpy(taus)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
