"""The port's C++ host envs (``envs/native.py``) against the JAX package's
binding: the same ``cpp/envpool.cpp``, built by the port with
``cpp/Makefile``'s flags into ``border_tpu_torch/_build/``, stepped with the
same seeds and actions, gives bitwise the same observations, rewards and
flags for every env id; and ``AsyncEnvFeeder`` keeps the order of its
steps."""

import hashlib
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from border_tpu.envs.native import NativeVecEnv as JaxNativeVecEnv
from border_tpu_torch.core import spaces
from border_tpu_torch.envs import native
from border_tpu_torch.envs.native import ENV_IDS, AsyncEnvFeeder, NativeVecEnv
from border_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "cpp" / "libenvpool.so"


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def committed_digest():
    """The committed library's bytes before any test of this file builds."""
    return _digest(COMMITTED)


@pytest.mark.parametrize("name, train", sorted({k for k in ENV_IDS}),
                         ids=lambda v: str(v))
def test_native_env_matches_the_jax_binding_bitwise(name, train, committed_digest):
    n = 8
    ours = NativeVecEnv(name, n, seed=7, train=train)
    ref = JaxNativeVecEnv(name, n, seed=7, train=train)
    try:
        assert ours.obs_shape == ref.obs_shape and ours.obs_dtype == ref.obs_dtype
        assert ours.num_actions == ref.num_actions
        space = ours.observation_space
        assert isinstance(space, spaces.Box) and space.shape == ref.obs_shape
        assert space.dtype == (torch.uint8 if ref.obs_dtype == np.uint8
                               else torch.float32)
        assert ours.action_space == spaces.Discrete(ref.num_actions)
        np.testing.assert_array_equal(ours.reset(), ref.reset())
        rng = np.random.RandomState(0)
        done = 0
        for i in range(320):
            act = rng.randint(0, ours.num_actions, n)
            if i % 2:
                got, want = ours.step_final(act), ref.step_final(act)
                done += int((got[3] | got[4]).sum())
            else:
                got, want = ours.step(act), ref.step(act)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
        # the classic-control ids end episodes well within 320 random steps
        if name in ("CartPole-v1",):
            assert done > 0
    finally:
        ours.close()
        ref.close()
    # the port built its own library and left the committed one alone
    assert Path(native._lib()._name) == _build.library_path("envpool")
    assert _build.library_path("envpool").parent == ROOT / "border_tpu_torch" / "_build"
    assert _digest(COMMITTED) == committed_digest


def test_build_uses_the_makefile_flags():
    text = (ROOT / "cpp" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", text, re.MULTILINE).group(1).split()
    assert re.search(r"\$\(CXX\) \$\(CXXFLAGS\) -shared -o", text)
    assert _build.CXX_FLAGS == (*flags, "-shared")
    assert _build.library_path("envpool").name.startswith("libenvpool-")


def test_step_final_exposes_pre_reset_obs():
    env = NativeVecEnv("CartPole-v1", 32, seed=3)
    env.reset()
    rng = np.random.RandomState(0)
    saw_done = False
    for _ in range(300):
        obs, final_obs, rew, term, trunc = env.step_final(rng.randint(0, 2, size=32))
        done = term | trunc
        if done.any():
            saw_done = True
            assert not np.allclose(obs[done], final_obs[done])
            assert (np.abs(obs[done]) <= 0.05 + 1e-6).all()
        np.testing.assert_array_equal(obs[~done], final_obs[~done])
    assert saw_done
    env.close()
    with pytest.raises(KeyError, match="Seaquest"):
        NativeVecEnv("Seaquest-v0", 2)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CPP_SRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"failed for broken\.cpp:\n.*error"):
        _build.load("broken")
    assert not list((tmp_path / "_build").glob("*.so"))

    def no_compiler(name):
        raise RuntimeError("host C++ compiler 'g++' not found")

    monkeypatch.setattr(_build, "load", no_compiler)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="not found"):
        NativeVecEnv("CartPole-v1", 2)


def test_async_feeder_keeps_order_and_hands_on_errors():
    seen = []
    release = threading.Event()

    class Env:
        def step(self, actions):
            release.wait(timeout=10)
            seen.append(int(actions[0]))
            if actions[0] == 99:
                raise ValueError("env step failed")
            return actions * 2

        def close(self):
            seen.append("closed")

    feeder = AsyncEnvFeeder(Env())
    for i in range(2):  # two in flight: submit never blocks the caller
        feeder.submit(np.array([i]))
    release.set()
    for i in range(2, 40):
        assert feeder.collect()[0] == 2 * (i - 2)
        feeder.submit(np.array([i]))
    feeder.collect()
    feeder.collect()
    feeder.submit(np.array([99]))
    with pytest.raises(ValueError, match="env step failed"):
        feeder.collect()
    feeder.close()
    assert seen == list(range(40)) + [99, "closed"]
    assert not feeder._worker.is_alive()
