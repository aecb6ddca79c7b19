"""The port's SAC and its Pendulum against the benchmark's plain reference
(``portbench/reference/kinds/sac.py``, ``portbench/reference/games/
Pendulum-v1.py``), which imports nothing of the port.

The same seeded weights go into ``SAC.update`` (through the benchmark's
``agents/sac.py::load``) and into the reference's learner, the same batch
and the same two normal draws (injected as ``noise``) into both, float32:
the three losses, every gradient as its Adam got it (the first moment
after one step over 1 − β1), the parameters after two updates and the
soft-updated targets agree.  The env: every observation, reward and flag
of 250 steps (episodes truncated at 200 and reset) bit for bit.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench import weights
from portbench.agents import sac as bench_sac
from portbench.reference import kinds
from portbench.reference.games import find as find_env
from portbench.reference.games import select

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "sac-pendulum.json").read_text())
B = 32
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside other test processes on the same cores, more intra-op
    threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(hidden):
    cfg = copy.deepcopy(CFG)
    cfg["agent"].update(actor_hidden=list(hidden), critic_hidden=list(hidden))
    return cfg


def _program(cfg, w0):
    from border_tpu_torch.envs import make

    env = make(cfg["env"])
    params = env.default_params
    agent = bench_sac.build(cfg)
    state = agent.init(0, env.observation_space(params), env.action_space(params),
                       device="cpu")
    bench_sac.load(cfg, state, w0)
    return agent, state


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    th = (torch.rand((B, 2), generator=g) * 2 - 1) * torch.tensor([3.14, 8.0])
    nxt = th + 0.05 * torch.randn((B, 2), generator=g)

    def obs(x):
        return torch.stack([x[:, 0].cos(), x[:, 0].sin(), x[:, 1]], dim=1)

    return {"obs": obs(th), "next_obs": obs(nxt),
            "act": torch.rand((B, 1), generator=g) * 4 - 2,
            "reward": -torch.rand((B,), generator=g) * 16,
            "terminated": torch.rand((B,), generator=g) < 0.25,
            "truncated": torch.zeros((B,), dtype=torch.bool),
            "z_next": torch.randn((B, 1), generator=g),
            "z_actor": torch.randn((B, 1), generator=g)}


def _close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].detach(), want[k].detach(), msg=k, **(tol or TOL))


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256)])
def test_sac_update_matches_the_plain_reference(hidden):
    from border_tpu_torch.replay import TransitionBatch

    cfg = _cfg(hidden)
    kind = kinds.find(cfg)
    w0 = weights.make(kind.shapes(cfg), 2**31 + 7, "cpu")
    agent, state = _program(cfg, w0)
    lrn = kind.learner(w0, cfg)
    identity = lambda x: x  # noqa: E731
    for k in range(2):
        b = _batch(k)
        batch = TransitionBatch(**{f: b[f] for f in ("obs", "act", "next_obs", "reward",
                                                     "terminated", "truncated")})
        state, metrics, _ = agent.update(state, batch, noise=(b["z_next"], b["z_actor"]))
        losses, grads = kind.update(lrn, b, cfg, identity)
        torch.testing.assert_close(
            torch.stack(bench_sac.losses(metrics)), torch.tensor(losses), rtol=1e-5, atol=1e-7)
        if k == 0:
            _close(bench_sac.first_grads(state), grads, rtol=1e-4, atol=1e-6)
    _close(bench_sac.params(state), lrn["params"])
    targets = bench_sac.critics(state.critic_target_params)
    _close(targets, lrn["target"])
    # the targets moved by two soft updates, not to the critics
    assert all(not torch.equal(targets[k], w0[k]) for k in targets if k.endswith("weight"))


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_pendulum_steps_as_the_plain_reference_bit_for_bit(seed):
    from border_tpu_torch.core.env import VecEnv
    from border_tpu_torch.envs import make

    n, steps = 16, 250
    vec = VecEnv(make("Pendulum-v1"), n, device="cpu")
    st = vec.reset(seed)
    ref = find_env("Pendulum-v1")()
    gen = torch.Generator().manual_seed(seed)
    rs = ref.reset(gen, n, "cpu")
    acts = torch.Generator().manual_seed(seed + 1)
    ends = 0
    for t in range(steps):
        a = torch.rand((n, 1), generator=acts) * 5 - 2.5  # past the torque bounds too
        assert torch.equal(st.obs, ref.obs(rs)), t
        ts, st = vec.step(st, a)
        nxt, r, term, trunc = ref.step(rs, a)
        assert torch.equal(ts.final_obs, ref.obs(nxt)), t
        assert torch.equal(ts.reward, r) and torch.equal(ts.terminated, term), t
        assert torch.equal(ts.truncated, trunc), t
        ends += int(trunc.sum())
        rs = select(term | trunc, ref.reset(gen, n, "cpu"), nxt)
    assert ends == n  # every episode was cut at step 200 and reset
