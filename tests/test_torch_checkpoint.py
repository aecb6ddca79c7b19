"""Checkpoints and exact resume of the port's Trainer, on the CPU.

- ``CheckpointManager`` round trip: every tensor, counter and generator
  state comes back bitwise; ``max_to_keep``; a half-written save is not a
  checkpoint.
- Train 4 update chunks ≡ train 2, checkpoint, resume 2: parameters,
  optimizer state, replay state (ring, tree, ``total``), env state, both
  generators and the counters are bitwise equal, for uniform and for
  prioritized replay.  Tolerance zero: the same float32 operations run in
  the same order.
- The cadence matrix of ``tests/test_cadences.py`` for the port's trainer,
  and ``_reconcile_next_cadence`` against the JAX function.
"""

import os

import numpy as np
import pytest
import torch

from border_tpu.train.trainer import _reconcile_next_cadence as jax_reconcile
from border_tpu_torch.agents import DQN, DQNConfig
from border_tpu_torch.envs import make
from border_tpu_torch.models import AtariCNN
from border_tpu_torch.record import BufferedRecorder
from border_tpu_torch.replay import FrameReplayBuffer, PerConfig
from border_tpu_torch.train import Evaluator, Trainer, TrainerConfig
from border_tpu_torch.train.trainer import _reconcile_next_cadence
from border_tpu_torch.utils import CheckpointManager
from border_tpu_torch.utils.checkpoint import pack_state

N, K, B, CAP = 8, 8, 16, 32
UPC = 4  # updates per chunk: K·N / opt_interval


def _trainer(per, max_opts, recorder=None, manager=None, evaluate=True, **cfg):
    agent = DQN(DQNConfig(model=lambda n: AtariCNN(n, dtype=torch.float32),
                          lr=1e-4, double_dqn=True, soft_update_interval=3,
                          tau=1.0, eps_final_step=500))
    buf = FrameReplayBuffer(CAP, N, per=PerConfig(n_opts_final=20) if per else None,
                            device="cpu")
    config = TrainerConfig(
        num_envs=N, steps_per_chunk=K, batch_size=B, opt_interval=K * N // UPC,
        warmup_period=0, max_opts=max_opts, eval_interval=UPC, seed=5,
        **cfg)
    ev = (Evaluator(make("Pong-v0", train=False), n_episodes=2, max_steps=4,
                    device="cpu") if evaluate else None)
    return Trainer(make("Pong-v0"), agent, buf, config, recorder=recorder,
                   evaluator=ev, checkpoint_manager=manager,
                   checkpoint_interval=UPC if manager else 0, device="cpu")


def _record_eval_indices(trainer):
    """The ``eval_index`` of every evaluation ``trainer`` makes from now."""
    seen, evaluate = [], trainer.evaluator.evaluate

    def recording(agent, agent_state, eval_index=0):
        seen.append(eval_index)
        return evaluate(agent, agent_state, eval_index=eval_index)

    trainer.evaluator.evaluate = recording
    return seen


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a packed state."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_states_equal(a, b):
    la, lb = dict(_leaves(pack_state(a))), dict(_leaves(pack_state(b)))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        if torch.is_tensor(x):
            assert torch.equal(x, lb[k]), k
        else:
            assert x == lb[k], k


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_save_restore_round_trip_is_bitwise(per, tmp_path):
    tr = _trainer(per, max_opts=UPC, evaluate=False)
    r = tr.train()
    vec = tr.vec.reset(11)
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen), torch.rand(3, generator=vec.gen)
    extra = {"env_steps": 128, "best_score": -float("inf"), "next_save": -1}
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    mgr.save(7, r.agent_state, r.buffer_state, vec, key=gen, extra=extra)
    assert mgr.latest_step() == 7 and mgr.all_steps() == [7]
    assert os.path.isfile(tmp_path / "7" / "state.pt")

    # fresh templates from another seed: every value differs before
    t2 = _trainer(per, max_opts=UPC, evaluate=False)
    agent2, vec2, buf2 = t2.init_states(99, 100)
    gen2 = torch.Generator().manual_seed(4)
    out = CheckpointManager(str(tmp_path), device="cpu").restore(
        agent2, buf2, vec2, key=gen2, extra={"next_cost": 9})
    _assert_states_equal(out["agent_state"], r.agent_state)
    _assert_states_equal(out["buffer_state"], r.buffer_state)
    _assert_states_equal(out["vec_state"], vec)
    assert out["agent_state"].n_opts == UPC and out["buffer_state"].total == 2 * K
    assert (out["buffer_state"].tree is not None) == per
    # optimizer moments came back, and the restored optimizer steps on
    assert len(out["agent_state"].opt_state.state_dict()["state"]) == 10
    # both generators go on where the saved ones stood
    assert out["key"] is gen2
    assert torch.equal(torch.rand(4, generator=gen2), torch.rand(4, generator=gen))
    assert torch.equal(torch.rand(4, generator=out["vec_state"].gen),
                       torch.rand(4, generator=vec.gen))
    assert out["extra"] == {**extra, "next_cost": 9}


def test_max_to_keep_and_half_written_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, device="cpu")
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(2)})
    for step in (4, 8, 12, 16):
        mgr.save(step, {"w": torch.full((2,), float(step))}, extra={"s": step})
    assert mgr.all_steps() == [12, 16] and mgr.latest_step() == 16
    assert sorted(os.listdir(tmp_path)) == ["12", "16"]
    # a save killed before its rename leaves only the temporary name
    os.makedirs(tmp_path / "20")
    (tmp_path / "20" / "state.pt.tmp").write_bytes(b"half")
    assert mgr.latest_step() == 16
    out = mgr.restore({"w": torch.zeros(2)})
    assert out["agent_state"]["w"].tolist() == [16.0, 16.0]
    assert mgr.restore({"w": torch.zeros(2)}, step=12)["extra"] == {"s": 12}
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"w": torch.zeros(3)})
    mgr.close()


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_resumed_run_equals_uninterrupted_run_bitwise(per, tmp_path):
    whole = _trainer(per, max_opts=4 * UPC)
    whole_indices = _record_eval_indices(whole)
    want = whole.train()
    assert want.opt_steps == 4 * UPC and want.env_steps == 5 * K * N

    mgr = CheckpointManager(str(tmp_path), device="cpu")
    first = _trainer(per, max_opts=2 * UPC, manager=mgr).train()
    assert first.opt_steps == 2 * UPC and mgr.all_steps() == [UPC, 2 * UPC]

    rest = _trainer(per, max_opts=4 * UPC)
    rest_indices = _record_eval_indices(rest)
    got = rest.train(resume_from=mgr)
    # each evaluation is seeded by its number since step 0, resumed or not
    assert whole_indices == [0, 1, 2, 3] and rest_indices == [2, 3]
    assert got.opt_steps == want.opt_steps and got.env_steps == want.env_steps
    _assert_states_equal(got.agent_state, want.agent_state)
    _assert_states_equal(got.buffer_state, want.buffer_state)
    assert got.buffer_state.total == 5 * K
    assert got.best_score == want.best_score
    # only the evaluations after the resume, and the same scores
    assert got.eval_history == want.eval_history[2:]
    # the rates count this call's work only
    assert got.samples_per_sec * got.duration_sec == pytest.approx(2 * K * N)
    assert got.opt_per_sec * got.duration_sec == pytest.approx(2 * UPC)
    if per:
        assert torch.isfinite(got.buffer_state.tree.sum_tree[1])
        assert got.buffer_state.tree.sum_tree[1] > 0


def test_resume_restores_env_state_and_generators(tmp_path):
    """Checkpoint after every chunk; restoring the LAST one into a fresh
    trainer gives the env state and generator states the run ended with
    (they are not in ``TrainResult``, so they are read from a checkpoint
    written at the same step by an uninterrupted run)."""
    m1, m2 = (CheckpointManager(str(tmp_path / d), max_to_keep=1, device="cpu")
              for d in ("a", "b"))
    _trainer(True, max_opts=3 * UPC, manager=m1).train()
    _trainer(True, max_opts=UPC, manager=m2).train()
    _trainer(True, max_opts=3 * UPC, manager=m2).train(resume_from=m2)
    assert m1.all_steps() == m2.all_steps() == [3 * UPC]
    a = torch.load(m1._path(3 * UPC), weights_only=True)
    b = torch.load(m2._path(3 * UPC), weights_only=True)
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    assert {"/key", "/vec_state/gen", "/vec_state/obs",
            "/buffer_state/tree/sum_tree", "/extra/next_ckpt"} <= la.keys()
    for k, x in la.items():
        assert torch.equal(x, lb[k]) if torch.is_tensor(x) else x == lb[k], k


def test_cadence_matrix(tmp_path):
    """≙ tests/test_cadences.py::test_cadence_matrix for the port: periodic
    model saves land in model_dir at save_interval, param/ stats records
    appear at record_agent_info_interval, evaluations run at eval_interval
    and the best model is saved."""
    rec = BufferedRecorder(model_dir=str(tmp_path / "m"))
    calls = []
    tr = _trainer(False, max_opts=3 * UPC, recorder=rec, save_interval=UPC,
                  record_agent_info_interval=UPC, flush_record_interval=UPC)
    tr.eval_callback = lambda *a: calls.append(a)
    res = tr.train()
    assert res.opt_steps >= 3 * UPC

    saves = sorted(int(d) for d in os.listdir(rec.model_dir) if d.isdigit())
    assert saves == [UPC, 2 * UPC, 3 * UPC]
    # each loadable into a fresh state, bitwise (float32 parameters)
    fresh = tr.agent.init(123, tr.vec.observation_space, tr.vec.action_space,
                          device="cpu")
    loaded = rec.load_model(str(saves[-1]), tr.agent, fresh)
    _assert_states_equal(loaded, res.agent_state)
    assert os.path.isfile(tmp_path / "m" / str(saves[-1]) / "dqn.npz")

    keys = {k for r in rec.records for k, _ in r}
    assert any(k.startswith("param/") for k in keys), sorted(keys)[:20]
    assert {"Episode return", "Episodes truncated", "opt_steps"} <= keys

    assert [s for s, _ in res.eval_history] == saves
    assert os.path.isfile(tmp_path / "m" / "best" / "dqn.npz")
    assert res.best_score == max(s for _, s in res.eval_history)
    assert [(c[0], c[2]) for c in calls] == res.eval_history
    assert calls[-1][1] == res.env_steps and calls[-1][3] == res.best_score


def test_bf16_state_is_saved_as_float32_and_cast_back(tmp_path):
    agent = DQN(DQNConfig(model=AtariCNN))
    env = make("Pong-v0")
    spaces_ = env.observation_space(None), env.action_space(None)
    st = agent.init(0, *spaces_, device="cpu")
    st.params.to(torch.bfloat16)
    st.n_opts, st.n_samples = 42, 4242
    rec = BufferedRecorder(model_dir=str(tmp_path))
    rec.save_model("x", agent, st)
    with np.load(tmp_path / "x" / "dqn.npz") as z:
        assert z["params/conv0.weight"].dtype == np.float32
        assert int(z["n_opts"]) == 42
    st2 = agent.init(1, *spaces_, device="cpu")
    st2.params.to(torch.bfloat16)
    st2 = rec.load_model("x", agent, st2)
    assert st2.params.conv0.weight.dtype == torch.bfloat16
    _assert_states_equal(st2, st)
    assert (st2.n_opts, st2.n_samples) == (42, 4242)
    with pytest.raises(ValueError, match="no model_dir"):
        BufferedRecorder().save_model("x", agent, st)


@pytest.mark.parametrize(
    "stored, interval, opt_steps",
    [(16, 0, 20), (-1, 8, 20), (16, 8, 12), (8, 8, 100), (24, 8, 24)],
)
def test_reconcile_next_cadence_matches_jax(stored, interval, opt_steps):
    want = jax_reconcile(stored, interval, opt_steps)
    assert _reconcile_next_cadence(stored, interval, opt_steps) == want


# -- the flat buffer and IQN: their states pack, restore and resume ----------

def _flat_trainer(kind, max_opts, manager=None):
    """CartPole on the flat buffer: DQN + n-step 3, DQN + PER, or IQN."""
    from border_tpu_torch.agents import IQN, IQNConfig
    from border_tpu_torch.replay import ReplayBuffer

    if kind == "iqn":
        agent = IQN(IQNConfig(feature_dim=16, n_cos=8, hidden=(16,), lr=5e-4,
                              soft_update_interval=3, tau=1.0,
                              eps_final_step=500))
        buf = ReplayBuffer(256, device="cpu")
    else:
        agent = DQN(DQNConfig(hidden=(16, 16), lr=5e-4, double_dqn=True,
                              soft_update_interval=3, tau=1.0,
                              eps_final_step=500))
        buf = (ReplayBuffer(256, per=PerConfig(n_opts_final=20), device="cpu")
               if kind == "per" else
               ReplayBuffer(256, n_step=3, stride=N, device="cpu"))
    config = TrainerConfig(
        num_envs=N, steps_per_chunk=K, batch_size=B, opt_interval=K * N // UPC,
        warmup_period=0, max_opts=max_opts, eval_interval=UPC, seed=5)
    ev = Evaluator(make("CartPole-v1"), n_episodes=3, max_steps=30, device="cpu")
    return Trainer(make("CartPole-v1"), agent, buf, config, evaluator=ev,
                   checkpoint_manager=manager,
                   checkpoint_interval=UPC if manager else 0, device="cpu")


@pytest.mark.parametrize("kind", ["nstep", "per", "iqn"])
def test_resumed_cartpole_run_equals_uninterrupted_run_bitwise(kind, tmp_path):
    """5 update chunks ≡ 2, checkpoint, resume 3, on the flat buffer (the
    ring wraps: 6 chunks push 384 transitions into 256 slots)."""
    want = _flat_trainer(kind, max_opts=5 * UPC).train()
    assert want.opt_steps == 5 * UPC and want.buffer_state.size == 256
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    _flat_trainer(kind, max_opts=2 * UPC, manager=mgr).train()
    assert mgr.all_steps() == [UPC, 2 * UPC]
    got = _flat_trainer(kind, max_opts=5 * UPC).train(resume_from=mgr)
    _assert_states_equal(got.agent_state, want.agent_state)
    _assert_states_equal(got.buffer_state, want.buffer_state)
    assert got.buffer_state.cursor == want.buffer_state.cursor == (6 * K * N) % 256
    assert got.eval_history == want.eval_history[2:]
    assert type(got.agent_state).__name__ == (
        "IQNState" if kind == "iqn" else "DQNState")
    if kind == "per":
        assert got.buffer_state.tree.sum_tree[1] > 0
